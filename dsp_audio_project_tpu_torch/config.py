"""Static configuration for the PyTorch/CUDA audio-DSP pipeline.

A copy of the parts of ``dsp_audio_project_tpu/config.py`` that the port
reads: the SRC, EQ and spectrum dataclasses (the reference's hardcoded
knobs, defaults unchanged), ``MeshConfig`` (the device mesh of the
sharded chain and stream, parallel/mesh.py) and the path and precision
flags of ``KernelConfig``.
Pure Python, so the GPU host needs no JAX to import it;
tests/test_torch_design.py holds it equal to the original.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

# Reference band table: modules/dsp_core.py:225-228.
DEFAULT_BAND_CENTERS: Tuple[Tuple[str, float], ...] = (
    ("Sub-Bass", 40.0),
    ("Bass", 150.0),
    ("Low Mids", 1000.0),
    ("High Mids", 3000.0),
    ("Presence", 5000.0),
    ("Brilliance", 10000.0),
)

DEFAULT_BAND_NAMES = tuple(name for name, _ in DEFAULT_BAND_CENTERS)

# Reference slider ranges: app.py:149-159.
SRC_FACTOR_MIN, SRC_FACTOR_MAX = 1, 8
GAIN_DB_MIN, GAIN_DB_MAX = -15, 15


@dataclasses.dataclass(frozen=True)
class SRCConfig:
    """L/M rational sample-rate conversion (reference: dsp_core.py:133-173).

    ``taps_rule_factor`` reproduces the reference's ``num_taps = 40*max(L,M)+1``
    tap-count rule (dsp_core.py:158).
    """

    L: int = 1
    M: int = 1
    taps_rule_factor: int = 40

    def __post_init__(self):
        if self.L < 1 or self.M < 1:
            raise ValueError(f"L and M must be >= 1, got L={self.L} M={self.M}")

    @property
    def bypass(self) -> bool:
        # dsp_core.py:144-145
        return self.L == 1 and self.M == 1

    @property
    def num_taps(self) -> int:
        # dsp_core.py:158, forced odd at dsp_core.py:114
        t = self.taps_rule_factor * max(self.L, self.M) + 1
        return t if t % 2 == 1 else t + 1

    @property
    def cutoff_norm(self) -> float:
        # dsp_core.py:155 — cutoff relative to Nyquist.
        return 1.0 / max(self.L, self.M)

    def output_rate(self, fs: int) -> int:
        # dsp_core.py:172 — int() truncation of the float product, replicated.
        return int(fs * self.L / self.M)

    def output_length(self, n: int) -> int:
        # ceil(max(n*L, T)/M): numpy 'same' convolution returns
        # max(len(signal), len(filter)) samples before decimation.
        if self.bypass:
            return n
        return -(-max(n * self.L, self.num_taps) // self.M)


@dataclasses.dataclass(frozen=True)
class EQConfig:
    """6-band peaking-EQ cascade (reference: dsp_core.py:216-254).

    ``gains_db`` maps band name -> gain in dB; application order is the tuple
    order (the reference applies bands in dict-insertion order,
    dsp_core.py:233).  ``q`` is fixed at 1.0 in the reference
    (alpha = sin(w0)/2, dsp_core.py:188).
    """

    gains_db: Tuple[Tuple[str, float], ...] = tuple(
        (name, 0.0) for name in DEFAULT_BAND_NAMES
    )
    band_centers: Tuple[Tuple[str, float], ...] = DEFAULT_BAND_CENTERS
    q: float = 1.0
    # Reference thresholds (dsp_core.py:222,234,240,249).
    bypass_threshold_db: float = 0.1
    nyquist_safety: float = 0.90
    min_center_hz: float = 10.0

    @staticmethod
    def from_gains(gains: Mapping[str, float] | None = None, **kw) -> "EQConfig":
        g = dict.fromkeys(DEFAULT_BAND_NAMES, 0.0)
        if gains:
            g.update(gains)
        return EQConfig(gains_db=tuple(g.items()), **kw)

    @property
    def bypass(self) -> bool:
        # dsp_core.py:222-223 — flat response if every |gain| < 0.1 dB.
        return all(abs(g) < self.bypass_threshold_db for _, g in self.gains_db)

    def active_bands(self, fs: float) -> Tuple[Tuple[float, float], ...]:
        """(effective_fc, gain_db) for each band that actually filters.

        Encodes the reference's per-band skip (|g| <= 0.1, dsp_core.py:234),
        Nyquist clamp to 0.9*fs/2 (dsp_core.py:240-246) and the 10 Hz floor
        (dsp_core.py:249), in application order.
        """
        centers = dict(self.band_centers)
        ceiling = (fs / 2.0) * self.nyquist_safety
        out = []
        for name, gain in self.gains_db:
            if abs(gain) <= self.bypass_threshold_db:
                continue
            fc = centers.get(name, 1000.0)
            fc = ceiling if fc >= ceiling else fc
            if fc > self.min_center_hz:
                out.append((fc, float(gain)))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    """Windowed magnitude spectrum (reference: dsp_core.py:68-98, app.py:202).

    ``analysis_limit`` caps the samples handed to the spectrum op
    (app.py:202 uses the first 100k samples).
    """

    nfft: int = 2048
    window: str = "hann"  # symmetric Hann, computed as in dsp_core.py:86-87
    analysis_limit: int = 100_000


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh for sharded processing.

    Axes: ``channel`` shards independent audio channels, ``block`` shards the
    time axis into contiguous blocks (overlap-save halos for the FIR, state
    carries for the IIR); ``parallel/mesh.build_mesh`` lays
    ``channel_devices x block_devices`` shards over a device list.
    """

    channel_axis: str = "channel"
    block_axis: str = "block"
    channel_devices: int = 1
    block_devices: int = 1


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Path selection and precision flags of the chain.

    ``fir_path`` / ``iir_path`` ('auto' | 'pallas' | 'jnp', the JAX
    package's names): 'auto' lets ``AudioPipeline.forward`` take the fused
    frames path where it applies; inside the flat forward 'auto' and 'jnp'
    run ``resample`` / ``equalize``, fir_path='pallas' runs the
    experimental flat SRC entry point (E1, on the frames kernel) and
    iir_path='pallas' runs ``ops/eq.equalize_pallas``, the block-IIR CUDA
    kernels E2a and E2b (``csrc/iir_block.cu``).  ``iir_block`` /
    ``iir_unroll``: the flat EQ's block and group length.

    The JAX package uses ``eq_fast`` / ``src_fast`` to pick bf16x3 matmuls
    on the TPU.  The port's CUDA kernels accumulate in plain fp32 FMAs
    whatever the flags say (at least as accurate as bf16x3); the flags are
    kept because the cat path's semantic rule ``src_fast == eq_fast`` (one
    kernel precision serves both folded stages) is part of the public
    contract.  The TPU tiling knobs (``fir_frame_tile``, ``interpret``) have
    no counterpart.
    """

    fir_path: str = "auto"           # 'auto' | 'pallas' | 'jnp'
    iir_path: str = "auto"
    iir_block: int = 8192            # block length of the flat EQ
    iir_unroll: int = 128            # samples per group within a block
    eq_fast: bool = False
    src_fast: bool = False

    def resolve(self, path: str) -> str:
        p = getattr(self, f"{path}_path")
        return "jnp" if p == "auto" else p


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full SRC -> EQ chain configuration (reference cascade: app.py:162-167)."""

    src: SRCConfig = SRCConfig()
    eq: EQConfig = EQConfig()
    spectrum: SpectrumConfig = SpectrumConfig()
    mesh: MeshConfig = MeshConfig()
    kernels: KernelConfig = KernelConfig()
