"""The pipeline: x --SRC--> y --EQ--> z, plus spectra of x, y and z.

Counterpart of ``dsp_audio_project_tpu/models/chain.py`` with the forwards
public.  ``AudioPipeline.forward`` (``pipe(x, fs)``) is the JAX
``__call__``: it takes the fused frames path where ``frames_supported``
holds and the flat forward otherwise, and returns ``PipelineOutputs``.
The forwards and the kernels they run:

* frames (``forward_frames[_flat|_spectra]``): the frames FIR kernel (K3,
  ``kernels.fir_frames``) emits (F, P) frames; ``ops/eq.equalize_frames``
  runs the EQ on them at unroll P, its readout and clip in K9;
* cat (``forward_cat[_spectra]``): K1 emits the EQ's zero-state output y0
  and the state injections directly (the resampled signal never exists),
  then ``ops/eq.equalize_frames_cat`` solves the states and K9 finishes;
* flat (``forward_flat[_spectra]``): the flat SRC (K6, the frames kernel
  viewed flat), then ``ops/eq.equalize`` at block ``iir_block``;
* ``_forward`` / ``forward_spectra``: ``ops/src.resample`` (the frames
  kernel) or, with fir_path='pallas', E1, then ``equalize`` or, with
  iir_path='pallas', ``ops/eq.equalize_pallas`` (the block-IIR kernels
  E2a and E2b, ``kernels/experiments/iir.py``);
* dynamic gains (``forward_frames_dynamic[_ops]``,
  ``forward_cat_dynamic_ops``): the same frames and cat kernels with the EQ
  tables of ``ops/eq_dynamic`` (``dynamic_eq_operators`` per gain change,
  built on the host or on the device; ``dynamic_cat_tables`` for K1's
  G2), so a new gain vector designs nothing on the host for the chain;
* spectra: ``ops/spectrum.magnitude_spectrum`` on Hann windows of
  ``config.spectrum.nfft`` points: K2 (``kernels/rfft.py``) up to 8192,
  K7 and K8 (``kernels/rfft_two_pass.py``) from 16384 to 1048576.

The compiled forwards ``jit_forward[_frames|_cat|_flat|...]()`` return
the JAX package's ``jax.jit`` callables' counterparts, cached on the
module: ``utils/device.CompiledForward`` over the eager forward of the
same name, one CUDA graph per (input shapes, fs) on the card, replayed
with one host call; on the CPU they run the eager forward.

The forwards mark their stages with ``utils/profiling.trace_stage`` spans
under the JAX package's names: ``src`` and ``eq`` (``_forward``),
``src_frames`` and ``eq_frames``, ``src_eq_cat`` (K1 of both cat
forwards), ``src_flat`` and ``eq_flat``.  A span is host-side only, so a
compiled forward opens them at its warm-up and capture and never at a
replay.

The design tables of the cat and frames paths (the polyphase operator G,
G2 = G @ w_cat, the EQ block operators at block 128*P / unroll P and the
carry weights) are designed on the host in float64 for the input rate a
call brings, and live on the module as float32 buffers;
``tables_from_numpy`` installs tables made elsewhere (the JAX package's, in
the tests) in their place.  The flat paths design their own operators at
their own block and unroll (ops/eq.block_tables).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import PipelineConfig
from ..kernels import fir_frames
from ..kernels.fir_class import (
    cat_operator,
    class_flat_supported,
    frame_grid,
    polyphase_fir,
    polyphase_fir_class_flat,
    polyphase_fir_class_rect_cat,
)
from ..ops.eq import (
    EQ_TABLES,
    _CARRY_ALLPAIRS_MAX,
    _carry_weights,
    eq_cat_weights,
    equalize,
    equalize_frames,
    equalize_frames_cat,
    equalize_pallas,
    frames_weights,
    make_block_operators,
)
from ..ops.eq_dynamic import (
    build_cat_tables_dyn,
    build_dynamic_operators,
    build_dynamic_operators_host,
    equalize_dynamic_cat_ops,
    equalize_dynamic_frames,
    equalize_dynamic_frames_ops,
)
from ..ops.spectrum import (
    magnitude_spectrum,
    spectra_mag_stacked,
    spectrum_rows_needed,
    spectrum_window,
    spectrum_window_frames,
    spectrum_window_rows,
)
from ..ops.src import make_plan, resample, resample_rows
from ..utils.device import CompiledForward, default_device
from ..utils.profiling import trace_stage

GROUPS_PER_BLOCK = 128   # EQ groups (frames) per block: block = 128 * P
HOST_TABLES = ("G", "group_fir", "group_in") + EQ_TABLES


@dataclasses.dataclass(frozen=True)
class PipelineOutputs:
    """Results of one pipeline invocation (tensors on the module's device)."""

    output: torch.Tensor         # z[n] at the output rate
    resampled: torch.Tensor      # y[n], the SRC intermediate
    fs_out: int
    spectra: Optional[Dict[str, Tuple[np.ndarray, torch.Tensor]]] = None


def design_tables(config: PipelineConfig, fs: int) -> dict:
    """The cat and frames paths' host design tables at input rate ``fs``
    (numpy, as designed): G and the EQ block operators they need."""
    plan = make_plan(config.src.L, config.src.M, config.src.taps_rule_factor)
    fs_out = config.src.output_rate(fs)
    bands = config.eq.active_bands(fs_out)
    ops = make_block_operators(
        bands, int(fs_out), config.eq.q, GROUPS_PER_BLOCK * plan.P, plan.P
    )
    return {"G": plan.G,
            **{name: getattr(ops, name) for name in HOST_TABLES[1:]}}


class AudioPipeline(nn.Module):
    """Configured SRC -> EQ -> spectra chain on one device.

    Usage:
        pipe = AudioPipeline(PipelineConfig(src=SRCConfig(L=160, M=147),
                                            eq=EQConfig.from_gains({"Bass": 6})))
        out = pipe(x, 44100, with_spectra=True)   # PipelineOutputs
        z_frames, (mag_x, mag_y, mag_z) = pipe.forward_cat_spectra(x, 44100)

    ``device`` defaults to "cuda" and the constructor raises when no CUDA
    device is visible; pass device="cpu" to run the kernels' plain versions
    on the CPU.  ``x`` is (..., N) float32 (a tensor or an array; it is
    moved to the module's device).
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(), device=None):
        super().__init__()
        if device is None:
            device = default_device("AudioPipeline")
        self.config = config
        self.register_buffer("_anchor", torch.empty(0, device=device),
                             persistent=False)
        self._state_corr: np.ndarray | None = None   # float64 A^block
        self._fs: int | None = None
        self._K: int | None = None
        self._compiled: Dict[str, CompiledForward] = {}

    @property
    def device(self) -> torch.device:
        return self._anchor.device

    def output_rate(self, fs: int) -> int:
        return self.config.src.output_rate(fs)

    def _plan(self):
        src = self.config.src
        return make_plan(src.L, src.M, src.taps_rule_factor)

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).contiguous()

    # ---- the module's call: the JAX package's __call__ -------------------

    def forward(self, x, fs: int, *, with_spectra: bool = False
                ) -> PipelineOutputs:
        """(x, fs) -> PipelineOutputs with flat z and y, as the JAX
        ``AudioPipeline.__call__``.  Takes the fused frames path where
        ``frames_supported`` holds and both kernel paths are 'auto' (on
        either device), else the flat forward ``_forward``.  ``spectra``
        maps "input", "resampled", "output" to (host freqs, |X|)."""
        x = self._input(x)
        fs_out = self.output_rate(fs)
        if self.call_route(x.shape[-1]) == "frames":
            z, y = self.forward_frames_flat(x, fs)
        else:
            z, y = self._forward(x, fs)
        spectra = None
        if with_spectra:
            scfg = self.config.spectrum
            spectra = {
                "input": magnitude_spectrum(x, fs, scfg),
                "resampled": magnitude_spectrum(y, fs_out, scfg),
                "output": magnitude_spectrum(z, fs_out, scfg),
            }
        return PipelineOutputs(output=z, resampled=y, fs_out=fs_out,
                               spectra=spectra)

    def call_route(self, n: int) -> str:
        """The path ``forward`` takes for ``n`` samples: "frames" where
        ``frames_supported`` holds and both kernel paths are 'auto', else
        "flat" (``_forward``)."""
        kc = self.config.kernels
        return ("frames" if kc.fir_path == "auto" and kc.iir_path == "auto"
                and self.frames_supported(n) else "flat")

    # ---- flat forward: resample (or E1) -> equalize ----------------------

    def _forward(self, x, fs: int):
        """(x, fs) -> (z, y) flat: ``_run_src`` then ``_run_eq``."""
        with trace_stage("src"):
            y, fs_out = self._run_src(self._input(x), fs)
        with trace_stage("eq"):
            z = self._run_eq(y, fs_out)
        return z, y

    def _run_src(self, x: torch.Tensor, fs: int):
        cfg = self.config
        if cfg.src.bypass or cfg.kernels.resolve("fir") == "jnp":
            return resample(x, fs, cfg.src)
        y = polyphase_fir(x, self._plan(), cfg.src.output_length(x.shape[-1]))
        return y, cfg.src.output_rate(fs)

    def _run_eq(self, y: torch.Tensor, fs_out: int) -> torch.Tensor:
        cfg = self.config
        kc = cfg.kernels
        path = kc.resolve("iir")
        if path == "jnp":
            return equalize(y, fs_out, cfg.eq, block=kc.iir_block,
                            unroll=kc.iir_unroll, fast=kc.eq_fast)
        if path == "pallas":
            return equalize_pallas(y, fs_out, cfg.eq, block=kc.iir_block,
                                   unroll=kc.iir_unroll)
        raise ValueError(f"unknown iir_path {kc.iir_path!r}; expected "
                         "'auto', 'jnp' or 'pallas'")

    def forward_spectra(self, x, fs: int):
        """Flat full chain: (x, fs) -> (z, y, (mag_x, mag_y, mag_z))."""
        x = self._input(x)
        z, y = self._forward(x, fs)
        return z, y, self._spectra_flat(x, y, z)

    def _spectra_flat(self, x, y, z):
        scfg = self.config.spectrum
        return tuple(spectra_mag_stacked([
            spectrum_window(x, scfg), spectrum_window(y, scfg),
            spectrum_window(z, scfg),
        ]))

    # ---- fused frame-major path ------------------------------------------

    def frames_supported(self, n: int) -> bool:
        """True when the fused frame-major path covers this input (the JAX
        package's envelope: s >= 8 and a signal at least as long as the
        filter at the upsampled rate)."""
        cfg = self.config
        if cfg.src.bypass:
            return False
        return self._plan().s >= 8 and n * cfg.src.L >= cfg.src.num_taps

    def forward_frames(self, x, fs: int):
        """(x, fs) -> (z_frames, y_frames), each (..., F_pad, P).

        z/y flat = frames.reshape(..., -1)[..., :output_length(n)].
        """
        cfg = self.config
        x = self._input(x)
        plan = self._plan()
        n_out = cfg.src.output_length(x.shape[-1])
        fs_out = cfg.src.output_rate(fs)
        tables, G = None, None
        if not cfg.eq.bypass and cfg.eq.active_bands(fs_out):
            tables = self._tables(fs, frame_grid(n_out, plan.P)
                                  // GROUPS_PER_BLOCK)
            G = self.G
        with trace_stage("src_frames"):
            y_frames = fir_frames(x, plan, n_out, pad_frames=True, g=G)
        with trace_stage("eq_frames"):
            z_frames = equalize_frames(y_frames, fs_out, cfg.eq,
                                       groups_per_block=GROUPS_PER_BLOCK,
                                       tables=tables)
        return z_frames, y_frames

    def forward_frames_flat(self, x, fs: int):
        """The frames path with the flat crop: (x, fs) -> (z, y)."""
        x = self._input(x)
        zf, yf = self.forward_frames(x, fs)
        n_out = self.config.src.output_length(x.shape[-1])
        z = zf.reshape(zf.shape[:-2] + (-1,))[..., :n_out]
        y = yf.reshape(yf.shape[:-2] + (-1,))[..., :n_out]
        return z, y

    def forward_frames_spectra(self, x, fs: int):
        """(x, fs) -> (z_frames, y_frames, (mag_x, mag_y, mag_z)); the three
        spectra run as one K2 launch."""
        x = self._input(x)
        zf, yf = self.forward_frames(x, fs)
        n_out = self.config.src.output_length(x.shape[-1])
        scfg = self.config.spectrum
        mx, my, mz = spectra_mag_stacked([
            spectrum_window(x, scfg),
            spectrum_window_frames(yf, n_out, scfg),
            spectrum_window_frames(zf, n_out, scfg),
        ])
        return zf, yf, (mx, my, mz)

    # ---- flat 128-lane path (K6) -----------------------------------------

    def flat_supported(self, n: int) -> bool:
        """True when the flat class-FIR + flat EQ path covers this input."""
        cfg = self.config
        if cfg.src.bypass:
            return False
        return (class_flat_supported(self._plan())
                and n * cfg.src.L >= cfg.src.num_taps)

    def forward_flat(self, x, fs: int):
        """(x, fs) -> (z, y): the flat SRC (K6) then the flat EQ; true
        (unpadded) outputs."""
        cfg = self.config
        x = self._input(x)
        n_out = cfg.src.output_length(x.shape[-1])
        with trace_stage("src_flat"):
            y = polyphase_fir_class_flat(x, self._plan(), n_out,
                                         pad_out=True)[..., :n_out]
        with trace_stage("eq_flat"):
            z = self._run_eq(y, cfg.src.output_rate(fs))
        return z, y

    def forward_flat_spectra(self, x, fs: int):
        """(x, fs) -> (z, y, (mag_x, mag_y, mag_z)) on the flat path."""
        x = self._input(x)
        z, y = self.forward_flat(x, fs)
        return z, y, self._spectra_flat(x, y, z)

    # ---- EQ-fused cat path -----------------------------------------------

    def cat_supported(self, n: int, fs: int) -> bool:
        """True when the EQ-fused cat path covers this (config, input).

        Needs SRC and EQ both active, matching src/eq precision flags (one
        kernel precision serves both folded stages), a signal at least as
        long as the filter at the upsampled rate (n*L >= taps), and an
        active band at the output rate.  The JAX package also requires its
        TPU tiling (``rect_supported``: s >= 8 and the virtual-row
        rectangle); the CUDA kernel has no such limit, so that test is gone.
        """
        cfg = self.config
        if cfg.src.bypass or cfg.eq.bypass:
            return False
        if bool(cfg.kernels.src_fast) != bool(cfg.kernels.eq_fast):
            return False
        if n * cfg.src.L < cfg.src.num_taps:
            return False
        return bool(cfg.eq.active_bands(cfg.src.output_rate(fs)))

    def _cat_pieces(self, x, fs: int):
        """Shared front end: (x, (y0, inj), plan, n_out, fs_out, tables)."""
        cfg = self.config
        x = self._input(x)
        n = x.shape[-1]
        if not self.cat_supported(n, fs):
            raise ValueError(
                f"the cat path does not cover this config/input (n={n}, "
                f"fs={fs}); see cat_supported"
            )
        plan = self._plan()
        n_out = cfg.src.output_length(n)
        fs_out = cfg.src.output_rate(fs)
        tables = self._tables(fs, frame_grid(n_out, plan.P) // GROUPS_PER_BLOCK)
        with trace_stage("src_eq_cat"):
            pair = polyphase_fir_class_rect_cat(x, plan, n_out, None,
                                                g2=self.g2)
        return x, pair, plan, n_out, fs_out, tables

    def forward_cat(self, x, fs: int, *, finish: str = "auto") -> torch.Tensor:
        """(x, fs) -> z_frames (..., F_pad, P) through the EQ-fused chain.

        ``finish`` as in ``ops/eq.equalize_frames_cat`` ('auto' = K9)."""
        cfg = self.config
        _, (y0, inj), plan, _, fs_out, tables = self._cat_pieces(x, fs)
        return equalize_frames_cat(
            y0, inj, fs_out, cfg.eq, unroll=plan.P,
            groups_per_block=GROUPS_PER_BLOCK, tables=tables, finish=finish,
        )

    def forward_cat_spectra(self, x, fs: int, *, finish: str = "auto"):
        """(x, fs) -> (z_frames, (mag_x, mag_y, mag_z)): the full render.

        The y spectrum's ~13 frame rows are recomputed from x
        (resample_rows); the z rows come out of the EQ finish as a side
        tensor.  Frequency axes are host arrays:
        ops.spectrum.spectrum_freqs(n, fs) for x and
        spectrum_freqs(output_length(n), output_rate(fs)) for y and z.
        """
        cfg = self.config
        scfg = cfg.spectrum
        x, (y0, inj), plan, n_out, fs_out, tables = self._cat_pieces(x, fs)
        r0, r1 = spectrum_rows_needed(n_out, plan.P, scfg)
        z, z_rows = equalize_frames_cat(
            y0, inj, fs_out, cfg.eq, unroll=plan.P,
            groups_per_block=GROUPS_PER_BLOCK, rows=(r0, r1), tables=tables,
            finish=finish,
        )
        y_rows = resample_rows(x, plan, r0, r1, self.G)
        mx, my, mz = spectra_mag_stacked([
            spectrum_window(x, scfg),
            spectrum_window_rows(y_rows, r0, n_out, scfg),
            spectrum_window_rows(z_rows, r0, n_out, scfg),
        ])
        return z, (mx, my, mz)

    # ---- dynamic gains: build operators on a gain change, apply per batch

    def dynamic_eq_geometry(self, fs: int, n: int,
                            groups_per_block: int = GROUPS_PER_BLOCK):
        """(unroll, groups_per_block, num_blocks) the dynamic builders use
        for ``n``-sample inputs: unroll P, and K blocks over the frames
        kernel's padded frame count."""
        plan = self._plan()
        f_pad = frame_grid(self.config.src.output_length(n), plan.P)
        return plan.P, groups_per_block, -(-f_pad // groups_per_block)

    def dynamic_eq_operators(self, gains_db, fs: int, n: int,
                             groups_per_block: int = GROUPS_PER_BLOCK,
                             builder: str = "auto"):
        """``DynOperators`` on the module's device for ``n``-sample inputs
        at input rate ``fs``, to pass to ``forward_frames_dynamic_ops`` or
        (with ``dynamic_cat_tables``) ``forward_cat_dynamic_ops``.

        ``builder``: 'host' designs in float64 numpy (gains as host
        values, the serving builder); 'traced' designs on the device from a
        gains tensor, reading nothing back to the host (a gain change a
        CUDA graph can capture); 'auto' takes 'traced' for a tensor and
        'host' for anything else.  Band centers and thresholds come from
        ``config.eq``; its gains are not read.
        """
        if builder == "auto":
            builder = ("traced" if isinstance(gains_db, torch.Tensor)
                       else "host")
        cfg = self.config
        fs_out = cfg.src.output_rate(fs)
        U, G, K = self.dynamic_eq_geometry(fs, n, groups_per_block)
        if builder == "host":
            if isinstance(gains_db, torch.Tensor):
                gains_db = gains_db.detach().cpu().numpy()
            return build_dynamic_operators_host(
                gains_db, fs_out, cfg.eq, U, G, K, device=self.device)
        if builder == "traced":
            return build_dynamic_operators(gains_db, fs_out, cfg.eq, U, G, K,
                                           device=self.device)
        raise ValueError(f"unknown builder {builder!r}; expected 'auto', "
                         "'host' or 'traced'")

    def dynamic_cat_tables(self, dyn_ops):
        """The cat path's table for prebuilt ``DynOperators`` (one device
        product per gain change, ``ops/eq_dynamic.build_cat_tables_dyn``):
        pass it to ``forward_cat_dynamic_ops`` with the same operators."""
        return build_cat_tables_dyn(self._plan(), dyn_ops)

    def forward_frames_dynamic(self, x, gains_db, fs: int):
        """(x, gains_db, fs) -> (z_frames, y_frames), each (..., F_pad, P):
        the frames path with the gains as an input (the device builder on
        every call).  ``gains_db`` (6,), ordered like
        ``config.eq.band_centers``."""
        x = self._input(x)
        y_frames = self._frames_dynamic(x)
        z_frames = equalize_dynamic_frames(
            y_frames, gains_db, self.config.src.output_rate(fs),
            self.config.eq, groups_per_block=GROUPS_PER_BLOCK)
        return z_frames, y_frames

    def forward_frames_dynamic_ops(self, x, ops, fs: int):
        """(x, ops, fs) -> (z_frames, y_frames) with prebuilt operators
        (``dynamic_eq_operators``): the frames kernel, then the EQ apply
        with its readout and clip in K9."""
        x = self._input(x)
        y_frames = self._frames_dynamic(x)
        z_frames = equalize_dynamic_frames_ops(
            y_frames, ops, groups_per_block=ops.pows_g.shape[0])
        return z_frames, y_frames

    def _frames_dynamic(self, x: torch.Tensor) -> torch.Tensor:
        n_out = self.config.src.output_length(x.shape[-1])
        return fir_frames(x, self._plan(), n_out, pad_frames=True)

    def forward_cat_dynamic_ops(self, x, ops, tables, fs: int) -> torch.Tensor:
        """(x, ops, tables, fs) -> z_frames (..., F_pad, P): the cat path
        with prebuilt operators and their ``dynamic_cat_tables``.  K1 emits
        y0 and the injections through ``tables.g2``; the Toeplitz solve, the
        carry and K9 finish.  Needs an active SRC and a signal at least as
        long as the filter at the upsampled rate."""
        cfg = self.config
        x = self._input(x)
        n = x.shape[-1]
        if cfg.src.bypass or n * cfg.src.L < cfg.src.num_taps:
            raise ValueError(f"the cat path does not cover this config/input "
                             f"(n={n}, fs={fs})")
        plan = self._plan()
        y0, inj = polyphase_fir_class_rect_cat(
            x, plan, cfg.src.output_length(n), None, g2=tables.g2)
        return equalize_dynamic_cat_ops(y0, inj, ops)

    # ---- compiled forwards: the JAX package's jit_forward_* ---------------
    #
    # Each returns a CompiledForward over the eager forward of the same
    # name (utils/device.py), cached on the module, so a second call
    # returns the same object and its entries: one CUDA graph per (input
    # shapes, fs), fs static as in the JAX methods' static_argnums.  On
    # the card a call copies its inputs into the entry's static buffers
    # and replays; a capture that fails raises.  Each graph keeps the
    # module's buffers of its capture, so a later rate or shape, which
    # installs new tables, leaves the tables it reads alive.  On the CPU a
    # call runs the eager forward.

    def _jit(self, forward: str) -> CompiledForward:
        fn = self._compiled.get(forward)
        if fn is None:
            fn = self._compiled[forward] = CompiledForward(
                lambda *args: getattr(self, forward)(*args), self.device,
                f"jit {forward}", keep=lambda: tuple(self.buffers()))
        return fn

    def jit_forward(self) -> CompiledForward:
        """Compiled flat (x, fs) -> (z, y): ``_forward`` (the frames kernel,
        or E1 with fir_path='pallas'; ``equalize``, or E2a/E2b with
        iir_path='pallas')."""
        return self._jit("_forward")

    def jit_forward_frames(self) -> CompiledForward:
        """Compiled (x, fs) -> (z_frames, y_frames): ``forward_frames``
        (the frames kernel, the EQ, K9); see ``frames_supported``."""
        return self._jit("forward_frames")

    def jit_forward_frames_spectra(self) -> CompiledForward:
        """Compiled (x, fs) -> (z_f, y_f, (mx, my, mz)):
        ``forward_frames_spectra`` (the frames chain and one K2 launch)."""
        return self._jit("forward_frames_spectra")

    def jit_forward_spectra(self) -> CompiledForward:
        """Compiled flat (x, fs) -> (z, y, (mx, my, mz)):
        ``forward_spectra``."""
        return self._jit("forward_spectra")

    def jit_forward_flat(self) -> CompiledForward:
        """Compiled (x, fs) -> (z, y): ``forward_flat`` (K6, the flat EQ);
        see ``flat_supported``."""
        return self._jit("forward_flat")

    def jit_forward_flat_spectra(self) -> CompiledForward:
        """Compiled (x, fs) -> (z, y, (mx, my, mz)):
        ``forward_flat_spectra``."""
        return self._jit("forward_flat_spectra")

    def jit_forward_cat(self) -> CompiledForward:
        """Compiled (x, fs) -> z_frames: ``forward_cat`` (K1, the state
        solve, K9); see ``cat_supported``."""
        return self._jit("forward_cat")

    def jit_forward_cat_spectra(self) -> CompiledForward:
        """Compiled (x, fs) -> (z_frames, (mx, my, mz)):
        ``forward_cat_spectra``, the serving render (K1, the state solve,
        K9, K2 on x, y and z)."""
        return self._jit("forward_cat_spectra")

    def jit_forward_frames_dynamic(self) -> CompiledForward:
        """Compiled (x, gains_db, fs) -> (z_frames, y_frames):
        ``forward_frames_dynamic``.  The gains go into a static (6,)
        float32 buffer and the device builder runs inside the graph, so
        one capture serves every gain vector (no host design, no sync)."""
        return self._jit("forward_frames_dynamic")

    def jit_forward_frames_dynamic_ops(self) -> CompiledForward:
        """Compiled (x, ops, fs) -> (z_frames, y_frames):
        ``forward_frames_dynamic_ops``.  Each call copies ``ops``
        (``DynOperators``, field by field) into the entry's own buffers."""
        return self._jit("forward_frames_dynamic_ops")

    def jit_forward_cat_dynamic_ops(self) -> CompiledForward:
        """Compiled (x, ops, tables, fs) -> z_frames:
        ``forward_cat_dynamic_ops``.  Each call copies ``ops`` and
        ``tables`` (``dynamic_cat_tables``) into the entry's own buffers."""
        return self._jit("forward_cat_dynamic_ops")

    # ---- design tables as buffers ----------------------------------------

    def _install_tables(self, fs: int, tables: Mapping[str, np.ndarray]):
        """Install host tables for input rate ``fs`` as float32 buffers (see
        ``tables_from_numpy``); G2 and the frames weights are composed
        here, in float64."""
        missing = [k for k in HOST_TABLES if k not in tables]
        if missing:
            raise ValueError(f"missing tables: {missing}")
        host = {k: np.asarray(tables[k]) for k in HOST_TABLES}
        plan = self._plan()
        d = host["state_corr"].shape[0]
        U, G = plan.P, GROUPS_PER_BLOCK
        want = {
            "G": (plan.W, U), "group_fir": (U, U), "group_in": (U, d),
            "group_out": (d, U), "group_pows": (G, d, d),
            "group_toeplitz": (G * d, G * d), "state_corr": (d, d),
        }
        for name, shape in want.items():
            if host[name].shape != shape:
                raise ValueError(f"table {name} has shape "
                                 f"{host[name].shape}, expected {shape}")
        w_cat = eq_cat_weights(types.SimpleNamespace(
            group_fir=host["group_fir"], group_in=host["group_in"]))
        buffers = {"G": host["G"], "g2": cat_operator(host["G"], w_cat),
                   "w_frames": frames_weights(host["group_fir"],
                                              host["group_in"]),
                   **{name: host[name] for name in EQ_TABLES}}
        for name, arr in buffers.items():
            self.register_buffer(
                name, torch.as_tensor(arr, dtype=torch.float32,
                                      device=self.device).contiguous(),
                persistent=False,
            )
        self._state_corr, self._fs, self._K = host["state_corr"], int(fs), None
        if "carry_w" in tables:
            cw = np.asarray(tables["carry_w"], dtype=np.float32)
            K = cw.shape[0] // d
            if cw.shape != (K * d, K * d):
                raise ValueError(f"carry_w has shape {cw.shape}")
            self._set_carry(K, cw)
        return self

    def _set_carry(self, K: int, cw: np.ndarray) -> None:
        self.register_buffer(
            "carry_w", torch.as_tensor(cw, device=self.device),
            persistent=False,
        )
        self._K = K

    def _tables(self, fs: int, K: int) -> dict:
        if self._fs != int(fs):
            self._install_tables(fs, design_tables(self.config, fs))
        out = {name: getattr(self, name) for name in EQ_TABLES + ("w_frames",)}
        if K <= _CARRY_ALLPAIRS_MAX:
            if self._K != K:
                host_ops = types.SimpleNamespace(state_corr=self._state_corr)
                self._set_carry(K, _carry_weights(host_ops, K))
            out["carry_w"] = self.carry_w
        return out


def tables_from_numpy(
    pipe: AudioPipeline, fs: int, tables: Mapping[str, np.ndarray]
) -> AudioPipeline:
    """Install design tables made elsewhere into ``pipe`` for input rate fs.

    ``tables`` maps names to numpy arrays, for instance as the JAX package
    produces them: G (the polyphase plan's operator) and the BlockOperators
    fields group_fir, group_in, group_out, group_pows, group_toeplitz and
    state_corr; optionally carry_w (the carry weights of one block count).
    G2 = G @ [group_fir^T | group_in] and the frames weights
    [group_fir^T | group_in | 0] are composed from them in float64.  They
    serve the cat and frames paths until the input rate changes; shapes are
    checked against the pipeline's config.
    """
    return pipe._install_tables(fs, tables)
