"""dsp_audio_project_tpu_torch — the PyTorch/CUDA port of dsp_audio_project_tpu.

The SRC -> EQ -> spectra chain (44.1 -> 48 kHz polyphase SRC, the biquad
EQ cascade, |rfft| spectra of x, y and z) on one NVIDIA Hopper GPU, with
hand-written CUDA kernels for its hot loops (kernels/): the EQ-fused cat
forwards (slice 1), and ``AudioPipeline.__call__`` with the frames and flat
forwards (slice 2).  The JAX package beside it is the reference the port is
tested against; this package imports neither jax nor it.

Public entry points:
    process(x, fs, config)            the full SRC->EQ chain
    resample / equalize               individual stages
    magnitude_spectrum                analysis
    AudioPipeline                     configured pipeline (a torch Module)

Importing the package pins float32 matmuls to full precision (TF32 off,
utils/precision.py).
"""
from .utils.precision import pin_fp32

pin_fp32()

from .config import (  # noqa: E402
    EQConfig,
    KernelConfig,
    PipelineConfig,
    SpectrumConfig,
    SRCConfig,
)
from .models.chain import (  # noqa: E402
    AudioPipeline,
    PipelineOutputs,
    design_tables,
    tables_from_numpy,
)
from .ops.eq import equalize  # noqa: E402
from .ops.spectrum import magnitude_spectrum  # noqa: E402
from .ops.src import resample  # noqa: E402


def process(x, fs, config: PipelineConfig = PipelineConfig(), device=None):
    """One-shot convenience: run the full chain, return (z, fs_out).

    ``device`` as in ``AudioPipeline`` (the card unless "cpu" is asked)."""
    out = AudioPipeline(config, device=device)(x, fs)
    return out.output, out.fs_out


__all__ = [
    "AudioPipeline",
    "EQConfig",
    "KernelConfig",
    "PipelineConfig",
    "PipelineOutputs",
    "SRCConfig",
    "SpectrumConfig",
    "design_tables",
    "equalize",
    "magnitude_spectrum",
    "process",
    "resample",
    "tables_from_numpy",
]
