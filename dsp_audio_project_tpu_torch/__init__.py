"""dsp_audio_project_tpu_torch — the PyTorch/CUDA port of dsp_audio_project_tpu.

The SRC -> EQ -> spectra chain (44.1 -> 48 kHz polyphase SRC, the biquad
EQ cascade, |rfft| spectra of x, y and z) and the analysis ops on one
NVIDIA Hopper GPU, with hand-written CUDA kernels for their hot loops
(kernels/): the EQ-fused cat forwards (slice 1), ``AudioPipeline.__call__``
with the frames and flat forwards (slice 2), the STFT and long-window
spectra (slice 3), the explicit-kernel routes (slice 4), dynamic gains
(slice 5: ``AudioPipeline.forward_{frames,cat}_dynamic*``) and streaming
(slice 6: ``StreamProcessor``, ``ShardedStreamProcessor``,
``StreamState``, ``equalize_stream``) and sharding (slice 7: the
(channel, block) mesh, ``run_sharded``, the multi-process mesh of
``parallel/distributed.py``) and the surfaces (slice 8: ``io/`` with
its native WAV codec, the ``models/graph`` stages, ``cli.py`` and
``app/``).  The JAX
package beside it is the reference the port is tested against; this
package imports neither jax nor it.

Public entry points:
    load_signal / export_wav,
    read_wav / write_wav,
    example_signal                    host-side audio I/O (numpy)
    process(x, fs, config)            the full SRC->EQ chain
    resample / equalize               individual stages
    equalize_stream                   EQ of a chunk with its carry state
    StreamProcessor                   chunked SRC->EQ of one signal
    ShardedStreamProcessor            chunked SRC->EQ of C channels in
                                      super-steps on a mesh
    build_mesh, single_device_mesh    (channel, block) device meshes
    run_sharded,
    build_sharded_pipeline, ShardPlan the chain sharded over a mesh
    StreamState                       a stream's carry, as bytes
    equalize_dynamic[_frames[_ops]],
    build_dynamic_operators           EQ with the gains as an input
    magnitude_spectrum, angular_spectrum, spectrum_db,
    stft, spectrogram, stft_planes    analysis
    AudioPipeline                     configured pipeline (a torch Module)
    Chain, Stage, Resample, Equalize,
    Gain, Clip, Normalize             composable stage graphs
    python -m dsp_audio_project_tpu_torch.cli   the command line

Each runs on the card unless the caller passes ``device="cpu"`` (a tensor
input stays on its own device).

Importing the package pins float32 matmuls to full precision (TF32 off,
utils/precision.py).
"""
from .utils.precision import pin_fp32

pin_fp32()

from .config import (  # noqa: E402
    EQConfig,
    KernelConfig,
    MeshConfig,
    PipelineConfig,
    SpectrumConfig,
    SRCConfig,
)
from .io.signal_io import example_signal, export_wav, load_signal  # noqa: E402
from .io.wavio import read_wav, write_wav  # noqa: E402
from .models.chain import (  # noqa: E402
    AudioPipeline,
    PipelineOutputs,
    design_tables,
    tables_from_numpy,
)
from .models.graph import (  # noqa: E402
    Chain,
    Clip,
    Equalize,
    Gain,
    Normalize,
    Resample,
    Stage,
)
from .ops.eq import equalize, equalize_stream  # noqa: E402
from .ops.eq_dynamic import (  # noqa: E402
    build_dynamic_operators,
    equalize_dynamic,
    equalize_dynamic_frames,
    equalize_dynamic_frames_ops,
)
from .ops.spectrum import (  # noqa: E402
    angular_spectrum,
    magnitude_spectrum,
    spectrogram,
    spectrum_db,
    stft,
    stft_planes,
)
from .ops.src import resample  # noqa: E402
from .parallel import (  # noqa: E402
    ShardPlan,
    build_mesh,
    build_sharded_pipeline,
    run_sharded,
    single_device_mesh,
)
from .streaming import (  # noqa: E402
    ShardedStreamProcessor,
    StreamProcessor,
    StreamState,
)


def process(x, fs, config: PipelineConfig = PipelineConfig(), device=None):
    """One-shot convenience: run the full chain, return (z, fs_out).

    ``device`` as in ``AudioPipeline`` (the card unless "cpu" is asked)."""
    out = AudioPipeline(config, device=device)(x, fs)
    return out.output, out.fs_out


__all__ = [
    "AudioPipeline",
    "Chain",
    "Clip",
    "EQConfig",
    "Equalize",
    "Gain",
    "KernelConfig",
    "MeshConfig",
    "Normalize",
    "PipelineConfig",
    "PipelineOutputs",
    "Resample",
    "SRCConfig",
    "ShardPlan",
    "ShardedStreamProcessor",
    "SpectrumConfig",
    "Stage",
    "StreamProcessor",
    "StreamState",
    "angular_spectrum",
    "build_dynamic_operators",
    "build_mesh",
    "build_sharded_pipeline",
    "design_tables",
    "equalize",
    "equalize_dynamic",
    "equalize_dynamic_frames",
    "equalize_dynamic_frames_ops",
    "equalize_stream",
    "example_signal",
    "export_wav",
    "load_signal",
    "magnitude_spectrum",
    "process",
    "read_wav",
    "resample",
    "run_sharded",
    "single_device_mesh",
    "spectrogram",
    "spectrum_db",
    "stft",
    "stft_planes",
    "tables_from_numpy",
    "write_wav",
]
