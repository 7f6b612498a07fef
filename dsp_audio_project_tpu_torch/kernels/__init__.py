"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain torch versions.

Each kernel module holds a wrapper (checks, ``torch.empty`` outputs, launch
on the current stream, ``cudaGetLastError`` check, a ``launches`` counter),
the kernel's plain torch version (what the wrapper runs on a CPU tensor, and
what ``chip_smoke.py`` compares the kernel with on the card) and a source
note.  The CUDA sources live in ``../csrc`` and are built with ``nvcc`` at
first use (``_build.py``); nothing here builds or imports CUDA at import.

Every TPU kernel of the JAX package (each function that reaches
``pl.pallas_call``) and its state in the port, in the port's order:

| id | JAX function (file:line) | port status |
|----|--------------------------|-------------|
| K1 | kernels/fir_class.py:731 polyphase_fir_class_rect_cat | ported: fir_class.py + csrc/fir_cat.cu (CUDA, tensor cores: wgmma TF32 with A from registers, 3xTF32 split; mma.sync for strides whose span does not fit) |
| K2 | kernels/rfft.py:125 rfft_pallas_four_step | ported: rfft.py + csrc/rfft_four_step.cu (CUDA, register-radix FFT on csrc/fft_radix.cuh), magnitude and complex forms |
| K3 | kernels/fir_class.py:928 polyphase_fir_class_rect_frames | ported: fir_class.py on the frames kernel, csrc/fir_cat.cu fir_frames_launch (CUDA) |
| K4 | kernels/fir_class.py:1042 polyphase_fir_class_frames | ported: fir_class.py on the frames kernel (CUDA) |
| K5 | kernels/fir_shear.py:167 polyphase_fir_shear_frames | ported: fir_shear.py on the frames kernel (CUDA) |
| K6 | kernels/fir_class.py:312 polyphase_fir_class_flat | ported: fir_class.py on the frames kernel, flat view (CUDA) |
| K7 | kernels/rfft.py:327 rfft_pallas_four_step_tall | ported: rfft_two_pass.rfft_four_step_tall + csrc/rfft_two_pass.cu (CUDA, register-radix FFT: one pass up to N = 32768, two above) |
| K8 | kernels/rfft.py:476 rfft_pallas_two_level | ported: rfft_two_pass.rfft_two_level, the same kernel's two passes (CUDA) |
| K9 | kernels/eq_finish.py:50 eq_finish_pallas | ported: eq_finish.py + csrc/eq_finish.cu (CUDA) |
| E1 | kernels/experiments/fir.py:61 polyphase_fir | ported: fir_class.polyphase_fir on the frames kernel (CUDA) |
| E2a | kernels/experiments/iir.py:100 block_end_states | ported: experiments/iir.py + csrc/iir_block.cu (CUDA, the group-algebra body, END mode; tables and mirror in experiments/iir_group.py); iir_path='pallas' |
| E2b | kernels/experiments/iir.py:134 block_apply | ported: experiments/iir.py + csrc/iir_block.cu (CUDA, the same body, APPLY mode); iir_path='pallas' |
| E3 | kernels/experiments/fir_dma.py:70 polyphase_fir_dma | ported: experiments/fir_dma.py on the frames kernel (CUDA) |
| E4 | kernels/experiments/fir_splitbank.py:103 polyphase_fir_rect_splitbank | ported: experiments/fir_splitbank.py on the frames kernel (CUDA) |
| E5 | kernels/experiments/fir_rowdma.py:89 polyphase_fir_rect_rowdma | ported: experiments/fir_rowdma.py on the frames kernel (CUDA) |
| E6 | kernels/experiments/rfft_butterfly.py:76 rfft_pallas | ported: experiments/rfft_butterfly.py + csrc/rfft_butterfly.cu (CUDA, register-radix FFT on csrc/fft_radix.cuh); K7's kernel above N = 32768 |
| E7 | kernels/experiments/iir_seq.py:127 equalize_seq_flat | ported: experiments/iir_seq.py + csrc/iir_block.cu (CUDA, the same body, SEQ mode: a fixed-window decoupled look-back) |

Kernels that replace no TPU kernel:

| kernel | what it replaces | file |
|--------|------------------|------|
| eq_design | the device gain builder's ~220 float64 torch ops (ops/eq_dynamic.build_dynamic_operators; the JAX package's df32 ops, ops/eq_dynamic.py:228 _dynamic_operators) | eq_design.py + csrc/eq_design.cu (CUDA, two launches: blocks of a pair of powers each design the bands and run the squaring chain on the FP64 tensor cores while zero blocks write the triangles' zeros; a programmatic dependent launch writes the triangles' rows) |
| group_ends, group_solve | the EQ's state solve where the tables hold the carry triangle (the cat, frames, flat and dynamic routes): the dense (B K, G d) @ (G d, G d) product against the block-Toeplitz table, the carry's product against `carry_w` and the entry states' einsum on cuBLAS (the JAX package leaves them to XLA, ops/eq.py:106 _grouped_states, :568 _carry_states, :186) | group_states.py + csrc/group_states.cu (CUDA cores, float32 in and out, float64 sums; a warp a block row: the ends kernel, every chunk's zero-entry end by a scan over the lanes; the solve kernel, the carry from `carry_w`'s first block row and s_true written once) |
| group_states, group_entry_states | the same solve split around a carry of the caller's own (the streams, the sharded pipeline, long uploads): the zero-entry states and the entry states' einsum | group_states.py + csrc/group_states.cu (the ends kernel and the solve kernel with a zero seed; an entry kernel, float32) |

Times on the card are in PERF.md.
"""
from .eq_design import eq_design
from .eq_finish import eq_finish
from .experiments import (
    block_apply,
    block_end_states,
    equalize_seq_flat,
    polyphase_fir_dma,
    polyphase_fir_rect_rowdma,
    polyphase_fir_rect_splitbank,
)
from .experiments.rfft_butterfly import rfft_butterfly
from .fir_class import (
    class_supported,
    fir_frames_kernel,
    polyphase_fir,
    polyphase_fir_class_flat,
    polyphase_fir_class_frames,
    polyphase_fir_class_rect_cat,
    polyphase_fir_class_rect_frames,
)
from .fir_shear import polyphase_fir_shear_frames
from .group_states import (
    group_ends, group_entry_states, group_solve, group_states,
)
from .rfft import rfft_four_step_complex, rfft_four_step_magnitude
from .rfft_two_pass import rfft_four_step_tall, rfft_two_level

KERNELS = (polyphase_fir_class_rect_cat, fir_frames_kernel, eq_finish,
           rfft_four_step_magnitude, rfft_four_step_complex,
           rfft_four_step_tall, rfft_two_level, block_end_states,
           block_apply, equalize_seq_flat, rfft_butterfly,
           polyphase_fir_dma, polyphase_fir_rect_splitbank,
           polyphase_fir_rect_rowdma, polyphase_fir_class_frames,
           polyphase_fir_shear_frames, polyphase_fir_class_flat,
           polyphase_fir, eq_design, group_ends, group_solve, group_states,
           group_entry_states)


def launch_counts() -> dict:
    """{wrapper name: launches} for every hand-written kernel (K4-K6, E1
    and E3-E5 count their launches of the frames kernel, which counts them
    too; eq_design a call of its two kernels)."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def fir_frames(x, plan, n_out, *, kernel: str = "auto", precision=None,
               pad_frames: bool = False, num_frames=None, pad_left=None,
               g=None):
    """Resample (..., N) -> frames (..., F, P) through the frames kernel.

    kernel: 'auto' | 'rect' | 'class' | 'shear', the JAX package's routes
    (``dsp_audio_project_tpu/kernels/__init__.py:14``), each keeping its
    frame count with ``pad_frames`` and its ValueErrors.  'auto' takes
    'rect' where ``class_supported`` holds, else 'shear' (which raises for
    s < 8, as on the TPU).  All three launch the one frames kernel.  The
    JAX package's ``DSP_FIR_KERNEL`` override is not carried: it picks
    among TPU stagings that are one kernel here.  ``g``: the plan's G on
    x's device (cached from the plan when omitted).
    """
    table = {
        "rect": polyphase_fir_class_rect_frames,
        "class": polyphase_fir_class_frames,
        "shear": polyphase_fir_shear_frames,
    }
    if kernel == "auto":
        kernel = "rect" if class_supported(plan) else "shear"
    if kernel not in table:
        raise ValueError(f"unknown FIR kernel {kernel!r}; expected "
                         f"'auto' or one of {sorted(table)}")
    return table[kernel](
        x, plan, n_out, precision=precision, pad_frames=pad_frames,
        num_frames=num_frames, pad_left=pad_left, g=g,
    )
