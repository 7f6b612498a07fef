"""Counterparts of the JAX package's experimental kernels (E2-E7).

``dsp_audio_project_tpu/kernels/experiments/`` keeps kernel variants that
lost a measured comparison on the TPU (or did not lower there) as research
baselines.  The port keeps each one's entry point and contract:

| id | module | route on Hopper |
|----|--------|-----------------|
| E2a, E2b | iir.py ``block_end_states``, ``block_apply`` | ``csrc/iir_block.cu``; ``KernelConfig(iir_path='pallas')`` reaches them through ``ops/eq.equalize_pallas`` |
| E3 | fir_dma.py ``polyphase_fir_dma`` | the frames kernel (``csrc/fir_cat.cu``) |
| E4 | fir_splitbank.py ``polyphase_fir_rect_splitbank`` | the frames kernel |
| E5 | fir_rowdma.py ``polyphase_fir_rect_rowdma`` | the frames kernel |
| E6 | rfft_butterfly.py ``rfft_butterfly`` (JAX ``rfft_pallas``) | ``csrc/rfft_butterfly.cu`` on the register-radix header ``csrc/fft_radix.cuh``; the two-pass kernel above N = 32768 |
| E7 | iir_seq.py ``equalize_seq_flat`` | ``csrc/iir_seq.cu`` |

E1 (``experiments/fir.py:polyphase_fir``) is ``kernels/fir_class.
polyphase_fir``.  Their times on the card are in PERF.md.  The package
re-exports each entry point except ``rfft_butterfly``, whose name is its
module's.
"""
from .fir_dma import polyphase_fir_dma
from .fir_rowdma import polyphase_fir_rect_rowdma
from .fir_splitbank import polyphase_fir_rect_splitbank
from .iir import block_apply, block_end_states
from .iir_seq import equalize_seq_flat
