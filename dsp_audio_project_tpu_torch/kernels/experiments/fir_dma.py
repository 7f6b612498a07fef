"""E3: the manual-DMA polyphase FIR's entry point over the frames kernel.

Replaces ``dsp_audio_project_tpu/kernels/experiments/fir_dma.py:70
polyphase_fir_dma``: flat (..., n_out) SRC output, frame f =
x_pad[f*s : f*s + W] @ G.  On the TPU it DMAs each tile's overlapping
window rows into VMEM itself; on Hopper the frames kernel
(``fir_class.fir_frames_kernel``, ``csrc/fir_cat.cu``) loads the strided
windows directly, so this module keeps the contract: ceil(n_out/P) frames,
viewed flat and cropped to n_out, as E1.  ``frame_tile`` (the TPU tile) and
``precision`` are accepted and ignored (the kernel is fp32).
``launches`` counts its launches of the frames kernel.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..fir_class import _frames, counts_frames_launches

if TYPE_CHECKING:
    from ...ops.src import PolyphasePlan


@counts_frames_launches
def polyphase_fir_dma(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    frame_tile: int | None = None,
    precision=None,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """Resample (..., N) -> (..., n_out): ops/src.resample's output.  ``g``:
    the plan's G on x's device (cached from the plan when omitted)."""
    f_out = -(-n_out // plan.P)
    y = _frames(x, plan, f_out, None, g)
    return y.reshape(y.shape[:-2] + (f_out * plan.P,))[..., :n_out]
