"""E5: the row-DMA rect FIR's entry point over the frames kernel.

Replaces ``dsp_audio_project_tpu/kernels/experiments/fir_rowdma.py:89
polyphase_fir_rect_rowdma``: K3's frames, DMAed on the TPU row by row from
the untransposed staging to save its transpose pass.  The frames kernel
(``fir_class.fir_frames_kernel``) reads the flat signal with no staging at
all, so this module keeps the contract: the class-kernel regime
``ValueError``, then K3's frames with ``pad_frames`` / ``num_frames`` /
``pad_left``.  ``precision`` is accepted and ignored.  ``launches`` counts
its launches of the frames kernel.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..fir_class import (
    counts_frames_launches, polyphase_fir_class_rect_frames,
)

if TYPE_CHECKING:
    from ...ops.src import PolyphasePlan


@counts_frames_launches
def polyphase_fir_rect_rowdma(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    precision=None,
    pad_frames: bool = False,
    num_frames: int | None = None,
    pad_left: int | None = None,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3's frames (..., F, P) (see ``polyphase_fir_class_rect_frames``),
    with the JAX kernel's regime check."""
    if plan.s < 8 or plan.W > 128 * plan.s:
        raise ValueError("class-kernel regime required")
    return polyphase_fir_class_rect_frames(
        x, plan, n_out, pad_frames=pad_frames, num_frames=num_frames,
        pad_left=pad_left, g=g)
