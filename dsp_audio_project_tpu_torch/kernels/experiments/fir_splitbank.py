"""E4: the split-bank rect FIR's entry point over the frames kernel.

Replaces ``dsp_audio_project_tpu/kernels/experiments/fir_splitbank.py:103
polyphase_fir_rect_splitbank``: K3's frames with each class's matmul split
at output column ``split_at`` (P = 128 + 32 on the serving plan), a test of
the MXU's 128-lane passes.  The split changes no value, and the frames
kernel (``fir_class.fir_frames_kernel``) has no lane passes to split, so
this module keeps the contract: the class-kernel regime and ``split_at``
range ``ValueError``s, then K3's frames with ``pad_frames`` /
``num_frames`` / ``pad_left``.  ``precision`` is accepted and ignored.
``launches`` counts its launches of the frames kernel.
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
def polyphase_fir_rect_splitbank(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    precision=None,
    pad_frames: bool = False,
    num_frames: int | None = None,
    pad_left: int | None = None,
    split_at: int = 128,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3's frames (..., F, P) (see ``polyphase_fir_class_rect_frames``),
    with the JAX kernel's checks."""
    if plan.s < 8 or plan.W > 128 * plan.s:
        raise ValueError("class-kernel regime required")
    if not 0 < split_at < plan.P:
        raise ValueError(f"split_at {split_at} outside (0, {plan.P})")
    return polyphase_fir_class_rect_frames(
        x, plan, n_out, pad_frames=pad_frames, num_frames=num_frames,
        pad_left=pad_left, g=g)
