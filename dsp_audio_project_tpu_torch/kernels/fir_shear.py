"""K5: the shear FIR's entry point over the frames kernel.

Replaces ``dsp_audio_project_tpu/kernels/fir_shear.py:167
polyphase_fir_shear_frames``: frames = windows @ G, built on the TPU by an
in-VMEM shear and a barrel shifter so that no frame matrix reaches HBM.  On
Hopper the frames kernel (``fir_class.fir_frames_kernel``,
``csrc/fir_cat.cu``) loads the strided windows directly, so this module
keeps only the contract: the s >= 8 ``ValueError`` and the padded frame
count of ``pad_frames`` (a multiple of SUPER*128 frames, SUPER =
8 // gcd(s, 8), the TPU grid step).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from .fir_class import _frames, counts_frames_launches

if TYPE_CHECKING:
    from ..ops.src import PolyphasePlan

TILE_FRAMES = 128  # frames per TPU subtile


@counts_frames_launches
def polyphase_fir_shear_frames(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    precision=None,
    pad_frames: bool = False,
    num_frames: int | None = None,
    pad_left: int | None = None,
    split_subtiles: bool = False,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """Resample (..., N) -> frames (..., ceil(n_out/P), P).

    frames.reshape(..., -1)[..., :n_out] is ops/src.resample's flat output.
    ``pad_frames=True`` returns the JAX kernel's tile-aligned frame count;
    ``num_frames`` and ``pad_left`` as in ``polyphase_fir_class_rect_frames``.
    ``split_subtiles`` is a TPU scheduling choice (independent shear chains
    per subtile) with identical output; it is accepted and ignored, as is
    ``precision``.  Requires s >= 8, as the JAX kernel does.  ``launches``
    counts its launches of the frames kernel.
    """
    s = plan.s
    if s < 8:
        raise ValueError("shear kernel targets the wide-stride regime s>=8")
    if num_frames is None:
        num_frames = -(-n_out // plan.P)
    f_out = num_frames
    if pad_frames:
        step = (8 // math.gcd(s, 8)) * TILE_FRAMES
        f_out = step * -(-num_frames // step)
    return _frames(x, plan, f_out, pad_left, g)
