"""K9: the EQ finish epilogue — CUDA kernel, wrapper, plain version.

z = clip(y0 + s_true @ group_out, -1, 1) over rows: the readout of the EQ's
true group-entry states and the reference's hard clip (dsp_core.py:254) in
one memory-bound pass that reads y0 once and writes z once.  The EQ glue
(ops/eq.py) calls it for the cat finish (``equalize_frames_cat``), the
frames EQ (``equalize_frames``) and the flat EQ (``equalize``).

Replaces ``dsp_audio_project_tpu/kernels/eq_finish.py:50 eq_finish_pallas``.
The port takes s_true in its natural (..., F, d) layout: the TPU kernel's
packed-transposed ``st`` exists only so that Mosaic can relayout it.  y0
may be a column slice of a wider tensor (the frames EQ reads it out of the
weight-concat product [y0 | inj]): rows must be evenly spaced with unit
column stride.  Source: ``csrc/eq_finish.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_LAUNCHERS = {
    "eq_finish_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def eq_finish_plain(y0: torch.Tensor, s_true: torch.Tensor,
                    group_out: torch.Tensor) -> torch.Tensor:
    """Plain torch version: clip(y0 + s_true @ group_out, -1, 1)."""
    return torch.clamp(y0 + s_true @ group_out, -1.0, 1.0)


def row_stride(t: torch.Tensor) -> int | None:
    """Element stride between consecutive rows of ``t`` viewed as
    (-1, t.shape[-1]), or None when its rows are not evenly spaced or its
    columns not unit-strided."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        return None
    ld = expect = None
    for size, stride in zip(reversed(t.shape[:-1]), reversed(t.stride()[:-1])):
        if size == 1:
            continue
        if ld is None:
            ld = stride
        elif stride != expect:
            return None
        expect = stride * size
    return t.shape[-1] if ld is None else ld


def _launch(y0, st, gout, z, rows, U, d, ldy, vec):
    lib = _build.load("eq_finish", _LAUNCHERS)
    with torch.cuda.device(y0.device):
        err = lib.eq_finish_launch(
            y0.data_ptr(), st.data_ptr(), gout.data_ptr(), z.data_ptr(),
            rows, U, d, ldy, int(vec),
            torch.cuda.current_stream(y0.device).cuda_stream,
        )
    _build.check(lib, err, "eq_finish_launch")


def eq_finish(y0: torch.Tensor, s_true: torch.Tensor,
              group_out: torch.Tensor) -> torch.Tensor:
    """z = clip(y0 + s_true @ group_out, -1, 1) -> (..., F, U) contiguous.

    ``y0`` (..., F, U) float32 with evenly spaced rows (``row_stride``);
    ``s_true`` (..., F, d) float32 contiguous; ``group_out`` (d, U) float32
    contiguous; all on one device.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel (which raises when group_out does not
    fit in shared memory); anything else raises.
    """
    for name, t in (("y0", y0), ("s_true", s_true), ("group_out", group_out)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if t.device != y0.device:
            raise ValueError(f"{name} is on {t.device}, y0 on {y0.device}")
    if y0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y0.device}")
    if group_out.ndim != 2 or not group_out.is_contiguous():
        raise ValueError("group_out must be a contiguous (d, U) matrix")
    d, U = group_out.shape
    if y0.ndim < 2 or y0.shape[-1] != U:
        raise ValueError(f"y0 {tuple(y0.shape)} must be (..., F, {U})")
    if tuple(s_true.shape) != tuple(y0.shape[:-1]) + (d,):
        raise ValueError(f"s_true {tuple(s_true.shape)} must be "
                         f"{tuple(y0.shape[:-1]) + (d,)}")
    if not s_true.is_contiguous():
        raise ValueError("s_true must be contiguous")
    ldy = row_stride(y0)
    if ldy is None or ldy < U:
        raise ValueError(f"y0 rows must be evenly spaced with unit column "
                         f"stride, got strides {y0.stride()}")
    if y0.device.type == "cpu":
        return eq_finish_plain(y0, s_true, group_out)
    z = torch.empty(y0.shape, dtype=torch.float32, device=y0.device)
    rows = z.numel() // U if U else 0
    if rows:
        vec = (U % 4 == 0 and ldy % 4 == 0 and y0.data_ptr() % 16 == 0
               and z.data_ptr() % 16 == 0)
        _launch(y0, s_true, group_out, z, rows, U, d, ldy, vec)
        eq_finish.launches += 1
    return z


eq_finish.launches = 0
