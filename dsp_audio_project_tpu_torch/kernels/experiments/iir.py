"""E2a and E2b: the block-parallel IIR recurrence — CUDA kernels, wrappers, plain versions.

Replaces ``dsp_audio_project_tpu/kernels/experiments/iir.py:100
block_end_states`` (E2a) and ``:134 block_apply`` (E2b), which
``KernelConfig(iir_path='pallas')`` reaches through
``ops/eq.equalize_pallas``.  The EQ's flat signal is cut into K blocks of B
samples; the cascade's order-d system (``BlockOperators`` A, B, C, D)
runs along each block twice:

  E2a  ``block_end_states``: the end state of each block from a zero state;
  (the caller solves the true initial state sigma of every block from
  those, ``ops/eq._carry_states``);
  E2b  ``block_apply``: y_j = s . C + D x_j, s <- s A^T + x_j B from sigma,
  the block's output with no correction product.

The operators are cast once to float32 from the float64 design, as the
JAX package's ``_operator_consts`` does.  The TPU tiling (2048-block tiles,
the in-VMEM transpose, y written over x's rows) does not carry over: the
CUDA kernels (``csrc/iir_block.cu``) run each block on a 16-lane segment,
lane e holding state component e and row e of A, with shuffles between
steps.  ``block_tile`` is the TPU tile and is accepted and ignored.  The
kernel and the plain version sum each step in different orders, so they
agree to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.device import device_tables
from .. import _build

ORDERS = (2, 4, 6, 8, 10, 12)   # the kernel's d: two states per EQ band
_LAUNCHERS = {
    "iir_end_states_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
    "iir_apply_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _system_consts(ops) -> np.ndarray:
    """Host float32 [A (d*d, row-major) | B | C | D]: the kernels' operand."""
    return np.concatenate([
        np.asarray(ops.A, np.float32).ravel(), np.asarray(ops.B, np.float32),
        np.asarray(ops.C, np.float32), np.float32([ops.D]),
    ])


@functools.lru_cache(maxsize=None)
def _plain_consts(ops):
    """(A^T (d, d), B (d,), C (d,), D (1,)) float32: the plain versions'."""
    return (np.asarray(ops.A, np.float32).T.copy(),
            np.asarray(ops.B, np.float32), np.asarray(ops.C, np.float32),
            np.float32([ops.D]))


def block_end_states_plain(xb: torch.Tensor, a_t: torch.Tensor,
                           b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of E2a: B steps s <- s @ A^T + x_j B from zero,
    vectorised over (batch, K).  xb (batch, K, B) -> (batch, K, d)."""
    s = xb.new_zeros(xb.shape[:-1] + (a_t.shape[0],))
    for j in range(xb.shape[-1]):
        s = s @ a_t + xb[..., j, None] * b
    return s


def block_apply_plain(xb: torch.Tensor, sigma: torch.Tensor,
                      a_t: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """Plain torch version of E2b: from sigma (batch, K, d), y_j = s @ C +
    D x_j then s <- s @ A^T + x_j B.  -> y (batch, K, B)."""
    y = torch.empty_like(xb)
    s = sigma
    for j in range(xb.shape[-1]):
        xj = xb[..., j]
        y[..., j] = s @ c + d * xj
        s = s @ a_t + xj[..., None] * b
    return y


def _check(xb, ops) -> int:
    if not isinstance(xb, torch.Tensor) or xb.dtype != torch.float32:
        raise TypeError(f"xb must be a float32 tensor, got {getattr(xb, 'dtype', type(xb))}")
    if xb.ndim != 3 or not xb.is_contiguous():
        raise ValueError(f"xb must be a contiguous (batch, K, B) tensor, got "
                         f"{tuple(xb.shape)}")
    if xb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xb.device}")
    d = ops.A.shape[0]
    if d not in ORDERS:
        raise ValueError(f"state order {d} not in {ORDERS}")
    if xb.shape[0] * xb.shape[1] >= 2**31:
        raise ValueError(f"{tuple(xb.shape)}: more blocks than the grid's 2^31")
    return d


def _launch(name, tensors, consts, chains, B, d):
    """Launch ``name`` on the tensors' pointers, the host ``consts`` and
    the sizes, on the current stream; raise on a launch error."""
    lib = _build.load("iir_block", _LAUNCHERS)
    dev = tensors[0].device
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            *(t.data_ptr() for t in tensors), consts.ctypes.data,
            chains, B, d, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, err, name)


def block_end_states(xb: torch.Tensor, ops, *,
                     block_tile: int | None = None) -> torch.Tensor:
    """E2a: the zero-init end state per block.  xb (batch, K, B) float32
    contiguous -> (batch, K, d).  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel; anything else raises."""
    d = _check(xb, ops)
    if xb.device.type == "cpu":
        a_t, b, _, _ = device_tables(_plain_consts, ops, device=xb.device)
        return block_end_states_plain(xb, a_t, b)
    bt, K, B = xb.shape
    if not B:
        return xb.new_zeros((bt, K, d))
    end = torch.empty((bt, K, d), dtype=torch.float32, device=xb.device)
    if bt * K:
        _launch("iir_end_states_launch", (xb, end), _system_consts(ops),
                bt * K, B, d)
        block_end_states.launches += 1
    return end


def block_apply(xb: torch.Tensor, sigma: torch.Tensor, ops, *,
                block_tile: int | None = None) -> torch.Tensor:
    """E2b: each block's output from its true initial state.  xb (batch, K,
    B), sigma (batch, K, d), both float32 contiguous on one device -> y
    (batch, K, B).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel; anything else raises."""
    d = _check(xb, ops)
    if (not isinstance(sigma, torch.Tensor) or sigma.dtype != torch.float32
            or sigma.device != xb.device or not sigma.is_contiguous()
            or tuple(sigma.shape) != tuple(xb.shape[:-1]) + (d,)):
        raise ValueError(f"sigma must be a contiguous float32 "
                         f"{tuple(xb.shape[:-1]) + (d,)} tensor on {xb.device}")
    if xb.device.type == "cpu":
        return block_apply_plain(
            xb, sigma, *device_tables(_plain_consts, ops, device=xb.device))
    bt, K, B = xb.shape
    y = torch.empty_like(xb)
    if bt * K and B:
        _launch("iir_apply_launch", (xb, sigma, y), _system_consts(ops),
                bt * K, B, d)
        block_apply.launches += 1
    return y


block_end_states.launches = 0
block_apply.launches = 0
