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

The CUDA body (``csrc/iir_block.cu``, shared with E7) runs the group
algebra, not the per-sample recurrence: each block in groups of
``iir_group.GROUP`` samples, the injections and the triangular Toeplitz FIR
product in parallel, one serial Horner pass over the groups (tables in
``iir_group.py``, built at the kernel's group length from ``ops.A/B/C/D``,
whatever ``ops.unroll`` is).  ``block_tile`` is the TPU tile and is
accepted and ignored.  The plain versions keep the per-sample recurrence
(the yardstick); kernel and plain version agree to float32 rounding, not bit
for bit.  ``end_states_rows`` and ``apply_rows`` are the same launches on an
unpadded (rows, n) signal, reading zeros past n and writing the clipped
output cropped to n: ``ops/eq.equalize_pallas`` takes them, so the pad and
the clip are not passes of their own; they count as launches of
``block_end_states`` and ``block_apply``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.device import device_tables
from . import iir_group

ORDERS = (2, 4, 6, 8, 10, 12)   # the kernel's d: two states per EQ band


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


def _order(ops) -> int:
    d = ops.A.shape[0]
    if d not in ORDERS:
        raise ValueError(f"state order {d} not in {ORDERS}")
    return d


def _check(xb, ops) -> int:
    if not isinstance(xb, torch.Tensor) or xb.dtype != torch.float32:
        raise TypeError(f"xb must be a float32 tensor, got {getattr(xb, 'dtype', type(xb))}")
    if xb.ndim != 3 or not xb.is_contiguous():
        raise ValueError(f"xb must be a contiguous (batch, K, B) tensor, got "
                         f"{tuple(xb.shape)}")
    if xb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xb.device}")
    d = _order(ops)
    if xb.shape[0] * xb.shape[1] >= 2**31:
        raise ValueError(f"{tuple(xb.shape)}: more blocks than the grid's 2^31")
    return d


def end_states_rows(x: torch.Tensor, block: int, ops) -> torch.Tensor:
    """E2a on the blocks of a (rows, n) signal (rows may be strided, the
    samples contiguous), zeros past n: (rows, K, d), K = ceil(n / block).
    A CUDA tensor launches the kernel (a ``block_end_states`` launch); a
    CPU tensor runs the plain version."""
    rows, n = x.shape
    K = -(-n // block)
    d = _order(ops)
    if x.device.type == "cpu":
        xb = torch.nn.functional.pad(x, (0, K * block - n))
        a_t, b, _, _ = device_tables(_plain_consts, ops, device=x.device)
        return block_end_states_plain(xb.reshape(rows, K, block), a_t, b)
    end = torch.empty((rows, K, d), dtype=torch.float32, device=x.device)
    if rows * K:
        iir_group.launch("iir_end_states_launch", x, end,
                         iir_group.device_table(ops, block, x.device),
                         rows, K, x.stride(0), n, block, d)
        block_end_states.launches += 1
    return end


def apply_rows(x: torch.Tensor, sigma: torch.Tensor, block: int, ops,
               clip: bool = True) -> torch.Tensor:
    """E2b on the blocks of a (rows, n) signal from their entry states
    sigma (rows, K, d) contiguous: (rows, n), clipped to [-1, 1] when
    ``clip``.  A CUDA tensor launches the kernel (a ``block_apply``
    launch); a CPU tensor runs the plain version."""
    rows, n = x.shape
    K = -(-n // block)
    d = _order(ops)
    if x.device.type == "cpu":
        xb = torch.nn.functional.pad(x, (0, K * block - n))
        y = block_apply_plain(xb.reshape(rows, K, block), sigma,
                              *device_tables(_plain_consts, ops,
                                             device=x.device))
        y = y.reshape(rows, K * block)[:, :n]
        return torch.clamp(y, -1.0, 1.0) if clip else y
    y = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    if rows * K:
        iir_group.launch("iir_apply_launch", x, sigma, y,
                         iir_group.device_table(ops, block, x.device),
                         rows, K, x.stride(0), n, n, block, d, int(clip))
        block_apply.launches += 1
    return y


def block_end_states(xb: torch.Tensor, ops, *,
                     block_tile: int | None = None) -> torch.Tensor:
    """E2a: the zero-init end state per block.  xb (batch, K, B) float32
    contiguous -> (batch, K, d).  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel; anything else raises."""
    d = _check(xb, ops)
    bt, K, B = xb.shape
    if not B:
        return xb.new_zeros((bt, K, d))
    return end_states_rows(xb.reshape(bt, K * B), B, ops)


def block_apply(xb: torch.Tensor, sigma: torch.Tensor, ops, *,
                block_tile: int | None = None) -> torch.Tensor:
    """E2b: each block's output from its true initial state.  xb (batch, K,
    B), sigma (batch, K, d), both float32 contiguous on one device -> y
    (batch, K, B), unclipped.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel; anything else raises."""
    d = _check(xb, ops)
    if (not isinstance(sigma, torch.Tensor) or sigma.dtype != torch.float32
            or sigma.device != xb.device or not sigma.is_contiguous()
            or tuple(sigma.shape) != tuple(xb.shape[:-1]) + (d,)):
        raise ValueError(f"sigma must be a contiguous float32 "
                         f"{tuple(xb.shape[:-1]) + (d,)} tensor on {xb.device}")
    bt, K, B = xb.shape
    if not B:
        return torch.empty_like(xb)
    return apply_rows(xb.reshape(bt, K * B), sigma, B, ops,
                      clip=False).reshape(xb.shape)


block_end_states.launches = 0
block_apply.launches = 0
