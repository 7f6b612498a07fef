"""E7: the one-sweep flat EQ with the block state carried along each row — CUDA kernel, wrapper, plain version.

Replaces ``dsp_audio_project_tpu/kernels/experiments/iir_seq.py:127
equalize_seq_flat``, which only its tests reach.  The flat signal (..., L)
is cut into blocks of G groups of U samples (``BlockOperators`` block and
unroll); per block, with sigma the block's true entry state (0 for the first
block of every row):

    inj    = x_g @ group_in                       (G, d)
    s_tail = inj_flat @ group_toeplitz            zero-entry group states
    s_true = shift(s_tail) + sigma @ powsT        the carry folded in
    y      = clip(x_g @ fir + s_true @ group_out, -1, 1)
    sigma  <- sigma @ A_blk^T + s_tail[G-1]

The TPU kernel carried sigma in VMEM across its sequential grid.  The CUDA
kernel (``csrc/iir_seq.cu``) is a chained scan: CTAs take blocks from an
atomic ticket, compute everything that does not need sigma, wait for the
previous block's published sigma and publish their own.  It sums
``s_tail`` over the powers A^{gU} (the Toeplitz matrix's distinct blocks)
rather than over the dense (G d, G d) matrix; the plain version keeps the
matrix, as the JAX kernel does.  Both are float32 throughout: ``fast``
(the TPU's bf16x3 FIR product) is accepted and has no effect.
``super_blocks`` (the TPU grid step) only sets the length rule: L must be a
multiple of super_blocks * block, and the same ``ValueError`` is raised.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.device import device_tables
from .. import _build
from .iir import ORDERS

_LAUNCHERS = {
    "iir_seq_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _seq_tables(ops):
    """Float32 host tables: (gin (U, d), toe (G d, G d), pows (G, d, d),
    fir (U, U) = group_fir^T, gout (d, U), ablk (d, d) = A^block)."""
    f32 = np.float32
    return (np.asarray(ops.group_in, f32), np.asarray(ops.group_toeplitz, f32),
            np.asarray(ops.group_pows, f32),
            np.ascontiguousarray(np.asarray(ops.group_fir, f32).T),
            np.asarray(ops.group_out, f32), np.asarray(ops.state_corr, f32))


def equalize_seq_plain(x4: torch.Tensor, gin, toe, pows, fir, gout,
                       ablk) -> torch.Tensor:
    """Plain torch version on (rows, K, G, U) blocks -> clipped y, same
    shape: every block-local product batched, the carry a loop over K."""
    rows, K, G, U = x4.shape
    d = gin.shape[1]
    inj = x4 @ gin
    s_tail = (inj.reshape(rows, K, G * d) @ toe).reshape(rows, K, G, d)
    sig = x4.new_zeros((rows, d))
    sigmas = []
    for k in range(K):
        sigmas.append(sig)
        sig = sig @ ablk.t() + s_tail[:, k, G - 1]
    sigma = torch.stack(sigmas, dim=1)
    s_in = torch.cat([s_tail.new_zeros((rows, K, 1, d)),
                      s_tail[:, :, :G - 1]], dim=2)
    s_true = s_in + torch.einsum("gef,rkf->rkge", pows, sigma)
    return torch.clamp(x4 @ fir + s_true @ gout, -1.0, 1.0)


def _launch(x, y, tables, sig, sync, rows, K, G, U, d):
    lib = _build.load("iir_seq", _LAUNCHERS)
    gin, _, pows, fir, gout, ablk = tables
    with torch.cuda.device(x.device):
        err = lib.iir_seq_launch(
            x.data_ptr(), y.data_ptr(), gin.data_ptr(), pows.data_ptr(),
            fir.data_ptr(), gout.data_ptr(), ablk.data_ptr(), sig.data_ptr(),
            sync.data_ptr(), rows, K, G, U, d,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "iir_seq_launch")


def equalize_seq_flat(x: torch.Tensor, ops, *, super_blocks: int = 10,
                      fast: bool = True) -> torch.Tensor:
    """One-sweep EQ on flat (..., L) float32 -> the clipped output, same
    shape.  L must be a multiple of super_blocks * ops.block; the state
    resets for every row.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel (U % 4 == 0 and the tables within shared
    memory, else it raises); anything else raises."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    block, U = ops.block, ops.unroll
    G, d = block // U, ops.A.shape[0]
    if d not in ORDERS:
        raise ValueError(f"state order {d} not in {ORDERS}")
    lead, L = x.shape[:-1], x.shape[-1]
    if L % (super_blocks * block):
        raise ValueError(
            f"flat length {L} must be a multiple of {super_blocks}*{block}")
    K = L // block
    x4 = x.contiguous().reshape(-1, K, G, U)
    rows = x4.shape[0]
    tables = device_tables(_seq_tables, ops, device=x.device)
    if x.device.type == "cpu":
        return equalize_seq_plain(x4, *tables).reshape(x.shape)
    if U % 4:
        raise ValueError(f"the kernel needs unroll % 4 == 0, got {U}")
    if x4.data_ptr() % 16:                  # the kernel reads float4s
        x4 = x4.clone()
    y = torch.empty_like(x4)
    if rows and K:
        sig = torch.empty(rows * K * d, dtype=torch.float32, device=x.device)
        sync = torch.zeros(1 + rows * K, dtype=torch.int32, device=x.device)
        _launch(x4, y, tables, sig, sync, rows, K, G, U, d)
        equalize_seq_flat.launches += 1
    return y.reshape(lead + (L,))


equalize_seq_flat.launches = 0
