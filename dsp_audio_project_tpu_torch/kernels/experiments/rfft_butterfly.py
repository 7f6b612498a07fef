"""E6: the radix-2 butterfly rfft — CUDA kernel, wrapper, plain version.

Replaces ``dsp_audio_project_tpu/kernels/experiments/rfft_butterfly.py:76
rfft_pallas``; the JAX function's name is ``rfft_pallas``, the port's
``rfft_butterfly`` (the port's 'pallas' names are kept only where a config
value says 'pallas').  Only its tests reach it.  A batched rfft of real
rows, power-of-two N >= 4, complex64 (..., N/2+1): pack z = x[0::2] +
i x[1::2], bit-reverse, log2(N/2) radix-2 stages on the data held on chip,
the packed-real untwiddle.  The CUDA kernel (``csrc/rfft_butterfly.cu``)
keeps a row in shared memory for every stage and fuses the untwiddle into
its store, up to N = 32768 (N/2 complex values, 128 KB).  Above that the
wrapper runs the two-pass kernel's complex form (K7,
``rfft_two_pass.rfft_four_step_tall``), the same function, and counts the
launch there.  ``row_tile`` is the TPU's row tile: accepted and ignored.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.device import device_tables
from .. import _build
from ..rfft_two_pass import rfft_four_step_tall

MAX_N = 32768     # the shared-memory kernel's largest N
_LAUNCHERS = {
    "rfft_butterfly_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _butterfly_tables(n: int):
    """(bit reversal of n/2 (int64), tw (n/4 or 1) complex64 W_{n/2}^k,
    un (n/2 + 1) complex64 e^{-2 pi i k / n}), built in float64."""
    nh = n // 2
    bits = nh.bit_length() - 1
    idx = np.arange(nh)
    rev = np.zeros(nh, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    tw = np.exp(-2j * np.pi * np.arange(max(nh // 2, 1)) / nh)
    un = np.exp(-2j * np.pi * np.arange(nh + 1) / n)
    return rev, tw.astype(np.complex64), un.astype(np.complex64)


def rfft_butterfly_plain(x: torch.Tensor, rev: torch.Tensor, tw: torch.Tensor,
                         un: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the kernel's three steps as torch ops.

    ``x`` (rows, N) float32 -> (rows, N//2 + 1) complex64.
    """
    rows, n = x.shape
    nh = n // 2
    z = torch.complex(x[:, 0::2], x[:, 1::2])[:, rev]
    half = 1
    while half < nh:
        z3 = z.reshape(rows, nh // (2 * half), 2 * half)
        a, b = z3[..., :half], z3[..., half:]
        t = b * tw[:: nh // (2 * half)][:half]
        z = torch.cat([a + t, a - t], dim=-1).reshape(rows, nh)
        half *= 2
    zk = torch.cat([z, z[:, :1]], dim=-1)
    zrev = torch.conj(zk.flip(-1))
    return 0.5 * (zk + zrev) + un * (-0.5j * (zk - zrev))


def _launch(x, out, tw, un, rows, log2_nh):
    lib = _build.load("rfft_butterfly", _LAUNCHERS)
    with torch.cuda.device(x.device):
        err = lib.rfft_butterfly_launch(
            x.data_ptr(), out.data_ptr(), tw.data_ptr(), un.data_ptr(),
            rows, log2_nh, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "rfft_butterfly_launch")


def rfft_butterfly(x: torch.Tensor, *, row_tile: int | None = None
                   ) -> torch.Tensor:
    """rfft of real (..., N) float32 -> complex64 (..., N//2 + 1), N a
    power of two >= 4.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (N <= 32768) or the two-pass kernel (larger N);
    anything else raises."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[-1]
    if n < 4 or n & (n - 1):
        raise ValueError(f"rfft_butterfly needs power-of-two N >= 4, got {n}")
    x = x.contiguous()
    if n > MAX_N:
        return rfft_four_step_tall(x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    rows = x2.shape[0]
    rev, tw, un = device_tables(_butterfly_tables, n, device=x.device)
    if x.device.type == "cpu":
        return rfft_butterfly_plain(x2, rev, tw, un).reshape(lead + (n // 2 + 1,))
    if rows >= 2**31:
        raise ValueError(f"{rows} rows exceed the grid's 2^31 - 1")
    out = torch.empty((rows, n // 2 + 1), dtype=torch.complex64,
                      device=x.device)
    if rows:
        if x2.data_ptr() % 8:               # the kernel reads float2s
            x2 = x2.clone()
        _launch(x2, out, tw, un, rows, (n // 2).bit_length() - 1)
        rfft_butterfly.launches += 1
    return out.reshape(lead + (n // 2 + 1,))


rfft_butterfly.launches = 0
