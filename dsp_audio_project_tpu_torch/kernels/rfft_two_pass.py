"""K7 and K8: batched rfft of real rows for N >= 16384 — CUDA kernel, wrappers, plain version.

Replaces ``dsp_audio_project_tpu/kernels/rfft.py:327
rfft_pallas_four_step_tall`` (K7, N = 16384..524288) with
``rfft_four_step_tall`` and ``rfft.py:476 rfft_pallas_two_level`` (K8,
N = 1048576) with ``rfft_two_level``.  The JAX package writes both as one
factorisation, N = n1*n2, j = j1*n2 + j2, k = k1 + n1*k2:

    B[k1, j2]     = TW[k1, j2] * sum_j1 x[j1*n2 + j2] * W_n1^{j1 k1}
    X[k1 + n1*k2] = sum_j2 B[k1, j2] * W_n2^{j2 k2}

and K8 differs from K7 only in staging B through HBM, because VMEM is
small.  Shared memory on the H100 is smaller still (one N = 32768 row's B
is 256 KB), so both wrappers run the same two CUDA passes
(``csrc/rfft_two_pass.cu``, launcher ``rfft_two_pass_launch``) with B in a
global scratch.  Each wrapper counts its own launches: one per call of the
launcher, which starts both passes (the pair is one kernel, as the JAX
K8's two ``pallas_call``s are).  The split is the port's own, n2 =
2^floor(log2(N)/2) (balanced, the cheapest for direct sums; the JAX
two-level default), and the tables are fp32 cast once from float64.
The JAX package's bf16 hi/lo table pairs are a VMEM-size device and keep
only ~16 bits; they are not carried.  Outputs: (..., N/2+1) float32 |X|
(``magnitude=True``) or complex64 X.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.device import device_tables
from . import _build

MIN_N = 16384
_LAUNCHERS = {
    "rfft_two_pass_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
}


def default_n2(n: int) -> int:
    """The balanced split's n2 = 2^floor(log2(N)/2) (n1 = N/n2 >= n2)."""
    return 1 << ((n.bit_length() - 1) // 2)


@functools.lru_cache(maxsize=None)
def _two_pass_tables(n: int):
    """(d1 (2, n1, n1) [j1][k1], tw (2, n2, n1) [j2][k1], d2 (2, n2, n2/2)
    [j2][k2]) float32 on the balanced split: real and imaginary planes of
    W_n1^{j1 k1}, W_N^{k1 j2} and W_n2^{j2 k2} for k2 < n2/2, built in
    float64."""
    n2 = default_n2(n)
    n1 = n // n2

    def planes(z):
        return np.stack([z.real, z.imag]).astype(np.float32)

    d1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n1)) / n)
    d2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2 // 2)) / n2)
    return planes(d1), planes(tw), planes(d2)


def _device_tables(n: int, device: torch.device):
    """(d1, tw, d2) on ``device`` (cached)."""
    return device_tables(_two_pass_tables, n, device=device)


def rfft_two_pass_plain(x: torch.Tensor, d1: torch.Tensor, tw: torch.Tensor,
                        d2: torch.Tensor, magnitude: bool) -> torch.Tensor:
    """Plain torch version: the two passes as fp32 products.

    ``x`` (rows, N) float32 -> (rows, N//2 + 1) float32 |X| or complex64.
    """
    rows, n = x.shape
    n1 = d1.shape[-1]
    n2 = n // n1
    x3 = x.reshape(rows, n1, n2)                       # [j1][j2]
    ar = d1[0].t() @ x3                                # (rows, k1, j2)
    ai = d1[1].t() @ x3
    twr, twi = tw[0].t(), tw[1].t()                    # [k1][j2]
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    xr = br @ d2[0] - bi @ d2[1]                       # (rows, k1, k2 < n2/2)
    xi = br @ d2[1] + bi @ d2[0]
    sign = 1.0 - 2.0 * (torch.arange(n2, device=x.device) % 2).to(x.dtype)
    # X[k1 + n1*k2] for k < N/2, then the Nyquist bin sum_j2 B[0, j2] (-1)^j2.
    re = torch.cat([xr.transpose(1, 2).reshape(rows, n // 2),
                    (br[:, 0] @ sign)[:, None]], dim=1)
    im = torch.cat([xi.transpose(1, 2).reshape(rows, n // 2),
                    (bi[:, 0] @ sign)[:, None]], dim=1)
    # hypot rather than sqrt: see rfft.rfft_four_step_plain.
    return torch.hypot(re, im) if magnitude else torch.complex(re, im)


def _launch(x, tables, b, out, n1, n2, magnitude):
    lib = _build.load("rfft_two_pass", _LAUNCHERS)
    d1, tw, d2 = tables
    with torch.cuda.device(x.device):
        err = lib.rfft_two_pass_launch(
            x.data_ptr(), d1.data_ptr(), tw.data_ptr(), d2.data_ptr(),
            b.data_ptr(), out.data_ptr(), x.shape[0], n1, n2, int(magnitude),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "rfft_two_pass_launch")


def _two_pass(x: torch.Tensor, magnitude: bool, wrapper):
    """The checks, the plain version on a CPU tensor, the two passes
    (counted once on ``wrapper``) on a CUDA tensor."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[-1]
    if n < MIN_N or n & (n - 1):
        raise ValueError(f"needs a power-of-two N >= {MIN_N}, got {n}")
    n2 = default_n2(n)
    n1 = n // n2
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    rows = x2.shape[0]
    if rows >= 2**31:
        raise ValueError(f"{rows} rows exceed the grid's 2^31 - 1")
    tables = _device_tables(n, x.device)
    if x.device.type == "cpu":
        out = rfft_two_pass_plain(x2, *tables, magnitude)
    else:
        out = torch.empty((rows, n // 2 + 1), device=x.device,
                          dtype=torch.float32 if magnitude else torch.complex64)
        if rows:
            if x2.data_ptr() % 16:          # the kernel reads float4s
                x2 = x2.clone()
            b = torch.empty((rows, 2, n), dtype=torch.float32,
                            device=x.device)
            _launch(x2, tables, b,
                    out if magnitude else torch.view_as_real(out),
                    n1, n2, magnitude)
            wrapper.launches += 1
    return out.reshape(lead + (n // 2 + 1,))


def rfft_four_step_tall(x: torch.Tensor, *,
                        magnitude: bool = False) -> torch.Tensor:
    """K7: rfft of real (..., N) float32 -> (..., N//2 + 1), N a power of
    two >= 16384 (the JAX plan sends 16384..524288 here), on the balanced
    split.  A CPU tensor runs the plain version; a CUDA tensor launches
    the two passes; anything else raises.
    """
    return _two_pass(x, magnitude, rfft_four_step_tall)


def rfft_two_level(x: torch.Tensor, *,
                   magnitude: bool = False) -> torch.Tensor:
    """K8: the contract of ``rfft_four_step_tall`` (the JAX plan sends
    N = 1048576 here), counted separately."""
    return _two_pass(x, magnitude, rfft_two_level)


rfft_four_step_tall.launches = 0
rfft_two_level.launches = 0
