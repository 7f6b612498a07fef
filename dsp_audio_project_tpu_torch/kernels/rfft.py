"""K2: batched rfft of real rows, four-step — CUDA kernel, wrappers, plain version.

Replaces ``dsp_audio_project_tpu/kernels/rfft.py:125 rfft_pallas_four_step``
in both forms: ``rfft_four_step_magnitude`` (|X|, the spectrum op's shape)
and ``rfft_four_step_complex`` (complex64 X, the STFT's), each with its own
``launches`` counter.  With N = n1*n2, j = j1*n2 + j2 and k = k1 + n1*k2:

    B[k1, j2]     = sum_j1 x[j1*n2 + j2] * C[k1, j1, j2]   (column DFT + twiddle)
    X[k1 + n1*k2] = sum_j2 B[k1, j2] * W_n2^{j2*k2}        (row DFT)

for the N/2+1 real-spectrum bins.  ``_four_step_tables`` is the JAX
package's host table builder (float64 -> float32) without the bf16 hi/lo
split: the CUDA kernel (``csrc/rfft_four_step.cu``, one body, the store
chosen at compile time) and the plain version both run fp32.  The split
n1 = min(32, N/128) is the JAX one, so the tables are identical; the TPU's
"n2 a lane multiple" rule does not bind the CUDA kernel, which is tested at
every power of two in 256..8192.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.device import device_tables
from . import _build

MIN_N, MAX_N = 256, 8192
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_LAUNCHERS = {"rfft_mag_launch": _ARGS, "rfft_complex_launch": _ARGS}


@functools.lru_cache(maxsize=None)
def _four_step_tables(n: int, n1: int):
    """(c (2, n1*n1, n2), d2 (n2, 2*n2)) float32, as the JAX package builds them."""
    n2 = n // n1
    d1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    # C[k1, j1, j2] = d1[k1, j1] * tw[k1, j2]: step-1 DFT and twiddle in one
    # coefficient vector per (k1, j1).
    c = d1[:, :, None] * tw[:, None, :]
    c = np.stack([c.real, c.imag]).reshape(2, n1 * n1, n2).astype(np.float32)
    d2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    d2 = np.concatenate([d2.real, d2.imag], axis=1).astype(np.float32)
    return c, d2


def _device_tables(n: int, n1: int, device: torch.device):
    """(c, d2) on ``device`` (cached)."""
    return device_tables(_four_step_tables, n, n1, device=device)


def rfft_four_step_plain(x: torch.Tensor, c: torch.Tensor, d2: torch.Tensor,
                         n1: int, magnitude: bool = True) -> torch.Tensor:
    """Plain torch version: the same four steps as fp32 products.

    ``x`` (rows, N) float32 -> (rows, N//2 + 1) magnitudes (float32) or,
    with ``magnitude=False``, the complex64 spectrum.
    """
    rows, n = x.shape
    n2 = n // n1
    k2max = n2 // 2 + 1                       # k2 range covering bins 0..N/2
    x3 = x.reshape(rows, 1, n1, n2)
    cc = c.reshape(2, n1, n1, n2)
    br = (x3 * cc[0]).sum(dim=2)              # (rows, n1, n2)
    bi = (x3 * cc[1]).sum(dim=2)
    d2r = d2[:, :k2max]
    d2i = d2[:, n2:n2 + k2max]
    xr = br @ d2r - bi @ d2i                  # (rows, n1, k2max)
    xi = br @ d2i + bi @ d2r
    # hypot, not sqrt(xr^2 + xi^2): torch's CPU sqrt kernel can return
    # ~2e-4-relative values on its first multithreaded call in a process
    # (ROADMAP Queue 3).
    out = torch.hypot(xr, xi) if magnitude else torch.complex(xr, xi)
    # X[k1 + n1*k2]: interleave and crop to the N/2+1 real bins.
    return out.transpose(1, 2).reshape(rows, n1 * k2max)[:, : n // 2 + 1]


def _launch(name, x, c, d2, out, n, n1):
    lib = _build.load("rfft_four_step", _LAUNCHERS)
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), c.data_ptr(), d2.data_ptr(), out.data_ptr(),
            x.shape[0], n, n1, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, name)


def _four_step(x: torch.Tensor, n1: int, magnitude: bool, wrapper):
    """The checks, the plain version on a CPU tensor, the launch (counted
    on ``wrapper``) on a CUDA tensor."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[-1]
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"needs a power-of-two N in [{MIN_N}, {MAX_N}], got {n}")
    if n1 < 2 or n % n1 or n // n1 < 2:
        raise ValueError(f"n1={n1} must split N={n} into two factors >= 2")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    if x2.shape[0] >= 2**31:
        raise ValueError(f"{x2.shape[0]} rows exceed the grid's 2^31 - 1")
    c, d2 = _device_tables(n, n1, x.device)
    if x.device.type == "cpu":
        out = rfft_four_step_plain(x2, c, d2, n1, magnitude)
    else:
        out = torch.empty((x2.shape[0], n // 2 + 1), device=x.device,
                          dtype=torch.float32 if magnitude else torch.complex64)
        if x2.shape[0]:
            _launch("rfft_mag_launch" if magnitude else "rfft_complex_launch",
                    x2, c, d2, out if magnitude else torch.view_as_real(out),
                    n, n1)
            wrapper.launches += 1
    return out.reshape(lead + (n // 2 + 1,))


def rfft_four_step_magnitude(x: torch.Tensor, *, n1: int) -> torch.Tensor:
    """|rfft| of real (..., N) float32 -> (..., N//2 + 1) float32, four-step.

    N must be a power of two in 256..8192 with n1 dividing it.  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel;
    anything else raises.
    """
    return _four_step(x, n1, True, rfft_four_step_magnitude)


def rfft_four_step_complex(x: torch.Tensor, *, n1: int) -> torch.Tensor:
    """rfft of real (..., N) float32 -> (..., N//2 + 1) complex64, four-step
    (K2's complex form, the STFT's); the contract of
    ``rfft_four_step_magnitude``."""
    return _four_step(x, n1, False, rfft_four_step_complex)


rfft_four_step_magnitude.launches = 0
rfft_four_step_complex.launches = 0
