"""E6: the butterfly rfft — CUDA kernel, wrapper, plain version.

Replaces ``dsp_audio_project_tpu/kernels/experiments/rfft_butterfly.py:76
rfft_pallas``; the JAX function's name is ``rfft_pallas``, the port's
``rfft_butterfly`` (the port's 'pallas' names are kept only where a config
value says 'pallas').  Only its tests reach it.  A batched rfft of real
rows, power-of-two N >= 4, complex64 (..., N/2+1): pack z = x[0::2] +
i x[1::2], an N/2-point FFT, the packed-real untwiddle.  The TPU kernel
runs the FFT as log2(N/2) radix-2 stages; the CUDA kernel
(``csrc/rfft_butterfly.cu``) runs the register-radix FFT of
``csrc/fft_radix.cuh`` (K2's and K7's row kernel) up to N = 32768, under its
own launcher and ``launches`` count.  Above that the wrapper runs the
two-pass kernel's complex form (K7, ``rfft_two_pass.rfft_four_step_tall``),
the same function, and counts the launch there.  The plain version is the
header's torch mirror (``fft_radix.rfft_radix_plain``), so that the card
compares kernel with plain like for like.  ``row_tile`` is the TPU's row
tile: accepted and ignored.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fft_radix import ONE_PASS_MAX_N as MAX_N, radix_device_tables
from ..fft_radix import rfft_radix_plain
from ..rfft_two_pass import rfft_four_step_tall

_LAUNCHERS = {
    "rfft_butterfly_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}


def rfft_butterfly_plain(x: torch.Tensor, tw: torch.Tensor,
                         un: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the kernel's radix plan, tables
    (``fft_radix.radix_device_tables``) and untwiddle.

    ``x`` (rows, N) float32, N <= 32768 -> (rows, N//2 + 1) complex64.
    """
    return rfft_radix_plain(x, tw, un, magnitude=False)


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
    tw, un = radix_device_tables(n, x.device)
    if x.device.type == "cpu":
        return rfft_butterfly_plain(x2, tw, un).reshape(lead + (n // 2 + 1,))
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
