"""K2: batched rfft of real rows, N = 256..8192 — CUDA kernel, wrappers, plain version.

Replaces ``dsp_audio_project_tpu/kernels/rfft.py:125 rfft_pallas_four_step``
in both forms: ``rfft_four_step_magnitude`` (|X|, the spectrum op's shape)
and ``rfft_four_step_complex`` (complex64 X, the STFT's), each with its own
``launches`` counter.  The CUDA kernel (``csrc/rfft_four_step.cu`` on the
shared body of ``csrc/fft_radix.cuh``) is bound by bytes, not operations:
it reads each row once as nh = N/2 packed complex points (z[m] = x[2m] +
i x[2m+1]), runs the nh-point FFT as ceil(log2(nh)/4) Stockham passes of
radix <= 16 held in registers (1024 = 16 * 8 * 8 at N = 2048), one
exchange through swizzled shared memory between passes, with fp32 twiddle
tables built in float64 (``fft_radix.radix_tables``), and fuses the
packed-real untwiddle and |X| into its store.  A 256-thread block holds
max(1, 4096/nh) rows; resident blocks overlap one another's loads and
passes (no persistent grid, no cp.async prefetch).

``n1`` is still validated, because it is the JAX plan's split
(``ops/fft._four_step_kernel_n1``), but it no longer binds the kernel's
own plan — as ``split_subtiles`` on K5.  The plain version
(``fft_radix.rfft_radix_plain``) runs the same packing, radix plan, tables
and untwiddle in torch.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fft_radix import radix_device_tables as _device_tables, rfft_radix_plain

MIN_N, MAX_N = 256, 8192
_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_LAUNCHERS = {"rfft_mag_launch": _ARGS, "rfft_complex_launch": _ARGS}


def rfft_four_step_plain(x: torch.Tensor, tw: torch.Tensor, un: torch.Tensor,
                         magnitude: bool = True) -> torch.Tensor:
    """Plain torch version: the kernel's radix plan, tables and untwiddle.

    ``x`` (rows, N) float32 -> (rows, N//2 + 1) magnitudes (float32) or,
    with ``magnitude=False``, the complex64 spectrum.
    """
    return rfft_radix_plain(x, tw, un, magnitude)


def _launch(name, x, tw, un, out, n):
    lib = _build.load("rfft_four_step", _LAUNCHERS)
    with torch.cuda.device(x.device):
        err = getattr(lib, name)(
            x.data_ptr(), tw.data_ptr(), un.data_ptr(), out.data_ptr(),
            x.shape[0], n, torch.cuda.current_stream(x.device).cuda_stream,
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
    tw, un = _device_tables(n, x.device)
    if x.device.type == "cpu":
        out = rfft_four_step_plain(x2, tw, un, magnitude)
    else:
        out = torch.empty((x2.shape[0], n // 2 + 1), device=x.device,
                          dtype=torch.float32 if magnitude else torch.complex64)
        if x2.shape[0]:
            if x2.data_ptr() % 8:           # the kernel reads float2 pairs
                x2 = x2.clone()
            _launch("rfft_mag_launch" if magnitude else "rfft_complex_launch",
                    x2, tw, un, out if magnitude else torch.view_as_real(out),
                    n)
            wrapper.launches += 1
    return out.reshape(lead + (n // 2 + 1,))


def rfft_four_step_magnitude(x: torch.Tensor, *, n1: int) -> torch.Tensor:
    """|rfft| of real (..., N) float32 -> (..., N//2 + 1) float32 (K2).

    N must be a power of two in 256..8192 with n1 dividing it (the JAX
    plan's split, checked and not used by the kernel).  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel;
    anything else raises.
    """
    return _four_step(x, n1, True, rfft_four_step_magnitude)


def rfft_four_step_complex(x: torch.Tensor, *, n1: int) -> torch.Tensor:
    """rfft of real (..., N) float32 -> (..., N//2 + 1) complex64 (K2's
    complex form, the STFT's); the contract of
    ``rfft_four_step_magnitude``."""
    return _four_step(x, n1, False, rfft_four_step_complex)


rfft_four_step_magnitude.launches = 0
rfft_four_step_complex.launches = 0
