"""K7 and K8: batched rfft of real rows for N = 16384..1048576 — CUDA kernel, wrappers, plain version.

Replaces ``dsp_audio_project_tpu/kernels/rfft.py:327
rfft_pallas_four_step_tall`` (K7, N = 16384..524288) with
``rfft_four_step_tall`` and ``rfft.py:476 rfft_pallas_two_level`` (K8,
N = 1048576) with ``rfft_two_level``.  Both wrappers run one CUDA launcher
(``csrc/rfft_two_pass.cu``, ``rfft_two_pass_launch``) and each counts its
own launches: one per call of the launcher, which starts one kernel up to
N = 32768 and two above (the pair is one kernel, as the JAX K8's two
``pallas_call``s are).

The kernel is bound by bytes.  The row is packed as nh = N/2 complex
points, z[m] = x[2m] + i x[2m+1], and the packed-real untwiddle and |X|
are fused into the store.  Up to N = 32768 a row lives in one block's
shared memory and runs K2's register-radix body (``csrc/fft_radix.cuh``:
ceil(log2(nh)/4) Stockham passes of radix <= 16 in registers, one
exchange through swizzled shared memory between passes).  Above, two
passes through a global scratch B of nh complex a row, on
nh = n1 * n2 (``fft_radix.two_pass_split``, n2 = 2^floor(log2(nh)/2)):
pass 1 runs n1-point column FFTs on tiles of >= 8 consecutive columns and
fuses the twiddle W_nh^(k1 j2); pass 2 runs n2-point row FFTs on tiles of
rows k1 with their mirror rows n1 - k1, whose bins pair up under the
untwiddle, so both k-ordered stores are contiguous runs.  Twiddle tables
are fp32 built in float64 (``fft_radix.radix_tables``); the plain version
(``fft_radix.rfft_radix_plain``) runs the same packing, plan, tables and
untwiddle in torch.  Outputs: (..., N/2+1) float32 |X|
(``magnitude=True``) or complex64 X.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fft_radix import (
    ONE_PASS_MAX_N, radix_device_tables as _device_tables, rfft_radix_plain,
    two_pass_split,
)

MIN_N, MAX_N = 16384, 1048576
_LAUNCHERS = {
    "rfft_two_pass_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}


def default_n2(n: int) -> int:
    """The kernel's n2 for a real N: the row length of pass 2
    (2^floor(log2(N/2)/2)), or N/2 where one pass covers the row."""
    return n // 2 if n <= ONE_PASS_MAX_N else two_pass_split(n)[1]


def rfft_two_pass_plain(x: torch.Tensor, tw: torch.Tensor, un: torch.Tensor,
                        magnitude: bool) -> torch.Tensor:
    """Plain torch version: the kernel's one or two passes, tables and
    untwiddle.  ``x`` (rows, N) float32 -> (rows, N//2 + 1) float32 |X| or
    complex64."""
    return rfft_radix_plain(x, tw, un, magnitude)


def _launch(x, tables, b, out, n, magnitude):
    lib = _build.load("rfft_two_pass", _LAUNCHERS)
    tw, un = tables
    with torch.cuda.device(x.device):
        err = lib.rfft_two_pass_launch(
            x.data_ptr(), tw.data_ptr(), un.data_ptr(), b.data_ptr(),
            out.data_ptr(), x.shape[0], n, int(magnitude),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "rfft_two_pass_launch")


def _two_pass(x: torch.Tensor, magnitude: bool, wrapper):
    """The checks, the plain version on a CPU tensor, the kernel (counted
    once on ``wrapper``) on a CUDA tensor."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[-1]
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"needs a power-of-two N in [{MIN_N}, {MAX_N}], got {n}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    rows = x2.shape[0]
    # One block a row up to N = 32768; above, each pass takes at most
    # max(n1, n2) / 8 blocks a row.
    per_row = 1 if n <= ONE_PASS_MAX_N else max(two_pass_split(n)) // 8
    if rows * per_row >= 2**31:
        raise ValueError(f"{rows} rows exceed the grid's 2^31 - 1 blocks")
    tables = _device_tables(n, x.device)
    if x.device.type == "cpu":
        out = rfft_two_pass_plain(x2, *tables, magnitude)
    else:
        out = torch.empty((rows, n // 2 + 1), device=x.device,
                          dtype=torch.float32 if magnitude else torch.complex64)
        if rows:
            if x2.data_ptr() % 8:           # the kernel reads float2 pairs
                x2 = x2.clone()
            b = torch.empty((rows, n) if n > ONE_PASS_MAX_N else (1,),
                            dtype=torch.float32, device=x.device)
            _launch(x2, tables, b,
                    out if magnitude else torch.view_as_real(out), n,
                    magnitude)
            wrapper.launches += 1
    return out.reshape(lead + (n // 2 + 1,))


def rfft_four_step_tall(x: torch.Tensor, *,
                        magnitude: bool = False) -> torch.Tensor:
    """K7: rfft of real (..., N) float32 -> (..., N//2 + 1), N a power of
    two in 16384..1048576 (the JAX plan sends 16384..524288 here).  A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel;
    anything else raises.
    """
    return _two_pass(x, magnitude, rfft_four_step_tall)


def rfft_two_level(x: torch.Tensor, *,
                   magnitude: bool = False) -> torch.Tensor:
    """K8: the contract of ``rfft_four_step_tall`` (the JAX plan sends
    N = 1048576 here), counted separately."""
    return _two_pass(x, magnitude, rfft_two_level)


rfft_four_step_tall.launches = 0
rfft_two_level.launches = 0
