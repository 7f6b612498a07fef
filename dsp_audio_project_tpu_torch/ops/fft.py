"""Batched FFTs over the last axis, and the rfft routing to the kernels.

Counterpart of ``dsp_audio_project_tpu/ops/fft.py``.  The torch ops: the
radix-2 butterfly (``fft``, ``ifft``, ``rfft`` with the packed-real
untwiddle: a bit-reversal gather, then log2(N) vectorized stages) and the
matmul forms (``fft_four_step``, ``rfft_matmul``).  The routing:
``_rfft_kernel_plan`` sends every power of two from 256 to 1048576 to a
ported kernel, as the JAX plan sends it to a Pallas kernel — K2
(``kernels/rfft.py``) for 256..8192, K7 (``'tall'``) for 16384..524288,
K8 (``'two_level'``) for 1048576, the last two on the port's own
register-radix plan (``kernels/rfft_two_pass.py``).  A planned size on a CUDA tensor
launches its kernel and never falls back; on a CPU tensor the kernel's
wrapper runs its plain version.  Other sizes run the torch butterfly, as
the JAX package runs its XLA butterfly there.  Sizes must be powers of two,
as the reference's FFT demands (ARCHITECTURE C2).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.rfft import rfft_four_step_complex, rfft_four_step_magnitude
from ..kernels.rfft_two_pass import rfft_four_step_tall, rfft_two_level
from ..utils.device import device_tables


def _check_pow2(n: int) -> int:
    if n <= 0 or (n & (n - 1)) != 0:
        raise ValueError(f"FFT size must be a power of two, got {n}")
    return int(np.log2(n))


@functools.lru_cache(maxsize=None)
def _bit_reversal(n: int) -> np.ndarray:
    bits = _check_pow2(n)
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx >>= 1
    return rev.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(half: int) -> np.ndarray:
    # e^{-j pi k / half}, k < half: stage with butterfly span `half`.
    k = np.arange(half)
    return np.exp(-1j * np.pi * k / half).astype(np.complex64)


def fft(x: torch.Tensor) -> torch.Tensor:
    """Complex FFT over the last axis (power-of-two length), batched."""
    n = x.shape[-1]
    _check_pow2(n)
    rev = device_tables(_bit_reversal, n, device=x.device)
    y = x.to(torch.complex64).index_select(-1, rev)
    half = 1
    while half < n:
        y = y.reshape(y.shape[:-1] + (n // (2 * half), 2, half))
        a = y[..., 0, :]
        t = y[..., 1, :] * device_tables(_stage_twiddles, half, device=x.device)
        y = torch.cat([a + t, a - t], dim=-1)
        y = y.reshape(y.shape[:-2] + (n,))
        half *= 2
    return y


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Inverse complex FFT over the last axis (power-of-two length)."""
    n = x.shape[-1]
    return torch.conj(fft(torch.conj(x.to(torch.complex64)))) / n


@functools.lru_cache(maxsize=None)
def _dft_matrix(m: int) -> np.ndarray:
    jk = np.outer(np.arange(m), np.arange(m))
    return np.exp(-2j * np.pi * jk / m).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _four_step_twiddle(n1: int, n2: int) -> np.ndarray:
    # W_n^{k1 j2} applied between the column and row DFTs.
    k1j2 = np.outer(np.arange(n1), np.arange(n2))
    return np.exp(-2j * np.pi * k1j2 / (n1 * n2)).astype(np.complex64)


def fft_four_step(x: torch.Tensor, n1: int | None = None) -> torch.Tensor:
    """Complex FFT via the four-step (Bailey) factorization, as matmuls.

    With n = n1*n2, j = j1*n2 + j2, k = k1 + n1*k2:

        X[k1 + n1 k2] = sum_j2 W_n2^{j2 k2} (W_n^{j2 k1}
                        * sum_j1 Z[j1, j2] W_n1^{j1 k1})

    i.e. DFT the columns (one (n1, n1) matmul), twiddle, DFT the rows (one
    (n2, n2) matmul), transpose.  Default split n2 = 128, as in the JAX
    package.  Matches ``fft`` to float32 rounding.
    """
    n = x.shape[-1]
    _check_pow2(n)
    if n1 is None:
        n1 = max(2, n // 128)
    n2 = n // n1
    if n1 < 2 or n2 < 2 or n1 * n2 != n:
        return fft(x)
    lead = x.shape[:-1]
    dev = x.device
    z2 = x.to(torch.complex64).reshape(lead + (n1, n2))
    a = device_tables(_dft_matrix, n1, device=dev) @ z2
    a = a * device_tables(_four_step_twiddle, n1, n2, device=dev)
    b = a @ device_tables(_dft_matrix, n2, device=dev)
    return b.transpose(-1, -2).reshape(lead + (n,))


@functools.lru_cache(maxsize=None)
def _rfft_matmul_tables(n: int, n1: int):
    """Host tables for the direct-real four-step rfft (see rfft_matmul)."""
    n2 = n // n1
    k2max = n // (2 * n1) + 1            # k2 range covering bins 0..n/2
    d1 = np.outer(np.arange(n1), np.arange(n1))
    d1 = np.exp(-2j * np.pi * d1 / n1)
    tw = np.outer(np.arange(n1), np.arange(n2))
    tw = np.exp(-2j * np.pi * tw / n)    # W_n^{k1 j2}
    d2 = np.outer(np.arange(n2), np.arange(k2max))
    d2 = np.exp(-2j * np.pi * d2 / n2)   # W_n2^{j2 k2}, half-spectrum columns
    f32 = np.float32
    return (
        d1.real.astype(f32), d1.imag.astype(f32),
        tw.real.astype(f32), tw.imag.astype(f32),
        d2.real.astype(f32), d2.imag.astype(f32),
        k2max,
    )


def rfft_matmul(x: torch.Tensor, n1: int = 16) -> torch.Tensor:
    """Real-input FFT via a direct-real four-step factorization, as matmuls.

    The first DFT contracts the real input directly (two real matmuls) and
    only the k2 <= n/(2*n1) half of the output grid is computed: conjugate
    symmetry by construction.  Bins 0..n//2; matches ``rfft`` to float32
    rounding.
    """
    n = x.shape[-1]
    _check_pow2(n)
    n2 = n // n1
    if n1 < 2 or n2 < 2 or n1 * n2 != n:
        return rfft(x)
    lead = x.shape[:-1]
    *tables, k2max = _rfft_matmul_tables(n, n1)
    d1r, d1i, twr, twi, d2r, d2i = (torch.as_tensor(t, device=x.device)
                                    for t in tables)
    x2 = x.to(torch.float32).reshape(lead + (n1, n2))
    # Step 1: A[k1, j2] = sum_j1 x[j1*n2 + j2] W_n1^{j1 k1}  (real input).
    ar = d1r @ x2
    ai = d1i @ x2
    # Step 2: twiddle by W_n^{k1 j2}.
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # Step 3: row DFT over j2, half-spectrum columns only.
    cr = br @ d2r - bi @ d2i
    ci = br @ d2i + bi @ d2r
    # Step 4: X[k1 + n1 k2] — interleave and crop to the n//2+1 real bins.
    out = torch.complex(cr.transpose(-1, -2), ci.transpose(-1, -2))
    return out.reshape(lead + (n1 * k2max,))[..., : n // 2 + 1]


@functools.lru_cache(maxsize=None)
def _rfft_untwiddle(n: int) -> np.ndarray:
    # e^{-2j pi k / n} for k = 0..n/2 (bin count of the real spectrum).
    k = np.arange(n // 2 + 1)
    return np.exp(-2j * np.pi * k / n).astype(np.complex64)


def rfft(x: torch.Tensor) -> torch.Tensor:
    """Real-input FFT over the last axis; returns the first N//2+1 bins.

    Packs even/odd real samples into one complex sequence of length N/2,
    runs a half-size complex FFT, and untwiddles (the conjugate symmetry
    the reference notes at dsp_core.py:96-98).
    """
    n = x.shape[-1]
    _check_pow2(n)
    if n == 1:
        return x.to(torch.complex64)
    xr = x.to(torch.float32)
    zf = fft(torch.complex(xr[..., 0::2], xr[..., 1::2]))   # (..., n/2)
    # Z[k] for k = 0..n/2 with wraparound (Z[n/2] == Z[0]).
    zk = torch.cat([zf, zf[..., :1]], dim=-1)
    zrev = torch.conj(zk.flip(-1))      # conj(Z[n/2 - k])
    even = 0.5 * (zk + zrev)
    odd = -0.5j * (zk - zrev)
    return even + device_tables(_rfft_untwiddle, n, device=x.device) * odd


def _four_step_kernel_n1(n: int) -> int | None:
    """n1 split for the four-step kernel K2, or None outside 256..8192.

    n1 = min(32, n/128), as in the JAX package, so the DFT tables match.
    """
    if n < 256 or n > 8192 or (n & (n - 1)) != 0:
        return None
    return min(32, n // 128)


def _rfft_kernel_plan(n: int):
    """The kernel a batched-rfft size routes to: ('four_step', n1) for
    256..8192, ('tall',) for 16384..524288, ('two_level',) for 1048576,
    else None — the JAX plan's kinds and ranges.  The last two take no
    split: their wrappers use the port's own plan."""
    n1 = _four_step_kernel_n1(n)
    if n1 is not None:
        return ("four_step", n1)
    if n < 16384 or n > 1048576 or (n & (n - 1)) != 0:
        return None
    return ("two_level",) if n == 1048576 else ("tall",)


def _rfft_kernel_dispatch(x: torch.Tensor, plan,
                          magnitude: bool) -> torch.Tensor:
    """Run ``plan``'s kernel on float32 (..., N) rows: |X| or complex X."""
    kind = plan[0]
    if kind == "four_step":
        wrapper = (rfft_four_step_magnitude if magnitude
                   else rfft_four_step_complex)
        return wrapper(x, n1=plan[1])
    wrapper = rfft_two_level if kind == "two_level" else rfft_four_step_tall
    return wrapper(x, magnitude=magnitude)


def rfft_magnitude(x: torch.Tensor, engine: str = "auto",
                   fast: bool = True) -> torch.Tensor:
    """|rfft(x)| over the last axis: (..., N) -> (..., N//2 + 1) float32.

    ``engine``: 'auto' runs the planned kernel (256 <= N <= 1048576) on a
    CUDA tensor, or its plain version on a CPU tensor, and the torch
    butterfly for other sizes; 'jnp' forces the butterfly (the JAX name);
    'pallas' forces the kernel, raising ValueError for unplanned sizes.
    ``fast`` is accepted and ignored: the port is fp32 throughout.
    """
    n = x.shape[-1]
    _check_pow2(n)
    plan = _rfft_kernel_plan(n)
    if engine == "pallas" and plan is None:
        raise ValueError(
            f"engine='pallas' requires a power-of-two N in [256, 1048576], "
            f"got {n}"
        )
    x = x.to(torch.float32).contiguous()
    if engine == "pallas" or (engine == "auto" and plan is not None):
        return _rfft_kernel_dispatch(x, plan, True)
    return rfft(x).abs()
