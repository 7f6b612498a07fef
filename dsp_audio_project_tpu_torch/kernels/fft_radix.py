"""The register-radix rfft of ``csrc/fft_radix.cuh`` in plain torch.

K2 (``kernels/rfft.py``) and K7/K8 (``kernels/rfft_two_pass.py``) run their
plain versions through this module, on the kernels' own factorisation, so
that the CPU tests exercise the index plan the CUDA kernels use and the
card compares kernel with plain like for like:

- the real row of N points is packed as nh = N/2 complex points,
  z[m] = x[2m] + i x[2m+1];
- an nh-point FFT is ``radix_plan(log2 nh)``: ceil(log2(nh)/4) Stockham
  passes of radix <= 16, butterfly j of a pass with span NS reading
  z[j + r nh/R], twiddled by W_{NS R}^{r (j mod NS)} from the table of
  W_nh^m and written to (j // NS) NS R + r NS + j mod NS; each R-point DFT
  is log2 R radix-2 stages on the constants W_16^q;
- above N = 32768, nh = n1 n2 (``two_pass_split``): n1-point column FFTs,
  the twiddle W_nh^(k1 j2) (``pass1_twiddle``), n2-point row FFTs;
- the packed-real untwiddle of each pair (k, nh - k), k <= nh/2 (the
  second table, W_N^k).

Tables are float64 on the host, cast once to complex64.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import device_tables

ONE_PASS_MAX_N = 32768    # the largest N whose row fits one block's shared memory


def radix_plan(log2_n: int) -> list[int]:
    """Bits of each pass's radix for a 2^log2_n-point FFT: ceil(log2_n / 4)
    passes, the bits spread as evenly as they go (first passes larger)."""
    p = (log2_n + 3) // 4
    return [log2_n // p + (1 if i < log2_n % p else 0) for i in range(p)]


def two_pass_split(n: int) -> tuple[int, int]:
    """(n1, n2) of the two-pass kernel for a real N: nh = N/2 = n1 n2 with
    n2 = 2^floor(log2(nh)/2), the row length of pass 2."""
    log2_nh = (n // 2).bit_length() - 1
    n2 = 1 << (log2_nh // 2)
    return n // 2 // n2, n2


@functools.lru_cache(maxsize=None)
def radix_tables(n: int):
    """(tw, un) complex64 for a real N: tw = W_nh^m for m < nh = N/2, un =
    W_N^k = e^{-2 pi i k / N} for k <= nh/2, built in float64."""
    nh = n // 2
    tw = np.exp(-2j * np.pi * np.arange(nh) / nh)
    un = np.exp(-2j * np.pi * np.arange(nh // 2 + 1) / n)
    return tw.astype(np.complex64), un.astype(np.complex64)


def radix_device_tables(n: int, device: torch.device):
    """``radix_tables(n)`` as complex64 tensors on ``device`` (cached)."""
    return device_tables(radix_tables, n, device=device)


_W16 = torch.as_tensor(np.exp(-2j * np.pi * np.arange(8) / 16).astype(np.complex64))


def _bit_reverse(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _dft_small(v: torch.Tensor, r: int) -> torch.Tensor:
    """The kernel's in-register R-point DFT along dim -2 of (..., R, T)."""
    bits = r.bit_length() - 1
    lead, t = v.shape[:-2], v.shape[-1]
    v = v[..., [_bit_reverse(i, bits) for i in range(r)], :]
    for st in range(bits):
        h = 1 << st
        v = v.reshape(*lead, r // (2 * h), 2, h, t)
        a, c = v[..., 0, :, :], v[..., 1, :, :]
        w = _W16[torch.arange(h) * (8 >> st)].to(v.device)
        c = c * w[:, None]
        v = torch.stack([a + c, a - c], dim=-3).reshape(*lead, r, t)
    return v


def stockham(z: torch.Tensor, tw: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """FFT of complex64 (..., n) along the last axis by the radix plan;
    ``tw`` is W_M^m with M = n * stride (a sub-FFT reads every stride-th
    entry)."""
    n = z.shape[-1]
    lead = z.shape[:-1]
    ns = 1
    for bits in radix_plan(n.bit_length() - 1):
        r = 1 << bits
        t = n // r
        v = z.reshape(*lead, r, t)                 # v[r, j] = z[j + r t]
        if ns > 1:
            k = torch.arange(t, device=z.device) % ns
            idx = torch.arange(r, device=z.device)[:, None] * k * (n // (ns * r))
            v = v * tw[idx * stride]
        v = _dft_small(v, r)
        # Output r of butterfly j goes to (j // ns) ns r + r ns + j % ns.
        v = v.reshape(*lead, r, t // ns, ns).transpose(-3, -2)
        z = v.reshape(*lead, n)
        ns *= r
    return z


def pass1_twiddle(tw: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """W_nh^m (m < nh) as the two-pass kernel forms it: one table entry up
    to nh = 1024, else W^(m mod 1024) W^(m - m mod 1024)."""
    if tw.shape[0] <= 1024:
        return tw[m]
    return tw[m & 1023] * tw[m & ~1023]


def two_pass_fft(z: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """nh-point FFT of complex64 (rows, nh) as the two-pass kernel runs it:
    Z[k1 + n1 k2] from column FFTs, the twiddle and row FFTs."""
    rows, nh = z.shape
    n1, n2 = two_pass_split(2 * nh)
    a = stockham(z.reshape(rows, n1, n2).transpose(1, 2), tw, n2)  # [j2][k1]
    m = (torch.arange(n2, device=z.device)[:, None]
         * torch.arange(n1, device=z.device))
    b = (a * pass1_twiddle(tw, m)).transpose(1, 2)                  # [k1][j2]
    return stockham(b, tw, n1).transpose(1, 2).reshape(rows, nh)


def untwiddle(z: torch.Tensor, un: torch.Tensor,
              magnitude: bool) -> torch.Tensor:
    """X (rows, nh + 1) from the packed FFT Z (rows, nh): each pair
    (k, nh - k), k <= nh/2, from Z[k] and Z[nh - k]; |X| (float32) or X."""
    nh = z.shape[-1]
    h = nh // 2
    k = torch.arange(h + 1, device=z.device)
    a, b = z[..., : h + 1], z[..., (nh - k) % nh]
    er = 0.5 * (a.real + b.real)
    ei = 0.5 * (a.imag - b.imag)
    wo = un * torch.complex(0.5 * (a.imag + b.imag), -0.5 * (a.real - b.real))
    re = torch.cat([er + wo.real, (er - wo.real)[..., :h].flip(-1)], dim=-1)
    im = torch.cat([ei + wo.imag, (wo.imag - ei)[..., :h].flip(-1)], dim=-1)
    # hypot, not sqrt(re^2 + im^2): torch's CPU sqrt kernel can return
    # ~2e-4-relative values on its first multithreaded call in a process
    # (ROADMAP Queue 3).
    return torch.hypot(re, im) if magnitude else torch.complex(re, im)


def rfft_radix_plain(x: torch.Tensor, tw: torch.Tensor, un: torch.Tensor,
                     magnitude: bool) -> torch.Tensor:
    """rfft of real float32 (rows, N) as the kernels compute it: one pass
    up to N = 32768, two passes above; (rows, N/2 + 1) |X| or complex64."""
    n = x.shape[-1]
    z = torch.complex(x[..., 0::2], x[..., 1::2])
    z = stockham(z, tw) if n <= ONE_PASS_MAX_N else two_pass_fft(z, tw)
    return untwiddle(z, un, magnitude)
