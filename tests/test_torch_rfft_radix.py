"""The register-radix rfft plan of K2, K7 and K8 (``kernels/fft_radix.py``).

The plain versions run the CUDA kernels' own factorisation: packed real
input, Stockham passes of radix <= 16 on fp32 tables built in float64, two
passes through B above N = 32768, the packed-real untwiddle by pairs.
Here, at 1-2 rows a size: the plain rfft against float64 ``np.fft.rfft``
at every power of two from 256 to 1048576 (max abs error < 1e-5 * max|X|,
SNR > 110 dB: fp32 butterflies, ~2e-7 measured); the tables against
float64; the radix plan; the two-pass split, the mirror pairing of pass 2
(every bin written once) and the DC / Nyquist bins; and the build cache
key, which must follow the shared header.  The kernels themselves are
compared with these plain versions on the card (tests/test_torch_gpu.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from dsp_audio_project_tpu_torch.kernels import _build
from dsp_audio_project_tpu_torch.kernels import fft_radix as fr
from dsp_audio_project_tpu_torch.kernels.rfft import rfft_four_step_complex
from dsp_audio_project_tpu_torch.kernels.rfft_two_pass import (
    default_n2, rfft_four_step_tall, rfft_two_level,
)

torch.set_num_threads(2)

TWO_PASS = [65536, 131072, 262144, 524288, 1048576]


def rows(r, n, seed=0):
    return np.random.default_rng(seed).standard_normal((r, n)).astype(
        np.float32)


def tables(n):
    return tuple(torch.as_tensor(t) for t in fr.radix_tables(n))


@pytest.mark.parametrize("n", [1 << b for b in range(8, 21)])
def test_plain_matches_float64(n):
    x = rows(1 if n > 65536 else 2, n, seed=n)
    got = fr.rfft_radix_plain(torch.as_tensor(x), *tables(n), False).numpy()
    want = np.fft.rfft(x.astype(np.float64))
    assert got.dtype == np.complex64 and got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    snr = 10 * np.log10((np.abs(want) ** 2).sum()
                        / (np.abs(got - want) ** 2).sum())
    assert err < 1e-5 and snr > 110, (err, snr)
    mag = fr.rfft_radix_plain(torch.as_tensor(x), *tables(n), True).numpy()
    assert np.abs(mag - np.abs(want)).max() < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", [256, 2048, 32768, 1048576])
def test_tables_match_float64(n):
    tw, un = fr.radix_tables(n)
    nh = n // 2
    assert tw.dtype == un.dtype == np.complex64
    assert tw.shape == (nh,) and un.shape == (nh // 2 + 1,)
    want_tw = np.exp(-2j * np.pi * np.arange(nh) / nh)
    want_un = np.exp(-2j * np.pi * np.arange(nh // 2 + 1) / n)
    # Each entry is float64 rounded once to fp32: within half an ulp of 1.
    assert np.abs(tw - want_tw).max() <= 2.0 ** -24 * np.sqrt(2)
    assert np.abs(un - want_un).max() <= 2.0 ** -24 * np.sqrt(2)
    assert np.array_equal(tw, want_tw.astype(np.complex64))
    assert np.array_equal(un, want_un.astype(np.complex64))
    # The in-register DFT constants W_16^q, as the kernel spells them.
    assert np.array_equal(fr._W16.numpy(), np.exp(
        -2j * np.pi * np.arange(8) / 16).astype(np.complex64))


def test_radix_plan():
    for b in range(2, 21):
        plan = fr.radix_plan(b)
        assert sum(plan) == b and len(plan) == -(-b // 4), b
        assert max(plan) <= 4 and max(plan) - min(plan) <= 1, b
        assert plan == sorted(plan, reverse=True), b
    assert fr.radix_plan(10) == [4, 3, 3]        # 1024 = 16 * 8 * 8
    assert fr.radix_plan(12) == [4, 4, 4]        # 4096 = 16 * 16 * 16


@pytest.mark.parametrize("n,stride", [(256, 1), (64, 8), (1024, 512)])
def test_stockham_sub_fft(n, stride):
    """An n-point FFT on every stride-th entry of a larger W table, as the
    two-pass kernel runs its column and row FFTs."""
    rng = np.random.default_rng(n)
    z = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n)))
    tw = torch.as_tensor(fr.radix_tables(2 * n * stride)[0])
    got = fr.stockham(torch.as_tensor(z.astype(np.complex64)), tw, stride)
    want = np.fft.fft(z)
    assert np.abs(got.numpy() - want).max() < 1e-5 * np.abs(want).max()


def pass2_writes(n):
    """Bins written by the two-pass kernel's pass 2 (csrc/rfft_two_pass.cu
    two_pass_rows): tiles of G rows k1 with their mirror rows, row n1/2 in
    tile 0; each pair (k, nh - k) from its canonical side."""
    n1, n2 = fr.two_pass_split(n)
    nh = n1 * n2
    g_rows = max(8, 2048 // n2)
    count = np.zeros(nh + 1, dtype=np.int64)
    pairs = []

    def put(k, row_a, col_a, row_b, col_b):
        kk = min(k, nh - k)
        count[kk] += 1
        if kk != nh // 2:
            count[nh - kk] += 1
        pairs.append((k, row_a + n1 * col_a, row_b + n1 * col_b))

    for p in range(n1 // (2 * g_rows)):
        for g in range(g_rows):
            k1 = p * g_rows + g
            for k2 in range(n2):
                k = k1 + n1 * k2
                if k1 == 0:
                    if k <= nh // 2:
                        put(k, 0, k2, 0, (n2 - k2) % n2)
                else:
                    put(k, k1, k2, n1 - k1, n2 - 1 - k2)
        if p == 0:
            for k2 in range(n2 // 2):
                put(n1 // 2 + n1 * k2, n1 // 2, k2, n1 // 2, n2 - 1 - k2)
    return n1, n2, count, pairs


@pytest.mark.parametrize("n", TWO_PASS)
def test_two_pass_mirror_pairing(n):
    n1, n2, count, pairs = pass2_writes(n)
    nh = n // 2
    assert n1 * n2 == nh and n1 >= n2 and n1 <= 1024 and n2 <= 512
    assert default_n2(n) == n2
    assert np.all(count == 1)                   # every bin X[0..nh] once
    for k, za, zb in pairs:                     # Z[k] meets Z[nh - k]
        assert za == k and zb == (nh - k) % nh


def test_split_and_dc_nyquist_bins():
    assert [default_n2(n) for n in (16384, 32768, 65536, 1048576)] == [
        8192, 16384, 128, 512]
    for n in (2048, 32768, 65536, 1048576):
        x = rows(1, n, seed=7)
        got = fr.rfft_radix_plain(torch.as_tensor(x), *tables(n), False)
        got = got.numpy()[0]
        xd = x[0].astype(np.float64)
        top = np.abs(xd).sum()
        # X[0] from Z[0]'s real + imaginary parts, X[N/2] from their
        # difference (the pair k = 0, nh): both real.
        assert abs(got[0].real - xd.sum()) < 1e-6 * top
        assert abs(got[-1].real - (xd[0::2].sum() - xd[1::2].sum())) < 1e-6 * top
        assert got[0].imag == 0.0 and got[-1].imag == 0.0


def test_wrappers_run_the_plain_plan_on_cpu():
    x = rows(2, 2048, seed=3)
    want = fr.rfft_radix_plain(torch.as_tensor(x), *tables(2048), False)
    assert torch.equal(rfft_four_step_complex(torch.as_tensor(x), n1=16), want)
    for n, wrapper in ((16384, rfft_four_step_tall), (65536, rfft_two_level)):
        x = rows(1, n, seed=n)
        want = fr.rfft_radix_plain(torch.as_tensor(x), *tables(n), True)
        assert torch.equal(wrapper(torch.as_tensor(x), magnitude=True), want)
    with pytest.raises(ValueError):
        rfft_four_step_tall(torch.zeros(1, 2 * 1048576))


def test_build_key_follows_the_headers(tmp_path, monkeypatch):
    """An edited shared header changes every library's path, so a stale
    .so is never loaded (no nvcc needed)."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build.library_path("k") not in (first, second)
