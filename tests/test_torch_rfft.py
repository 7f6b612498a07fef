"""K2, the four-step |rfft|: the port's plain version vs the JAX kernel and numpy.

The JAX side is rfft_pallas_four_step(magnitude=True) in interpret mode at
HIGHEST precision.  Tolerance > 110 dB: both sides are float32, the JAX one
direct sums over DFT tables, the port's a radix FFT (~1e-6 relative worst
case on small bins).  Against np.fft.rfft (float64) at every power of two the port
covers (256..8192): also > 110 dB.  The spectrum op (segment choice,
symmetric Hann window, |rfft|) against the JAX package's at the three
segment rules (centre window, short-tail corner, zero-padded short signal):
same > 110 dB bound, same reason.  The radix plan and tables themselves are
tested in tests/test_torch_rfft_radix.py; the CUDA kernel is compared with
the plain version on the card in tests/test_torch_gpu.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.kernels import rfft as jrfft
from dsp_audio_project_tpu.ops import spectrum as jspectrum
from dsp_audio_project_tpu_torch.kernels.rfft import rfft_four_step_magnitude
from dsp_audio_project_tpu_torch.ops.fft import (
    _four_step_kernel_n1, _rfft_kernel_plan, rfft_magnitude,
)
from dsp_audio_project_tpu_torch.ops import spectrum as tspectrum
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

SIZES = [256, 512, 1024, 2048, 4096, 8192]


def rows(r, n, seed=0):
    rng = np.random.default_rng(seed)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return (rng.standard_normal((r, n)) * hann).astype(np.float32)


def test_plain_matches_jax_kernel():
    x = rows(6, 2048)
    want = jrfft.rfft_pallas_four_step(
        jnp.asarray(x), n1=16, magnitude=True,
        precision=jax.lax.Precision.HIGHEST, interpret=True,
    )
    got = rfft_four_step_magnitude(torch.as_tensor(x), n1=16)
    assert got.shape == (6, 1025)
    snr = snr_db(np.asarray(want).ravel(), got.numpy().ravel())
    exact = np.abs(np.fft.rfft(x.astype(np.float64))).ravel()
    assert snr > 110, (
        f"{snr:.1f} dB; vs float64 numpy: JAX "
        f"{snr_db(exact, np.asarray(want).ravel()):.1f} dB, port "
        f"{snr_db(exact, got.numpy().ravel()):.1f} dB")


@pytest.mark.parametrize("n", SIZES)
def test_magnitude_matches_numpy(n):
    x = rows(3, n, seed=n)
    got = rfft_magnitude(torch.as_tensor(x))
    assert _rfft_kernel_plan(n) == ("four_step", min(32, n // 128))
    want = np.abs(np.fft.rfft(x.astype(np.float64)))
    assert got.shape == want.shape
    assert snr_db(want.ravel(), got.numpy().ravel()) > 110


def test_batched_leading_dims():
    x = rows(6, 2048, seed=9).reshape(3, 2, 2048)
    got = rfft_magnitude(torch.as_tensor(x))
    assert got.shape == (3, 2, 1025)
    flat = rfft_magnitude(torch.as_tensor(x.reshape(6, 2048)))
    assert torch.equal(got.reshape(6, 1025), flat)


@pytest.mark.parametrize("n", [100, 2047, 3000, 0])
def test_non_power_of_two_raises(n):
    with pytest.raises(ValueError):
        rfft_magnitude(torch.zeros(2, n))


@pytest.mark.parametrize("n", [128, 16384])
def test_outside_kernel_range(n):
    # A CPU tensor takes the plan's plain version (K7 at 16384) or the
    # torch butterfly (128); the K2 wrapper itself refuses both sizes.
    x = rows(2, n, seed=1)
    got = rfft_magnitude(torch.as_tensor(x))
    want = np.abs(np.fft.rfft(x.astype(np.float64)))
    assert snr_db(want.ravel(), got.numpy().ravel()) > 110
    with pytest.raises(ValueError):
        rfft_four_step_magnitude(torch.as_tensor(x), n1=16)


def test_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        rfft_four_step_magnitude(torch.zeros(2, 2048, dtype=torch.float64),
                                 n1=16)
    with pytest.raises(ValueError):
        rfft_four_step_magnitude(torch.zeros(2048, 2).t(), n1=16)
    with pytest.raises(ValueError):
        rfft_four_step_magnitude(torch.zeros(2, 2048), n1=3)


@pytest.mark.parametrize("n", [44100, 3000, 1000])
def test_magnitude_spectrum_matches_jax(n):
    # 44100: centre window of nfft; 3000: nfft < n < mid + nfft, the
    # windowed tail zero-padded; 1000: zero-pad to the next power of two.
    x = rows(2, n, seed=n)
    fj, mj = jspectrum.magnitude_spectrum(jnp.asarray(x), 44100)
    ft, mt = tspectrum.magnitude_spectrum(torch.as_tensor(x), 44100)
    assert np.array_equal(np.asarray(fj), ft)
    assert mt.shape == mj.shape
    assert snr_db(np.asarray(mj).ravel(), mt.numpy().ravel()) > 110
    assert np.array_equal(tspectrum.spectrum_freqs(n, 44100), ft)
