"""K2 complex, K7 and K8: the port's plain versions vs the JAX kernels and numpy.

The JAX side runs its Pallas kernels in interpret mode at HIGHEST
precision: ``rfft_pallas_four_step(magnitude=False)`` (K2),
``rfft_pallas_four_step_tall`` (K7) and ``rfft_pallas_two_level`` (K8).
Tolerances, as max abs error over max|X|: < 5e-5 against the JAX kernels
(their row-DFT tables, and K7's D1 at n1 = 1024, are bf16 hi/lo pairs,
~16 bits) and < 1e-5 against float64 ``np.fft.rfft`` (the port's fp32
radix FFT, ~2e-7).  Also: the routing plan against the JAX plan at every
power of two from 4 to 4194304, the torch butterfly and matmul forms
against the JAX ones.  The radix tables and the two-pass pairing are
tested in tests/test_torch_rfft_radix.py.  The CUDA kernels are compared with these plain
versions on the card in tests/test_torch_gpu.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.kernels import rfft as jrfft
from dsp_audio_project_tpu.ops import fft as jfft
from dsp_audio_project_tpu_torch.kernels.rfft import rfft_four_step_complex
from dsp_audio_project_tpu_torch.kernels.rfft_two_pass import (
    rfft_four_step_tall, rfft_two_level,
)
from dsp_audio_project_tpu_torch.ops import fft as tfft

torch.set_num_threads(2)
HI = jax.lax.Precision.HIGHEST


def rows(r, n, seed=0):
    return np.random.default_rng(seed).standard_normal((r, n)).astype(
        np.float32)


def rel_err(want, got) -> float:
    want = np.asarray(want)
    return float(np.abs(want - np.asarray(got)).max() / np.abs(want).max())


def exact(x):
    return np.fft.rfft(x.astype(np.float64))


def test_k2_complex_matches_jax_kernel():
    x = rows(3, 2048, seed=1)
    want = jrfft.rfft_pallas_four_step(jnp.asarray(x), n1=16, magnitude=False,
                                       precision=HI, interpret=True)
    got = rfft_four_step_complex(torch.as_tensor(x), n1=16)
    assert got.dtype == torch.complex64 and got.shape == (3, 1025)
    assert rel_err(want, got.numpy()) < 5e-5
    assert rel_err(exact(x), got.numpy()) < 1e-5


@pytest.mark.parametrize("n,r,n2", [(16384, 2, 128), (524288, 1, 512)])
def test_k7_plain_matches_jax_kernel(n, r, n2):
    # n2 is the JAX plan's split; at 524288 its D1 is the bf16-pair form.
    x = rows(r, n, seed=n)
    want = jrfft.rfft_pallas_four_step_tall(
        jnp.asarray(x), n2=n2, row_tile=8, magnitude=False, precision=HI,
        interpret=True)
    got = rfft_four_step_tall(torch.as_tensor(x))
    assert got.dtype == torch.complex64 and got.shape == (r, n // 2 + 1)
    assert rel_err(want, got.numpy()) < 5e-5
    assert rel_err(exact(x), got.numpy()) < 1e-5
    mag = rfft_four_step_tall(torch.as_tensor(x), magnitude=True)
    assert torch.allclose(mag, got.abs(), rtol=1e-6, atol=1e-6 * float(mag.max()))


def test_k8_plain_matches_jax_kernel():
    n = 262144      # the smallest size K8 tiles (JAX n2 = 512)
    x = rows(1, n, seed=3)
    want = jrfft.rfft_pallas_two_level(jnp.asarray(x), n2=512,
                                       magnitude=True, precision=HI,
                                       interpret=True)
    got = rfft_two_level(torch.as_tensor(x), magnitude=True)
    assert got.dtype == torch.float32 and got.shape == (1, n // 2 + 1)
    assert rel_err(want, got.numpy()) < 5e-5
    assert rel_err(np.abs(exact(x)), got.numpy()) < 1e-5
    z = rfft_two_level(torch.as_tensor(x))
    assert rel_err(exact(x), z.numpy()) < 1e-5


def test_plan_kinds_match_jax():
    for b in range(2, 23):
        n = 1 << b
        want = jfft._rfft_kernel_plan(n)
        got = tfft._rfft_kernel_plan(n)
        assert (want is None) == (got is None), n
        if want is not None:
            assert got[0] == want[0], n
            assert got == (want if want[0] == "four_step" else (want[0],))
    for n in (3000, 16383, 0):
        assert tfft._rfft_kernel_plan(n) is None


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_butterfly_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)).astype(np.float32)
    z = (x + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    tol = 1e-6 * max(1, n)
    for jf, tf, a in ((jfft.fft, tfft.fft, z), (jfft.ifft, tfft.ifft, z),
                      (jfft.rfft, tfft.rfft, x)):
        want = np.asarray(jax.jit(jf)(jnp.asarray(a)))
        got = tf(torch.as_tensor(a)).numpy()
        assert got.dtype == np.complex64 and got.shape == want.shape
        assert np.abs(want - got).max() < tol
    if n >= 8:
        for jf, tf, a in ((jfft.fft_four_step, tfft.fft_four_step, z),
                          (lambda v: jfft.rfft_matmul(v, n1=4),
                           lambda v: tfft.rfft_matmul(v, n1=4), x)):
            want = np.asarray(jax.jit(jf)(jnp.asarray(a)))
            got = tf(torch.as_tensor(a)).numpy()
            assert got.shape == want.shape
            assert np.abs(want - got).max() < tol


def test_rfft_magnitude_engines():
    x = rows(2, 16384, seed=5)
    want = np.abs(exact(x))
    for engine in ("auto", "pallas", "jnp"):
        got = tfft.rfft_magnitude(torch.as_tensor(x), engine=engine,
                                  fast=False)
        assert rel_err(want, got.numpy()) < 1e-5, engine
    with pytest.raises(ValueError, match="engine='pallas'"):
        tfft.rfft_magnitude(torch.zeros(2, 128), engine="pallas")
    # An unplanned size runs the butterfly, as on the JAX side.
    x = rows(2, 128, seed=6)
    assert rel_err(np.abs(exact(x)), tfft.rfft_magnitude(
        torch.as_tensor(x)).numpy()) < 1e-5


def test_two_pass_wrapper_rejects_bad_input():
    with pytest.raises(TypeError):
        rfft_four_step_tall(torch.zeros(2, 16384, dtype=torch.float64))
    with pytest.raises(ValueError):
        rfft_four_step_tall(torch.zeros(16384, 2).t())
    with pytest.raises(ValueError):
        rfft_four_step_tall(torch.zeros(2, 8192))
    assert rfft_two_level(torch.zeros(0, 16384)).shape == (0, 8193)
