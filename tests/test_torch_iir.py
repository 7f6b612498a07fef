"""E2a/E2b (the block-IIR kernels), ``equalize_pallas`` and the
``iir_path='pallas'`` pipeline: the port vs the JAX package and the oracle.

CPU, the kernels' plain versions; the JAX side runs its Pallas kernels in
interpret mode, as tests/test_kernels.py does.  Tolerances:

* end states within atol 2e-5 of the JAX kernel's (the bound the JAX test
  holds its kernel to against its scan: float32 sums of <= 256 steps in
  another order);
* outputs >= 100 dB against the JAX kernels, ``equalize_pallas`` and the
  JAX pipeline (float32 on both sides, the same operators; ~130 dB here);
* >= 60 dB against the numpy oracle (the reference contract, as the JAX
  test gates its kernels).

The CUDA kernels are compared with these plain versions on the card in
tests/test_torch_gpu.py and chip_smoke.py.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu.kernels.experiments.iir import (
    block_apply as jblock_apply,
    block_end_states as jblock_end_states,
)
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu_torch import oracle
from dsp_audio_project_tpu_torch.kernels import (
    launch_counts, reset_launch_counts,
)
from dsp_audio_project_tpu_torch.kernels.experiments.iir import (
    block_apply, block_end_states,
)
from dsp_audio_project_tpu_torch.ops import eq as teq
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def signal(n, seed, rows=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    shape = (n,) if rows is None else (rows, n)
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal(shape)
    return (x / np.abs(x).max()).astype(np.float32)


def operators(gains, block):
    cfg = pt.EQConfig.from_gains(gains)
    bands = cfg.active_bands(FS)
    return (jeq.make_block_operators(bands, FS, cfg.q, block),
            teq.make_block_operators(bands, FS, cfg.q, block), cfg)


def test_block_kernels_match_jax_and_oracle():
    """Block 256, 16384 samples (the JAX kernel test's shape)."""
    block = 256
    jops, tops, cfg = operators({"Sub-Bass": 6, "Bass": -3, "High Mids": 12},
                                block)
    x = signal(16384, seed=5)
    xb = x.reshape(1, -1, block)
    e_j = np.asarray(jblock_end_states(jnp.asarray(xb), jops, interpret=True))
    e_t = block_end_states(torch.as_tensor(xb), tops)
    assert e_t.shape == e_j.shape == (1, 64, 6)
    np.testing.assert_allclose(e_t.numpy(), e_j, atol=2e-5)
    # The same true states into both E2b's.
    sigma = np.array(jeq._carry_states(jnp.asarray(e_j), jops))
    y_j = np.asarray(jblock_apply(jnp.asarray(xb), jnp.asarray(sigma), jops,
                                  interpret=True)).ravel()
    y_t = block_apply(torch.as_tensor(xb), torch.as_tensor(sigma),
                      tops).numpy().ravel()
    assert snr_db(y_j, y_t) > 100
    want = oracle.equalize_oracle(x, FS, cfg)
    assert snr_db(want, np.clip(y_t, -1.0, 1.0)) > 60


def test_ragged_block_count_matches_jax():
    """K = 37 blocks against the JAX kernels on a ragged tile (16)."""
    block = 128
    jops, tops, _ = operators({"Bass": 5}, block)
    xb = signal(37 * block, seed=8).reshape(1, 37, block)
    e_j = np.asarray(jblock_end_states(jnp.asarray(xb), jops, block_tile=16,
                                       interpret=True))
    e_t = block_end_states(torch.as_tensor(xb), tops, block_tile=16)
    np.testing.assert_allclose(e_t.numpy(), e_j, atol=2e-5)
    sigma = np.random.default_rng(3).standard_normal(e_j.shape).astype(
        np.float32)
    y_j = np.asarray(jblock_apply(jnp.asarray(xb), jnp.asarray(sigma), jops,
                                  block_tile=16, interpret=True))
    y_t = block_apply(torch.as_tensor(xb), torch.as_tensor(sigma), tops)
    assert y_t.shape == y_j.shape == (1, 37, block)
    assert snr_db(y_j.ravel(), y_t.numpy().ravel()) > 100


@pytest.mark.parametrize("n", [12000, 4096])
def test_equalize_pallas_matches_jax(n):
    """Two rows, a length that is (12000) and is not (4096 = 16 blocks)
    ragged against the block."""
    cfg = pt.EQConfig.from_gains(GAINS)
    x = 1.2 * signal(n, seed=n, rows=2)
    want = np.asarray(jeq.equalize_pallas(jnp.asarray(x), FS, cfg, block=256,
                                          unroll=16, interpret=True))
    reset_launch_counts()
    got = teq.equalize_pallas(x, FS, cfg, block=256, unroll=16, device="cpu")
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)  # CPU: plain
    assert got.shape == want.shape == (2, n)
    assert snr_db(want.ravel(), got.numpy().ravel()) > 100
    assert float(got.abs().max()) <= 1.0
    for i in range(2):
        assert snr_db(oracle.equalize_oracle(x[i], FS, cfg), got[i].numpy()) > 60


def test_equalize_pallas_bypass_and_no_band():
    x = 1.5 * signal(1000, seed=2)
    xt = torch.as_tensor(x)
    bypass = pt.EQConfig.from_gains({})
    assert torch.equal(teq.equalize_pallas(xt, FS, bypass), xt)  # unclipped
    # An active request whose one band clamps away (5 Hz < the 10 Hz floor).
    kw = dict(band_centers=(("Bass", 5.0),))
    got = teq.equalize_pallas(x, FS, pt.EQConfig.from_gains({"Bass": 6}, **kw),
                              device="cpu")
    want = np.asarray(jeq.equalize_pallas(
        jnp.asarray(x), FS, jpkg.EQConfig.from_gains({"Bass": 6}, **kw),
        interpret=True))
    assert np.array_equal(want, got.numpy())                 # the clip only
    assert np.array_equal(got.numpy(), np.clip(x, -1, 1))


def test_pipeline_explicit_paths_match_jax():
    """AudioPipeline with fir_path='pallas', iir_path='pallas' (E1, then
    E2a -> carry -> E2b) against the JAX pipeline with interpret=True, on
    a 0.25 s signal: z and y >= 100 dB, and the spectra."""
    x = signal(FS // 4, seed=11, rows=2)
    kw = dict(fir_path="pallas", iir_path="pallas", iir_block=256)
    jp = jpkg.AudioPipeline(jpkg.PipelineConfig(
        src=jpkg.SRCConfig(L=160, M=147), eq=jpkg.EQConfig.from_gains(GAINS),
        kernels=JKernelConfig(interpret=True, **kw)))
    tp = pt.AudioPipeline(pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(**kw)), device="cpu")
    want = jp(jnp.asarray(x), FS, with_spectra=True)
    got = tp(x, FS, with_spectra=True)
    assert got.output.shape == want.output.shape == (2, 12000)
    assert snr_db(np.asarray(want.output).ravel(),
                  got.output.numpy().ravel()) > 100
    assert snr_db(np.asarray(want.resampled).ravel(),
                  got.resampled.numpy().ravel()) > 100
    for k in ("input", "resampled", "output"):
        assert snr_db(np.asarray(want.spectra[k][1]).ravel(),
                      got.spectra[k][1].numpy().ravel()) > 100
    z_flat, _ = tp._forward(x, FS)
    assert torch.equal(z_flat, got.output)


def test_wrappers_reject_bad_input():
    _, tops, _ = operators({"Bass": 5}, 128)
    xb = torch.zeros(1, 4, 128)
    with pytest.raises(TypeError):
        block_end_states(xb.double(), tops)
    with pytest.raises(ValueError):
        block_end_states(xb[0], tops)                        # not 3-D
    with pytest.raises(ValueError):
        block_apply(xb, torch.zeros(1, 4, 3), tops)          # sigma's d
    assert block_end_states(torch.zeros(1, 4, 0), tops).shape == (1, 4, 2)
