"""The port's serving chain (forward_cat_spectra) vs the JAX package and the oracle.

CPU, plain kernel versions, 1 s signals, batch 2.  Tolerances:
  * vs the JAX package's _forward_cat_spectra (interpret mode, bf16x3 "fast"
    serving precision): z and spectra > 90 dB — the JAX side's bf16x3
    products measure ~100 dB, the port is float32 throughout;
  * vs the numpy oracle: z > 90 dB, as tests/test_cat_chain.py holds the
    JAX chain;
  * the JAX design tables installed with tables_from_numpy: identical output
    (the tables are bit-identical, the computation is the same).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu.ops.src import make_plan as jmake_plan
from dsp_audio_project_tpu_torch import oracle
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def make_x(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal((batch, n))
    return (x / np.abs(x).max()).astype(np.float32)


def port_cfg(L=160, M=147, gains=GAINS, fast=True, eq_fast=None):
    return pt.PipelineConfig(
        src=pt.SRCConfig(L=L, M=M), eq=pt.EQConfig.from_gains(gains),
        kernels=pt.KernelConfig(src_fast=fast,
                                eq_fast=fast if eq_fast is None else eq_fast),
    )


def jax_pipe(L=160, M=147, gains=GAINS, fast=True, eq_fast=None):
    return jpkg.AudioPipeline(jpkg.PipelineConfig(
        src=jpkg.SRCConfig(L=L, M=M), eq=jpkg.EQConfig.from_gains(gains),
        kernels=JKernelConfig(src_fast=fast, interpret=True,
                              eq_fast=fast if eq_fast is None else eq_fast),
    ))


def test_chain_matches_jax_and_oracle():
    x = make_x(2, FS, seed=1)
    jz, jm = jax_pipe()._forward_cat_spectra(jnp.asarray(x), FS)
    pipe = pt.AudioPipeline(port_cfg(), device="cpu")
    z, mags = pipe.forward_cat_spectra(torch.as_tensor(x), FS)
    assert z.shape == jz.shape == (2, 1024, 160)
    assert snr_db(np.asarray(jz).ravel(), z.numpy().ravel()) > 90
    for a, b in zip(jm, mags):
        assert b.shape == a.shape == (2, 1025)
        assert snr_db(np.asarray(a).ravel(), b.numpy().ravel()) > 90
    n_out = pipe.config.src.output_length(FS)
    zf = z.reshape(2, -1)[:, :n_out].numpy()
    for i in range(2):
        want, fs_out = oracle.pipeline_oracle(x[i], FS, pipe.config.src,
                                              pipe.config.eq, engine="fast")
        assert fs_out == pipe.output_rate(FS) == 48000
        assert snr_db(want, zf[i]) > 90
    # forward_cat is the same z without the spectra.
    assert torch.equal(pipe.forward_cat(torch.as_tensor(x), FS), z)


def test_spectra_match_oracle():
    x = make_x(1, 2 * FS, seed=3)[0]
    cfg = port_cfg()
    pipe = pt.AudioPipeline(cfg, device="cpu")
    z, (mx, my, mz) = pipe.forward_cat_spectra(x, FS)
    y_want, fs_out = oracle.resample_oracle(x, FS, cfg.src, engine="fast")
    z_want = oracle.equalize_oracle(y_want, fs_out, cfg.eq)
    for sig, rate, got in ((x, FS, mx), (y_want, fs_out, my),
                           (z_want, fs_out, mz)):
        want = oracle.spectrum_oracle(sig, rate)[1]
        assert snr_db(want, got.numpy()) > 90


def test_tables_from_numpy_with_jax_tables():
    x = torch.as_tensor(make_x(2, FS, seed=2))
    cfg = port_cfg()
    own = pt.AudioPipeline(cfg, device="cpu")
    z0, m0 = own.forward_cat_spectra(x, FS)
    plan = jmake_plan(160, 147)
    jops = jeq.make_block_operators(
        jpkg.EQConfig.from_gains(GAINS).active_bands(48000), 48000, 1.0,
        128 * plan.P, plan.P)
    tables = {"G": plan.G, "group_fir": jops.group_fir,
              "group_in": jops.group_in, "group_out": jops.group_out,
              "group_pows": jops.group_pows,
              "group_toeplitz": jops.group_toeplitz,
              "state_corr": jops.state_corr,
              "carry_w": jeq._carry_weights(jops, 8)}
    other = pt.tables_from_numpy(pt.AudioPipeline(cfg, device="cpu"), FS,
                                 tables)
    z1, m1 = other.forward_cat_spectra(x, FS)
    assert torch.equal(z0, z1)
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))
    for name in ("G", "g2", "group_toeplitz", "carry_w"):
        assert torch.equal(getattr(own, name), getattr(other, name)), name
    with pytest.raises(ValueError):
        pt.tables_from_numpy(pt.AudioPipeline(cfg, device="cpu"), FS,
                             {**tables, "group_out": jops.group_out[:, :10]})


@pytest.mark.parametrize("L,M", [(160, 147), (441, 480), (320, 441)])
def test_cat_supported_agrees_with_jax(L, M):
    for gains in (GAINS, {}):
        for fast, eq_fast in ((True, True), (False, False), (True, False)):
            for n in (FS, 20):
                want = jax_pipe(L, M, gains, fast, eq_fast).cat_supported(n, FS)
                got = pt.AudioPipeline(port_cfg(L, M, gains, fast, eq_fast),
                                       device="cpu").cat_supported(n, FS)
                assert got == want, (L, M, gains, fast, eq_fast, n)
    assert pt.AudioPipeline(port_cfg(L, M), device="cpu").cat_supported(FS, FS)


def test_cat_rejects_bypass():
    assert not pt.AudioPipeline(port_cfg(L=1, M=1),
                               device="cpu").cat_supported(FS, FS)
    pipe = pt.AudioPipeline(port_cfg(gains={}), device="cpu")
    assert not pipe.cat_supported(FS, FS)
    with pytest.raises(ValueError):
        pipe.forward_cat_spectra(torch.zeros(FS), FS)


@pytest.mark.parametrize("L,M", [(441, 480), (320, 441)])
def test_other_rates_match_oracle(L, M):
    x = make_x(1, FS // 2, seed=L)[0]
    cfg = port_cfg(L, M)
    z = pt.AudioPipeline(cfg, device="cpu").forward_cat(x, FS)
    n_out = cfg.src.output_length(x.shape[-1])
    want, _ = oracle.pipeline_oracle(x, FS, cfg.src, cfg.eq, engine="fast")
    assert snr_db(want, z.reshape(-1)[:n_out].numpy()) > 90
