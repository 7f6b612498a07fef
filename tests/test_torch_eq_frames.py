"""The frames and flat EQ and the K9 finish: port vs the JAX package.

CPU, plain kernel versions.  Both sides get the same float32 numpy input.
Tolerances:
  * equalize_frames / equalize vs the JAX ones at full precision
    (fast=False): > 120 dB, float32 products in different summation orders
    (these inputs give 143-152 dB on the CPU);
  * equalize_frames_cat's two finishes on the CPU: identical (the 'kernel'
    finish runs K9's plain version, which is the 'torch' finish's code);
    both vs the JAX finish='pallas' in interpret mode: > 90 dB, the bound
    the port states against the JAX package (this input gives 157 dB);
  * K9's plain version vs float64 numpy: > 1e-6 abs on values in [-1, 1].
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.config import EQConfig as JEQConfig
from dsp_audio_project_tpu.kernels.fir_class import DPAD
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu_torch import EQConfig
from dsp_audio_project_tpu_torch.kernels.eq_finish import (
    eq_finish, eq_finish_plain, row_stride,
)
from dsp_audio_project_tpu_torch.ops import eq as teq
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

FS_OUT = 48000
P = 160
G = 128
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def signal(shape, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def snr(a, b):
    return snr_db(np.asarray(a).ravel(), b.numpy().ravel())


@pytest.mark.parametrize("F", [3 * G, 2 * G + 37])    # whole and ragged blocks
def test_equalize_frames_matches_jax(F):
    frames = signal((2, F, P), seed=F, scale=0.5)
    want = jeq.equalize_frames(jnp.asarray(frames), FS_OUT,
                               JEQConfig.from_gains(GAINS))
    got = teq.equalize_frames(torch.as_tensor(frames), FS_OUT,
                              EQConfig.from_gains(GAINS))
    assert got.shape == want.shape == (2, F, P)
    assert snr(want, got) > 120


@pytest.mark.parametrize("block,unroll,n", [(8192, 128, 20000),
                                            (1024, 16, 5000)])
def test_equalize_matches_jax(block, unroll, n):
    x = signal((2, n), seed=n, scale=0.5)
    want = jeq.equalize(jnp.asarray(x), FS_OUT, JEQConfig.from_gains(GAINS),
                        block=block, unroll=unroll)
    got = teq.equalize(torch.as_tensor(x), FS_OUT, EQConfig.from_gains(GAINS),
                       block=block, unroll=unroll)
    assert got.shape == (2, n)
    assert snr(want, got) > 120


def test_bypass_and_no_active_band_match_jax():
    x = signal((2, 3000), seed=1, scale=2.0)        # exceeds [-1, 1]
    frames = x.reshape(2, 30, 100)
    xt, ft = torch.as_tensor(x), torch.as_tensor(frames)
    # Whole-EQ bypass: the input comes back untouched and unclipped.
    assert teq.equalize(xt, FS_OUT, EQConfig()) is xt
    assert teq.equalize_frames(ft, FS_OUT, EQConfig()) is ft
    # Active request whose bands all clamp away (fs = 20 Hz): clip only.
    cfg, jcfg = EQConfig.from_gains(GAINS), JEQConfig.from_gains(GAINS)
    assert cfg.active_bands(20) == () and not cfg.bypass
    assert np.array_equal(np.asarray(jeq.equalize(jnp.asarray(x), 20, jcfg)),
                          teq.equalize(xt, 20, cfg).numpy())
    assert np.array_equal(
        np.asarray(jeq.equalize_frames(jnp.asarray(frames), 20, jcfg)),
        teq.equalize_frames(ft, 20, cfg).numpy())


def pack(inj):
    """Unpacked (B, F, d) -> the JAX kernel's (B, K, 128*DPAD) layout."""
    B, F, d = inj.shape
    out = np.zeros((B, F, DPAD), np.float32)
    out[..., :d] = inj
    return out.reshape(B, F // G, G * DPAD)


def test_cat_finishes_match_each_other_and_jax_pallas():
    ops = teq.make_block_operators(EQConfig.from_gains(GAINS).active_bands(
        FS_OUT), FS_OUT, 1.0, G * P, P)
    frames = signal((1, 1024, P), seed=3)            # eq_finish_pallas: F % 1024
    y0 = (frames @ ops.group_fir.T).astype(np.float32)
    inj = (frames @ ops.group_in).astype(np.float32)
    cfg = EQConfig.from_gains(GAINS)
    args = (torch.as_tensor(y0), torch.as_tensor(inj), FS_OUT, cfg)
    z_t = teq.equalize_frames_cat(*args, unroll=P, finish="torch")
    z_k = teq.equalize_frames_cat(*args, unroll=P, finish="kernel")
    assert torch.equal(z_t, z_k)
    assert torch.equal(teq.equalize_frames_cat(*args, unroll=P), z_k)
    want = jeq.equalize_frames_cat(
        jnp.asarray(y0), jnp.asarray(pack(inj)), FS_OUT,
        JEQConfig.from_gains(GAINS), unroll=P, finish="pallas",
        interpret=True)
    assert snr(want, z_k) > 90
    with pytest.raises(ValueError, match="finish"):
        teq.equalize_frames_cat(*args, unroll=P, finish="xla")


def test_eq_finish_plain_matches_float64():
    rng = np.random.default_rng(4)
    y0 = rng.standard_normal((2, 64, 48)).astype(np.float32)
    st = rng.standard_normal((2, 64, 6)).astype(np.float32)
    gout = (0.3 * rng.standard_normal((6, 48))).astype(np.float32)
    want = np.clip(y0.astype(np.float64) + st.astype(np.float64) @ gout, -1, 1)
    got = eq_finish(torch.as_tensor(y0), torch.as_tensor(st),
                    torch.as_tensor(gout))
    assert got.shape == (2, 64, 48) and got.is_contiguous()
    assert np.max(np.abs(want - got.numpy())) < 1e-6
    assert np.any(np.abs(want) == 1.0)               # the clip did bind


def test_eq_finish_reads_a_column_slice():
    """y0 as a column slice of the frames EQ's weight-concat product."""
    cat = torch.as_tensor(signal((2, 3, 16, 52), seed=5, scale=1.0))
    y0 = cat[..., :40]
    st = torch.as_tensor(signal((2, 3, 16, 5), seed=6, scale=1.0))
    gout = torch.as_tensor(signal((5, 40), seed=7, scale=1.0))
    assert row_stride(y0) == 52
    assert torch.equal(eq_finish(y0, st, gout),
                       eq_finish_plain(y0.contiguous(), st, gout))
    assert row_stride(cat[:, :, ::2, :40]) == 104     # every other row
    assert row_stride(cat[:, :, :8, :40]) is None     # a gap every 8 rows
    with pytest.raises(ValueError, match="evenly spaced"):
        eq_finish(cat[:, :, :, :40].transpose(1, 2), st.transpose(1, 2)
                  .contiguous(), gout)
    with pytest.raises(ValueError):                   # s_true not contiguous
        eq_finish(y0, st.transpose(0, 1).contiguous().transpose(0, 1), gout)
    with pytest.raises(ValueError):                   # width != U
        eq_finish(cat[..., :41], st, gout)
    with pytest.raises(TypeError):
        eq_finish(y0.double(), st, gout)
