"""The port's sharded chain (``parallel/pipeline.run_sharded``) against the
JAX package's on the conftest's 8 virtual CPU devices, on the same seeded
inputs.

The cases are those of tests/test_sharding.py.  Each holds the port's z
against the JAX ``run_sharded`` on a JAX mesh of the same shape (>= 110
dB), against the port's numpy oracle (>= 60 dB) and against the port's own
1x1 run (>= 110 dB).  The port's mesh repeats the CPU device: a virtual
mesh that runs the real halo exchange, gather and carry algebra.  The JAX
package takes its plain route here unless the case asks for the fused one
(its fused rule wants a TPU or interpret mode); the port takes its fused
route wherever s >= 8, and the routes agree at >= 110 dB.  The port's cat
route is held against the JAX fused route (interpret mode), the cat route's
twin.  Also: ``ShardPlan`` field by field, the cross-shard weights bit for
bit (read out of the JAX ``_cross_shard_sigma`` inside a ``shard_map`` on
one-hot states) and a halo changed in the neighbour's tensor reaching the
output, which shows the exchange is real.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import (
    KernelConfig as JKernelConfig,
    MeshConfig as JMeshConfig,
)
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu.parallel import pipeline as jpipe
from dsp_audio_project_tpu.parallel.mesh import build_mesh as jax_mesh
from dsp_audio_project_tpu_torch.ops import eq as teq
from dsp_audio_project_tpu_torch.oracle import pipeline_oracle, snr_db
from dsp_audio_project_tpu_torch.parallel import carry as tcarry
from dsp_audio_project_tpu_torch.parallel import pipeline as tpipe
from dsp_audio_project_tpu_torch.parallel import shard_signal

from conftest import make_test_signal

torch.set_num_threads(2)

GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15}
GATE_DB = 110.0
CPU8 = [torch.device("cpu")] * 8


def configs(L, M, gains=GAINS, iir_block=256, interpret=False):
    return (
        jpkg.PipelineConfig(
            src=jpkg.SRCConfig(L=L, M=M), eq=jpkg.EQConfig.from_gains(gains),
            kernels=JKernelConfig(iir_block=iir_block, interpret=interpret)),
        pt.PipelineConfig(
            src=pt.SRCConfig(L=L, M=M), eq=pt.EQConfig.from_gains(gains),
            kernels=pt.KernelConfig(iir_block=iir_block)),
    )


def port_mesh(mc, mb, devices=CPU8):
    return pt.build_mesh(pt.MeshConfig(channel_devices=mc, block_devices=mb),
                         devices=devices)


def min_snr(want, got):
    assert got.shape == want.shape
    return min(snr_db(want[c], got[c]) for c in range(want.shape[0]))


def check(jcfg, cfg, x, fs, mc, mb, jax_kw=None, port_kw=None, want=None):
    """Port vs JAX on a (mc, mb) mesh, vs the oracle and vs the port at
    1x1; returns the port's z.  ``want``: the JAX z, when a fixture has
    it."""
    x2 = x if x.ndim == 2 else x[None]
    port_kw = port_kw or {}
    z, y, fs_out, sp = pt.run_sharded(x, fs, cfg, port_mesh(mc, mb),
                                      **port_kw)
    z = z.numpy()
    assert z.dtype == np.float32 and (y is None) == bool(port_kw.get("cat"))
    if want is None:
        jz, _, jfs, _ = jpipe.run_sharded(
            x, fs, jcfg, jax_mesh(JMeshConfig(channel_devices=mc,
                                              block_devices=mb)),
            **(jax_kw or {}))
        want = np.asarray(jz)
        assert jfs == fs_out
    assert min_snr(want, z) >= GATE_DB
    for c in range(x2.shape[0]):
        ref, fs_ref = pipeline_oracle(x2[c], fs, cfg.src, cfg.eq,
                                      engine="fast")
        assert fs_ref == fs_out and ref.shape == z[c].shape
        assert snr_db(ref, z[c]) >= 60.0
    z1 = pt.run_sharded(x, fs, cfg, port_mesh(1, 1), **port_kw)[0].numpy()
    assert min_snr(z1, z) >= GATE_DB
    return z


@pytest.mark.parametrize("nblocks", [1, 2, 4, 8])
def test_block_shard_invariance(nblocks):
    x = make_test_signal(40000, 44100, seed=11)
    check(*configs(3, 2), x, 44100, 1, nblocks)


def test_headline_config_sharded():
    """160/147 at 1x8: the port's fused route against the JAX plain one."""
    x = make_test_signal(44100, 44100, seed=2)
    z = check(*configs(160, 147), x, 44100, 1, 8)
    assert z.shape == (1, 48000)


def test_channel_and_block_mesh():
    c, n = 4, 20000
    x = np.stack([make_test_signal(n, 44100, seed=s) for s in range(c)])
    check(*configs(2, 3), x, 44100, 2, 4)


def test_sharded_equals_unsharded_fir():
    """EQ bypassed: the sharded FIR equals the 1x1 FIR to 1e-6."""
    x = make_test_signal(30000, 48000, seed=9)
    jcfg, cfg = configs(2, 1, gains={})
    z8 = check(jcfg, cfg, x, 48000, 1, 8)
    z1 = pt.run_sharded(x, 48000, cfg, port_mesh(1, 1))[0].numpy()
    np.testing.assert_allclose(z1, z8, atol=1e-6)


@pytest.mark.parametrize("L,M,gains", [(1, 1, GAINS), (1, 2, {})],
                         ids=["src-bypass", "eq-bypass"])
def test_bypass_sharded(L, M, gains):
    x = make_test_signal(16000, 44100, seed=4)
    check(*configs(L, M, gains), x, 44100, 1, 4)


@pytest.fixture(scope="module")
def fused_jax():
    """The 160/147 signal of the fused cases and the JAX fused z (Pallas
    in interpret mode) on 1x2 and 1x4."""
    x = make_test_signal(44100, 44100, seed=13)
    jcfg, _ = configs(160, 147, interpret=True)
    want = {}
    for nb in (2, 4):
        jz = jpipe.run_sharded(
            x, 44100, jcfg,
            jax_mesh(JMeshConfig(channel_devices=1, block_devices=nb)),
            fused=True)[0]
        want[nb] = np.asarray(jz)
    return x, want


@pytest.mark.parametrize("nblocks", [2, 4])
def test_fused_sharded_matches_jax(fused_jax, nblocks):
    x, want = fused_jax
    jcfg, cfg = configs(160, 147)
    z = check(jcfg, cfg, x, 44100, 1, nblocks, port_kw=dict(fused=True),
              want=want[nblocks])
    z_plain = pt.run_sharded(x, 44100, cfg, port_mesh(1, nblocks),
                             fused=False)[0].numpy()
    assert min_snr(z_plain, z) >= GATE_DB


@pytest.mark.parametrize("nblocks", [2, 4])
def test_cat_sharded_matches_jax(fused_jax, nblocks):
    x, want = fused_jax
    jcfg, cfg = configs(160, 147)
    check(jcfg, cfg, x, 44100, 1, nblocks, port_kw=dict(cat=True),
          want=want[nblocks])


@pytest.mark.parametrize("n,c,mc,mb,L,M,hint,fused", [
    (40000, 1, 1, 4, 3, 2, 256, False),
    (44100, 1, 1, 8, 160, 147, 256, True),
    (44100, 3, 2, 4, 160, 147, 8192, False),
    (2_646_000, 8, 1, 8, 160, 147, 8192, True),
    (16000, 2, 2, 1, 1, 1, 128, False),
    (30000, 1, 1, 2, 441, 480, 1024, True),
])
def test_shard_plan_equals_jax(n, c, mc, mb, L, M, hint, fused):
    want, jplan = jpipe._plan_shards(n, c, mc, mb, jpkg.SRCConfig(L=L, M=M),
                                     hint, fused=fused)
    got, plan = tpipe._plan_shards(n, c, mc, mb, pt.SRCConfig(L=L, M=M),
                                   hint, fused=fused)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (plan is None) == (jplan is None)


@pytest.mark.parametrize("nb,K", [(2, 3), (4, 8), (8, 1)])
def test_cross_shard_weights_bit_for_bit(nb, K):
    """The JAX ``_cross_shard_sigma`` on one-hot end states returns its
    weight table exactly (w * 1 + 0 sums): W[my, s][i, j] is output row
    s*d + j of shard my, column i."""
    bands = ((150.0, 6.0), (3000.0, -4.0), (10000.0, 2.0))
    block = 128 * 160
    jops = jeq.make_block_operators(bands, 48000, 1.0, block, 160)
    ops = teq.make_block_operators(bands, 48000, 1.0, block, 160)
    d = ops.A.shape[0]
    n_out_local = K * block
    rows = nb * d
    e = np.zeros((nb * rows, d), np.float32)
    for s in range(nb):
        e[s * rows + s * d: s * rows + (s + 1) * d] = np.eye(d)
    mesh = jax_mesh(JMeshConfig(channel_devices=1, block_devices=nb))
    spec = PartitionSpec("block", None)
    fn = jax.jit(jax.shard_map(
        lambda e_loc: jpipe._cross_shard_sigma(e_loc, jops, n_out_local),
        mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False))
    out = np.asarray(fn(e)).reshape(nb, nb, d, d)    # [my, s, j, i]
    want = out.transpose(0, 1, 3, 2)
    got = tcarry.cross_shard_tables(ops.state_corr, nb, K)
    np.testing.assert_array_equal(got["weights"], want)
    assert got["pk"].shape == (K, d, d)


def test_halo_comes_from_the_neighbours_tensor():
    """Shard 0's last outputs read shard 1's first samples through the
    block axis: change them in shard 1's own tensor (not in any unsharded
    signal) and shard 0's output changes, at its tail only."""
    fs, n = 44100, 40000
    x = make_test_signal(n, fs, seed=5)
    _, cfg = configs(3, 2, gains={})          # SRC only: a local FIR
    mesh = port_mesh(1, 2)
    fn, sp = tpipe.build_sharded_pipeline(mesh, cfg, fs, n, 1)
    xp = torch.zeros((1, 2 * sp.n_in_local))
    xp[0, :n] = torch.as_tensor(x)
    shards = shard_signal(mesh, xp)
    z0 = fn(shards)[0][(0, 0)].clone()
    shards[(0, 1)] = shards[(0, 1)].clone()
    shards[(0, 1)][:, : sp.halo_right] += 0.5
    z1 = fn(shards)[0][(0, 0)]
    changed = torch.nonzero((z1 != z0)[0]).flatten()
    assert changed.numel() > 0
    assert int(changed.min()) >= sp.n_out_local - 3 * sp.halo_right


def test_dryrun_sweeps_every_factorization(capsys):
    """The port's multi-shard dry run (``python -m
    dsp_audio_project_tpu_torch.parallel.dryrun N --device cpu``) at 4
    shards: every config and the stream over 1x4, 2x2 and 4x1."""
    from dsp_audio_project_tpu_torch.parallel import dryrun

    assert dryrun.main(["4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out
    for name in ("full", "fused", "eq_only", "src_only", "stream full",
                 "stream fused"):
        for mesh in ("1x4", "2x2", "4x1"):
            assert f"{name} {mesh}" in out
