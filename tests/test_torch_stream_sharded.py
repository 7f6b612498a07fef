"""The port's ``ShardedStreamProcessor`` against the JAX package's, on the
CPU (plain kernel versions), on the same seeded inputs.

On a 1x1 mesh: the JAX package runs its flat route here (its fused rule
wants a TPU or interpret mode); the port's flat, fused-frames and cat
routes are each held against it at >= 110 dB, the JAX package's own gate
for its routes against one another and against the one-shot chain.
Checkpoint and resume: the port's resume bit for bit, a blob from either
package resuming in the other >= 110 dB.  ``set_gains`` on each dynamic
route against the JAX stream with the same change at the same step
boundary >= 110 dB; the dynamic stream tables equal to the JAX package's
bit for bit.  The cat route consumes 150,528 input samples a shard a step
at FL = 1024 and 160/147, so it runs at n = 320,000: two steps before the
flush at 1x1.

On meshes beyond 1x1 (virtual meshes: the port's grid repeats the CPU
device; the JAX mesh is the conftest's 8 virtual devices): the flat,
fused, cat and dynamic cat routes at 1x2, 1x4 and 2x2 against the JAX
stream on the JAX mesh of that shape, on two chunkings (>= 110 dB); resume
bit for bit on each mesh and a 1x2 blob resumed on each; a JAX 1x4 blob
resumed on the port's 1x4 mesh and the other way round; ``set_gains`` at
nb = 2; a mesh over several devices (eager steps, tables copied to each
shard's device) equal to the virtual mesh bit for bit.
"""
from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import (
    KernelConfig as JKernelConfig,
    MeshConfig as JMeshConfig,
)
from dsp_audio_project_tpu.ops.eq_dynamic import (
    build_dynamic_stream_operators_host as jax_stream_ops,
)
from dsp_audio_project_tpu.parallel.mesh import build_mesh as jax_mesh
from dsp_audio_project_tpu.streaming import (
    ShardedStreamProcessor as JShardedStreamProcessor,
)
from dsp_audio_project_tpu_torch.ops.eq_dynamic import (
    build_dynamic_stream_operators_host,
    dyn_stream_operators_from_numpy,
)
from dsp_audio_project_tpu_torch.oracle import snr_db
from dsp_audio_project_tpu_torch.parallel import (
    DeviceMesh,
    ProcessGrid,
    build_mesh,
    single_device_mesh,
)

from conftest import make_test_signal

torch.set_num_threads(2)

FS = 44100
GAINS = {"Bass": 6, "High Mids": -4}
GAINS_A = [6.0, -3.0, 2.0, 5.0, -7.0, 4.0]
GAINS_B = [-2.0, 8.0, -5.0, 1.0, 3.0, -6.0]
CHUNKS = [977, 3000, 16000, 9999, 50000]
GATE_DB = 110.0


def configs(L=160, M=147, gains=GAINS, iir_block=1024):
    return (
        jpkg.PipelineConfig(src=jpkg.SRCConfig(L=L, M=M),
                            eq=jpkg.EQConfig.from_gains(gains),
                            kernels=JKernelConfig(iir_block=iir_block)),
        pt.PipelineConfig(src=pt.SRCConfig(L=L, M=M),
                          eq=pt.EQConfig.from_gains(gains),
                          kernels=pt.KernelConfig(iir_block=iir_block)),
    )


def jmesh():
    return jax_mesh(JMeshConfig(channel_devices=1, block_devices=1))


def port(cfg, channels, **kw):
    return pt.ShardedStreamProcessor(cfg, FS, single_device_mesh("cpu"),
                                     channels, **kw)


def stream_through(sp, x, chunking):
    outs, pos = [], 0
    n = x.shape[-1]
    for size in chunking:
        take = min(size, n - pos)
        if take <= 0:
            break
        outs.append(sp.process(x[:, pos : pos + take]))
        pos += take
    assert pos == n, "chunking must cover the signal"
    outs.append(sp.flush())
    return np.concatenate(outs, axis=1)


def min_snr(want, got):
    assert got.shape == want.shape
    return min(snr_db(want[c], got[c]) for c in range(want.shape[0]))


def signals(C, n, seed):
    return np.stack([make_test_signal(n, FS, seed=seed + i) for i in range(C)])


@pytest.fixture(scope="module")
def two_channels():
    """C = 2, n = 50,000 and the JAX package's flat stream of it."""
    x = signals(2, 50000, 0)
    jcfg, cfg = configs()
    want = stream_through(JShardedStreamProcessor(jcfg, FS, jmesh(), 2), x,
                          CHUNKS)
    return x, jcfg, cfg, want


@pytest.mark.parametrize("route,kw", [
    ("flat", dict(fused=False)),
    ("fused", dict()),
    ("fused fl=512", dict(frames_per_shard=512)),
])
def test_routes_match_jax(two_channels, route, kw):
    x, _, cfg, want = two_channels
    sp = port(cfg, 2, **kw)
    assert sp._fused == (route != "flat") and not sp._cat
    z = stream_through(sp, x, CHUNKS)
    assert z.dtype == np.float32
    assert min_snr(want, z) >= GATE_DB


def test_cat_route_matches_jax():
    x = signals(1, 320000, 3)
    jcfg, cfg = configs()
    want = stream_through(JShardedStreamProcessor(jcfg, FS, jmesh(), 1), x,
                          [100000, 320000])
    sp = port(cfg, 1, frames_per_shard=1024)
    assert sp._cat and sp._fl == 1024
    first = sp.process(x[:, :100000])
    second = sp.process(x[:, 100000:])
    assert first.shape[1] == 0 and sp._frames_done == 2 * 1024
    z = np.concatenate([first, second, sp.flush()], axis=1)
    assert min_snr(want, z) >= GATE_DB


def test_chunking_invariance_bit_for_bit(two_channels):
    x, _, cfg, _ = two_channels
    z1 = stream_through(port(cfg, 2), x, [50000])
    z2 = stream_through(port(cfg, 2), x, [1, 499, 12000, 50000])
    np.testing.assert_array_equal(z1, z2)


def test_port_resume_is_bit_for_bit(two_channels):
    x, _, cfg, _ = two_channels
    full = stream_through(port(cfg, 2), x, [20000, 50000])
    sp1 = port(cfg, 2)
    part1 = sp1.process(torch.as_tensor(x[:, :20000]))   # a tensor chunk
    sp2 = pt.ShardedStreamProcessor.resume(cfg, single_device_mesh("cpu"),
                                           2, sp1.state_bytes())
    got = np.concatenate([part1, sp2.process(x[:, 20000:]), sp2.flush()],
                         axis=1)
    np.testing.assert_array_equal(full, got)


def test_blobs_cross_between_packages(two_channels):
    x, jcfg, cfg, want = two_channels
    sj = JShardedStreamProcessor(jcfg, FS, jmesh(), 2)
    part1 = sj.process(x[:, :20000])
    sp = pt.ShardedStreamProcessor.resume(cfg, single_device_mesh("cpu"), 2,
                                          sj.state_bytes())
    got = np.concatenate([part1, sp.process(x[:, 20000:]), sp.flush()], 1)
    assert min_snr(want, got) >= GATE_DB

    sp = port(cfg, 2)
    part1 = sp.process(x[:, :20000])
    sj = JShardedStreamProcessor.resume(jcfg, jmesh(), 2, sp.state_bytes())
    got = np.concatenate([part1, sj.process(x[:, 20000:]), sj.flush()], 1)
    assert min_snr(want, got) >= GATE_DB


def test_resume_validates_the_basis(two_channels):
    _, _, cfg, _ = two_channels
    blob = port(cfg, 2).state_bytes()
    mesh = single_device_mesh("cpu")
    with pytest.raises(ValueError):
        pt.ShardedStreamProcessor.resume(cfg, mesh, 2, blob, gains_db=[0] * 6)
    sp = port(cfg, 2)
    sp.process(signals(2, 3000, 5))
    with pytest.raises(ValueError):
        pt.ShardedStreamProcessor.resume(cfg, mesh, 3, sp.state_bytes())


@pytest.fixture(scope="module")
def gain_change():
    """C = 1, n = 320,000; the gains move from GAINS_A to GAINS_B after the
    first 180,000 samples, where every route below has run exactly one
    step of 1024 frames.  The JAX package's flat stream at FL = 1024."""
    x = signals(1, 320000, 41)
    jcfg, cfg = configs(gains={"Bass": 6})

    def run(sp):
        part1 = sp.process(x[:, :180000])
        sp.set_gains(GAINS_B)
        return part1.shape[1], np.concatenate(
            [part1, sp.process(x[:, 180000:]), sp.flush()], axis=1)

    m, want = run(JShardedStreamProcessor(jcfg, FS, jmesh(), 1,
                                          gains_db=GAINS_A,
                                          frames_per_shard=1024))
    assert m == 1024 * 160
    return cfg, run, m, want


@pytest.mark.parametrize("route,kw", [
    ("flat", dict(fused=False, frames_per_shard=1024)),
    ("fused", dict(frames_per_shard=512)),
    ("cat", dict(frames_per_shard=1024)),
])
def test_set_gains_matches_jax(gain_change, route, kw):
    cfg, run, m, want = gain_change
    sp = port(cfg, 1, gains_db=GAINS_A, **kw)
    assert sp._cat_dyn == (route == "cat")
    tables = {k: v for k, v in sp._tab.items()}
    m_port, z = run(sp)
    assert m_port == m
    assert min_snr(want, z) >= GATE_DB
    # The change rewrote the step's table buffers in place: the same
    # tensors, so a captured step would replay as it is.
    assert all(sp._tab[k] is t for k, t in tables.items())
    assert sp.captures == 0          # no graphs on the CPU


def test_set_gains_requires_dynamic(two_channels):
    _, _, cfg, _ = two_channels
    with pytest.raises(RuntimeError):
        port(cfg, 1).set_gains([0.0] * 6)
    with pytest.raises(ValueError):
        port(cfg, 1, gains_db=[0.0] * 5)


@pytest.mark.parametrize("K,nb", [(1, 1), (3, 1), (8, 2)])
def test_dynamic_stream_tables_bit_for_bit(K, nb):
    kw = dict(unroll=160, groups_per_block=128, num_blocks=K, num_shards=nb)
    want = jax_stream_ops(np.asarray(GAINS_A), 48000, jpkg.EQConfig(), **kw)
    got = build_dynamic_stream_operators_host(
        np.asarray(GAINS_A), 48000, pt.EQConfig(), device="cpu", **kw)
    carried = dyn_stream_operators_from_numpy(
        (tuple(np.asarray(a) if a is not None else None for a in want.ops),)
        + tuple(np.asarray(a) if a is not None else None
                for a in want[1:]), "cpu")
    for built in (got, carried):
        pairs = list(zip(want.ops, built.ops)) + list(zip(want[1:],
                                                          built[1:]))
        for a, b in pairs:
            assert (a is None) == (b is None)
            if a is not None:
                assert b.dtype == torch.float32
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (got.carry_loc is None) == (K == 1)


def test_every_factorization_builds_and_streams():
    """Every factorization of 8 builds over a repeated CPU device, and the
    stream runs on it."""
    cpu = torch.device("cpu")
    mesh = build_mesh(pt.MeshConfig(), devices=[cpu])
    assert dict(mesh.shape) == {"channel": 1, "block": 1}
    assert mesh.device == cpu and mesh.shared
    _, cfg = configs()
    x = signals(2, 3000, 8)
    for mc in (1, 2, 4, 8):
        m = build_mesh(pt.MeshConfig(channel_devices=mc,
                                     block_devices=8 // mc),
                       devices=[cpu] * 8)
        assert dict(m.shape) == {"channel": mc, "block": 8 // mc}
        assert m.shared and m.device == cpu and len(m.local_shards) == 8
        z = stream_through(pt.ShardedStreamProcessor(cfg, FS, m, 2), x,
                           [3000])
        assert z.shape == (2, cfg.src.output_length(3000))
    assert dict(build_mesh(devices=[cpu, cpu]).shape) == {"channel": 1,
                                                          "block": 2}


def test_meshes_beyond_one_device_raise():
    """What still raises beyond one device: a mesh wanting more devices
    than it is given, ``device`` on a mesh over several devices, and a
    process-group mesh in the stream."""
    cpu = torch.device("cpu")
    _, cfg = configs()
    with pytest.raises(ValueError):
        build_mesh(pt.MeshConfig(channel_devices=2, block_devices=2),
                   devices=[cpu] * 3)
    several = build_mesh(pt.MeshConfig(block_devices=2),
                         devices=["cpu", "cpu:0"])
    assert not several.shared
    with pytest.raises(ValueError):
        several.device
    grid = ProcessGrid(((0, 1),), 0, (None,))
    with pytest.raises(ValueError, match="process"):
        pt.ShardedStreamProcessor(cfg, FS, DeviceMesh(((cpu, cpu),), process=grid), 2)


def test_fused_rule():
    """'auto' is fused wherever s >= 8, on the CPU as on the card."""
    _, cfg = configs()
    assert port(cfg, 1)._fused
    _, cfg32 = configs(3, 2)
    assert not port(cfg32, 1)._fused
    with pytest.raises(ValueError):
        port(cfg32, 1, fused=True)


def test_short_stream_and_bypass_paths():
    """Shorter than the filter (the one-shot geometry at flush), SRC bypass
    (EQ only) and EQ bypass (SRC only, unclipped), against the JAX
    stream."""
    mesh = jmesh()
    x = signals(2, 30, 3)
    jcfg, cfg = configs()
    want = stream_through(JShardedStreamProcessor(jcfg, FS, mesh, 2), x,
                          [30])
    assert min_snr(want, stream_through(port(cfg, 2), x, [30])) >= GATE_DB

    x = signals(2, 30000, 21)
    jcfg, cfg = configs(1, 1, {"Bass": 6, "Presence": -9})
    want = stream_through(JShardedStreamProcessor(jcfg, FS, mesh, 2), x,
                          [7000, 30000])
    assert min_snr(want, stream_through(port(cfg, 2), x,
                                        [7000, 30000])) >= GATE_DB

    loud = 3.0 * x
    jcfg, cfg = configs(160, 147, {})
    want = stream_through(JShardedStreamProcessor(jcfg, FS, mesh, 2), loud,
                          [12345, 30000])
    got = stream_through(port(cfg, 2), loud, [12345, 30000])
    assert np.abs(got).max() > 1.5
    assert min_snr(want, got) >= GATE_DB


# ---- meshes beyond 1x1 -----------------------------------------------------

MESHES = [(1, 2), (1, 4), (2, 2)]
LONG_CHUNKS = ([320000], [977, 30000, 123456, 320000])


def port_mesh(mc, mb, devices=("cpu",) * 4):
    return build_mesh(pt.MeshConfig(channel_devices=mc, block_devices=mb),
                      devices=list(devices))


def jmesh_of(mc, mb):
    return jax_mesh(JMeshConfig(channel_devices=mc, block_devices=mb))


@pytest.fixture(scope="module")
def long_two_channels():
    """C = 2, n = 320,000: a cat step of 1024 frames a shard covers
    150,528 samples a shard, so every block shard of 1x2 carries signal
    and shard 1 of 1x4 too.  The JAX flat stream at FL 1024 on each JAX
    mesh, static (GAINS) and dynamic (GAINS_A)."""
    x = signals(2, 320000, 61)
    jcfg, cfg = configs()
    want = {}
    for mc, mb in MESHES:
        for dyn in (False, True):
            kw = dict(frames_per_shard=1024,
                      **({"gains_db": GAINS_A} if dyn else {}))
            want[(mc, mb, dyn)] = stream_through(
                JShardedStreamProcessor(jcfg, FS, jmesh_of(mc, mb), 2, **kw),
                x, [100000, 320000])
    return x, jcfg, cfg, want


MESH_ROUTES = [
    ("flat", dict(fused=False), False),
    ("fused", dict(), False),
    ("cat", dict(frames_per_shard=1024), False),
    ("dynamic cat", dict(frames_per_shard=1024, gains_db=GAINS_A), True),
]


@pytest.mark.parametrize("mc,mb", MESHES)
@pytest.mark.parametrize("route,kw,dyn", MESH_ROUTES,
                         ids=[r[0] for r in MESH_ROUTES])
def test_routes_match_jax_on_meshes(long_two_channels, mc, mb, route, kw,
                                    dyn):
    """Each route on a (mc, mb) virtual CPU mesh against the JAX stream on
    the JAX mesh of that shape, on two chunkings."""
    x, _, cfg, want = long_two_channels
    for chunks in LONG_CHUNKS:
        sp = pt.ShardedStreamProcessor(cfg, FS, port_mesh(mc, mb), 2, **kw)
        assert (sp._nb, sp._mc) == (mb, mc)
        assert (sp._cat or sp._cat_dyn) == ("cat" in route)
        z = stream_through(sp, x, chunks)
        assert min_snr(want[(mc, mb, dyn)], z) >= GATE_DB


@pytest.mark.parametrize("mc,mb", MESHES)
def test_resume_bit_for_bit_on_meshes(long_two_channels, mc, mb):
    """A checkpoint mid-stream (after two or more steps of 128 frames a
    shard) resumes bit for bit on each mesh; a blob taken on 1x2 resumes
    on this mesh >= 110 dB against the JAX stream."""
    x, _, cfg, want = long_two_channels
    kw = dict(frames_per_shard=128)
    mesh = port_mesh(mc, mb)
    full = stream_through(pt.ShardedStreamProcessor(cfg, FS, mesh, 2, **kw),
                          x, [170000, 320000])
    sp1 = pt.ShardedStreamProcessor(cfg, FS, mesh, 2, **kw)
    part1 = sp1.process(x[:, :170000])
    assert sp1._frames_done >= 2 * sp1._F_sup
    sp2 = pt.ShardedStreamProcessor.resume(cfg, mesh, 2, sp1.state_bytes(),
                                           **kw)
    got = np.concatenate([part1, sp2.process(x[:, 170000:]), sp2.flush()], 1)
    np.testing.assert_array_equal(full, got)

    sp1 = pt.ShardedStreamProcessor(cfg, FS, port_mesh(1, 2), 2, **kw)
    part1 = sp1.process(x[:, :170000])
    sp2 = pt.ShardedStreamProcessor.resume(cfg, mesh, 2, sp1.state_bytes(),
                                           **kw)
    got = np.concatenate([part1, sp2.process(x[:, 170000:]), sp2.flush()], 1)
    assert min_snr(want[(mc, mb, False)], got) >= GATE_DB


def test_jax_blob_resumes_on_a_port_mesh(long_two_channels):
    """A JAX 1x4 stream's blob resumes on the port's 1x4 mesh, and the
    port's on the JAX mesh, >= 110 dB against the uninterrupted JAX run."""
    x, jcfg, cfg, want = long_two_channels
    kw = dict(frames_per_shard=128)
    ref = want[(1, 4, False)]
    sj = JShardedStreamProcessor(jcfg, FS, jmesh_of(1, 4), 2, **kw)
    part1 = sj.process(x[:, :170000])
    assert sj._frames_done >= 2 * 4 * 128
    sp = pt.ShardedStreamProcessor.resume(cfg, port_mesh(1, 4), 2,
                                          sj.state_bytes(), **kw)
    got = np.concatenate([part1, sp.process(x[:, 170000:]), sp.flush()], 1)
    assert min_snr(ref, got) >= GATE_DB

    sp = pt.ShardedStreamProcessor(cfg, FS, port_mesh(1, 4), 2, **kw)
    part1 = sp.process(x[:, :170000])
    assert sp._frames_done >= 2 * 4 * 128
    sj = JShardedStreamProcessor.resume(jcfg, jmesh_of(1, 4), 2,
                                        sp.state_bytes(), **kw)
    got = np.concatenate([part1, sj.process(x[:, 170000:]), sj.flush()], 1)
    assert min_snr(ref, got) >= GATE_DB


@pytest.mark.parametrize("route,kw", [
    ("frames", dict(frames_per_shard=512)),
    ("cat", dict(frames_per_shard=1024)),
])
def test_set_gains_on_two_block_shards(route, kw):
    """``set_gains`` at nb = 2 against the JAX stream on a JAX 1x2 mesh
    with the same change at the same step boundary."""
    x = signals(1, 640000, 43)
    jcfg, cfg = configs(gains={"Bass": 6})
    cut = 320000

    def run(sp):
        part1 = sp.process(x[:, :cut])
        sp.set_gains(GAINS_B)
        return part1.shape[1], np.concatenate(
            [part1, sp.process(x[:, cut:]), sp.flush()], axis=1)

    m, want = run(JShardedStreamProcessor(jcfg, FS, jmesh_of(1, 2), 1,
                                          gains_db=GAINS_A, **kw))
    sp = pt.ShardedStreamProcessor(cfg, FS, port_mesh(1, 2), 1,
                                   gains_db=GAINS_A, **kw)
    assert sp._cat_dyn == (route == "cat")
    m_port, z = run(sp)
    assert m_port == m > 0
    assert min_snr(want, z) >= GATE_DB


def test_several_devices_run_eagerly(long_two_channels):
    """A mesh over several devices ("cpu" and "cpu:0" are two torch
    devices) runs the same step with the tables copied to each shard's
    device, equal to the virtual mesh bit for bit; ``set_gains`` reaches
    every copy."""
    x, _, cfg, _ = long_two_channels
    devs = ("cpu", "cpu:0", "cpu:1", "cpu:2")
    for kw in (dict(frames_per_shard=1024),
               dict(frames_per_shard=512, gains_db=GAINS_A)):
        z = {}
        for name, mesh in (("virtual", port_mesh(2, 2)),
                           ("several", port_mesh(2, 2, devs))):
            sp = pt.ShardedStreamProcessor(cfg, FS, mesh, 2, **kw)
            part1 = sp.process(x[:, :200000])
            if "gains_db" in kw:
                sp.set_gains(GAINS_B)
            z[name] = np.concatenate([part1, sp.process(x[:, 200000:]),
                                      sp.flush()], 1)
            assert (len(sp._tabs) == 1) == (name == "virtual")
            if "gains_db" in kw:
                for tab in sp._tabs.values():
                    np.testing.assert_array_equal(tab["pk"].numpy(),
                                                  sp._tab["pk"].numpy())
        np.testing.assert_array_equal(z["virtual"], z["several"])


def test_a_processor_is_freed_without_the_cycle_collector(long_two_channels):
    """A processor that has stepped holds no reference cycle: dropping the
    last reference frees it at once (on a card, its captured graphs with
    it), never later by the cycle collector, which could run inside
    another stream's capture and invalidate it."""
    x, _, cfg, _ = long_two_channels
    for mesh in (single_device_mesh("cpu"), port_mesh(2, 2)):
        sp = pt.ShardedStreamProcessor(cfg, FS, mesh, 2, frames_per_shard=128)
        sp.process(x[:, :100000])
        assert sp._runner is not None and sp._frames_done > 0
        ref = weakref.ref(sp)
        gc.disable()
        try:
            del sp
            assert ref() is None
        finally:
            gc.enable()
