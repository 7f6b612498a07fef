"""The port's multi-process mesh on the CPU: gloo process groups.

Spawns 2 worker processes (a 1x2 mesh) and 4 (2x2: the channel axis across
the two process groups, the block axis inside each), each importing only
torch and the port.  They join through a file rendezvous in the test's
temporary directory (no TCP port to collide under pytest-xdist), build
``distributed.multihost_mesh`` and run ``run_sharded`` on the whole signal,
as the JAX workers do: the halo goes through ``dist.batch_isend_irecv``,
the carries through ``dist.all_gather`` in the row's group, and every rank
gets the whole z back.  The parent holds each rank's z >= 60 dB against
the port's oracle and >= 110 dB against a 1x1 run of its own, on the plain
route (3/2) and the cat route (160/147, K1's plain version).  A worker
that does not finish in 120 s fails the test.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu_torch.oracle import pipeline_oracle, snr_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120

_WORKER = r"""
import os, sys
import numpy as np
import torch
rank, nproc, channel_hosts, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu_torch.parallel import distributed

distributed.initialize(f"file://{tmp}/rdzv", nproc, rank, device="cpu")
mesh = distributed.multihost_mesh(channel_hosts=channel_hosts)
assert mesh.process.rank == rank and len(mesh.local_shards) == 1
x = np.load(f"{tmp}/x.npy")
for name, (L, M, cat) in {"plain": (3, 2, False),
                          "cat": (160, 147, True)}.items():
    cfg = pt.PipelineConfig(
        src=pt.SRCConfig(L=L, M=M),
        eq=pt.EQConfig.from_gains({"Bass": 6, "High Mids": -4}),
        kernels=pt.KernelConfig(iir_block=128))
    z, y, fs_out, sp = pt.run_sharded(x, 44100, cfg, mesh, cat=cat)
    np.save(f"{tmp}/z_{name}_{rank}.npy", z.numpy())
torch.distributed.destroy_process_group()
print("DISTRIBUTED_OK", rank, distributed.is_primary(), flush=True)
"""


def _run_cluster(tmp_path, nproc: int, channel_hosts: int, channels: int):
    rng = np.random.default_rng(nproc)
    x = (rng.standard_normal((channels, 16384)) * 0.5).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, REPO=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(nproc), str(channel_hosts),
         str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "DISTRIBUTED_OK" in out, out[-3000:]

    for name, (L, M, cat) in {"plain": (3, 2, False),
                              "cat": (160, 147, True)}.items():
        cfg = pt.PipelineConfig(
            src=pt.SRCConfig(L=L, M=M),
            eq=pt.EQConfig.from_gains({"Bass": 6, "High Mids": -4}),
            kernels=pt.KernelConfig(iir_block=128))
        z1 = pt.run_sharded(x, 44100, cfg, pt.single_device_mesh("cpu"),
                            cat=cat)[0].numpy()
        zs = [np.load(tmp_path / f"z_{name}_{r}.npy") for r in range(nproc)]
        for z in zs[1:]:
            np.testing.assert_array_equal(z, zs[0])
        z = zs[0]
        assert z.shape == z1.shape
        for c in range(channels):
            want, _ = pipeline_oracle(x[c], 44100, cfg.src, cfg.eq,
                                      engine="fast")
            assert snr_db(want, z[c]) >= 60.0
            assert snr_db(z1[c], z[c]) >= 110.0


def test_two_process_mesh(tmp_path):
    """1x2: both ranks on the block axis of one channel row."""
    _run_cluster(tmp_path, nproc=2, channel_hosts=1, channels=1)


def test_four_process_mesh(tmp_path):
    """2x2: the channel axis across two groups of two ranks."""
    _run_cluster(tmp_path, nproc=4, channel_hosts=2, channels=2)


def test_gloo_refuses_cuda_tensors(tmp_path):
    """A one-rank gloo group on the CPU: the collectives take CPU tensors
    and refuse another device type with no fallback; a second initialize
    for the cards refuses to swap the backend."""
    from dsp_audio_project_tpu_torch.parallel import collectives, distributed

    distributed.initialize(f"file://{tmp_path}/rdzv", 1, 0, device="cpu")
    try:
        mesh = distributed.multihost_mesh()
        assert dict(mesh.shape) == {"channel": 1, "block": 1}
        axis = collectives.block_axis(mesh, 0)
        t = torch.arange(4.0)
        assert torch.equal(axis.all_gather([t])[0], t[None])
        assert torch.equal(axis.shift([t], 1)[0], torch.zeros(4))
        with pytest.raises(RuntimeError, match="gloo"):
            axis.all_gather([t.to("meta")])
        with pytest.raises(RuntimeError, match="gloo"):
            distributed.initialize("localhost:1", 1, 0, device="cuda:0")
    finally:
        torch.distributed.destroy_process_group()
