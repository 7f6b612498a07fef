"""The launcher contract of ``parallel/distributed.initialize`` and the
port's ``scripts/pod_scaling``, on the CPU (gloo).

``initialize()`` with no arguments reads a ``torchrun``-style environment
(``env://``) and raises ``ValueError`` without one; ``card_index`` maps an
NCCL rank to its card by ``LOCAL_RANK``.  ``pod_scaling`` runs in one
process (no launcher), in 2 and 4 gloo processes through a file
rendezvous in the test's temporary directory (each worker timed out after
120 s, as in ``test_torch_distributed.py``), and under ``torchrun``; the
processes' z is >= 110 dB on every channel against the JAX package's
``run_sharded(..., fused=True)`` on the same virtual CPU mesh (Pallas in
interpret mode, float32 matmuls) with the same seeded input.  The efficiency formula, the
card requirement and a failed gate's exit code are checked on their own.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu.config import MeshConfig as JMeshConfig
from dsp_audio_project_tpu.config import EQConfig as JEQConfig
from dsp_audio_project_tpu.config import PipelineConfig as JPipelineConfig
from dsp_audio_project_tpu.config import SRCConfig as JSRCConfig
from dsp_audio_project_tpu.parallel import pipeline as jpipe
from dsp_audio_project_tpu.parallel.mesh import build_mesh as jax_mesh
from dsp_audio_project_tpu_torch.oracle import snr_db
from dsp_audio_project_tpu_torch.parallel import distributed
from dsp_audio_project_tpu_torch.scripts import pod_scaling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
SECONDS = "0.5"
CHANNELS = 2

_WORKER = r"""
import os, sys
import numpy as np
import torch
rank, nproc, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
sys.path.insert(0, os.environ["REPO"])
from dsp_audio_project_tpu_torch.scripts import pod_scaling

res = pod_scaling.run(pod_scaling.parse_args([
    "--device", "cpu", "--coordinator", f"file://{tmp}/rdzv",
    "--num-processes", str(nproc), "--process-id", str(rank),
    "--channel-hosts", "1", "--seconds", sys.argv[4],
    "--channels", sys.argv[5], "--reps", "2"]))
pod_scaling.report(res)
np.save(f"{tmp}/z_{rank}.npy", res["z"])
torch.distributed.destroy_process_group()
print("POD_OK", rank, res["ok"], res["mesh"], flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _no_launcher(monkeypatch):
    for key in distributed.LAUNCHER_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(key, raising=False)


def _jax_fused(nb: int) -> np.ndarray:
    """The JAX package's sharded fused chain on a 1 x nb virtual CPU mesh,
    the script's input and configuration at the JAX float32 precision
    (``eq_fast = src_fast = False``): the port serves both settings at
    float32 accuracy (``config.KernelConfig``), while the JAX bf16x3 path
    is itself ~108 dB from the float64 oracle on this input, below the
    110 dB gate."""
    n = int(float(SECONDS) * 44100)
    x = (np.random.default_rng(0).standard_normal((CHANNELS, n)) * 0.4
         ).astype(np.float32)
    cfg = JPipelineConfig(
        src=JSRCConfig(L=160, M=147),
        eq=JEQConfig.from_gains({"Sub-Bass": 6, "Bass": -3,
                                 "High Mids": 12, "Presence": -15,
                                 "Brilliance": 4}),
        kernels=JKernelConfig(interpret=True))
    mesh = jax_mesh(JMeshConfig(channel_devices=1, block_devices=nb))
    return np.asarray(jpipe.run_sharded(x, 44100, cfg, mesh, fused=True)[0])


def test_initialize_reads_the_launcher_environment(monkeypatch):
    """torchrun's variables: env://, the rank and world size from the
    environment, the group kept by a second call."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    assert distributed.initialize(device="cpu") == torch.device("cpu")
    try:
        assert dist.get_rank() == 0 and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        assert distributed.initialize(device="cpu") == torch.device("cpu")
        assert dict(distributed.multihost_mesh().shape) == {"channel": 1,
                                                            "block": 1}
    finally:
        dist.destroy_process_group()


def test_initialize_without_a_launcher_raises(monkeypatch):
    _no_launcher(monkeypatch)
    with pytest.raises(ValueError, match="launcher environment"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("file:///nowhere", device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="process_id=1"):
        distributed.initialize(process_id=1, device="cpu")
    assert not dist.is_initialized()


def test_launcher_env():
    assert distributed.launcher_env({"RANK": "1"}) is None
    env = {"RANK": "5", "WORLD_SIZE": "8", "MASTER_ADDR": "h",
           "MASTER_PORT": "1"}
    assert distributed.launcher_env(env) == {"rank": 5, "world": 8,
                                             "local_rank": None}
    assert distributed.launcher_env({**env, "LOCAL_RANK": "1"}) == {
        "rank": 5, "world": 8, "local_rank": 1}


@pytest.mark.parametrize("rank,local,count,want", [
    (0, None, 4, 0), (5, None, 4, 1), (5, 1, 4, 1), (3, 3, 4, 3),
    (6, 2, 4, 2)])
def test_card_index(rank, local, count, want):
    """LOCAL_RANK, where the launcher gives it, picks the card (a second
    host's rank 6 is its card 2), else rank % count."""
    assert distributed.card_index(rank, local, count) == want


def test_card_index_refuses_a_missing_card():
    with pytest.raises(ValueError, match="LOCAL_RANK=4"):
        distributed.card_index(4, 4, 4)
    with pytest.raises(ValueError, match="no CUDA device"):
        distributed.card_index(0, None, 0)


def test_scaling_efficiency():
    assert pod_scaling.scaling_efficiency(8.0, 4, 2.0) == 1.0
    assert pod_scaling.scaling_efficiency(8.0, 4, 2.5) == pytest.approx(0.8)
    assert pod_scaling.scaling_efficiency(3.0, 1, 6.0) == 0.5


def test_pod_scaling_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pod_scaling.main(["--seconds", "0.1"])


def test_pod_scaling_single_process(monkeypatch, capsys):
    """No launcher and no coordinator: one process, said so; gates pass."""
    _no_launcher(monkeypatch)
    assert pod_scaling.main(["--device", "cpu", "--seconds", "0.25",
                             "--channels", "2", "--reps", "2"]) == 0
    out = capsys.readouterr().out
    assert "single-process run" in out and "gates passed" in out
    assert not dist.is_initialized()


def test_pod_scaling_failed_gate_exits_1(monkeypatch, capsys):
    _no_launcher(monkeypatch)
    monkeypatch.setattr(pod_scaling, "ORACLE_DB", 1000.0)
    assert pod_scaling.main(["--device", "cpu", "--seconds", "0.25",
                             "--channels", "1", "--reps", "1"]) == 1
    assert "gates FAILED" in capsys.readouterr().out


@pytest.mark.parametrize("nproc", [2, 4])
def test_pod_scaling_gloo_processes_match_jax(tmp_path, nproc):
    """1 x nproc gloo processes (the halo through batch_isend_irecv, the
    carry through all_gather, interior ranks at 4): every rank's z equal,
    >= 110 dB on every channel against the JAX fused chain on 1 x nproc."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, REPO=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(nproc), str(tmp_path),
         SECONDS, str(CHANNELS)],
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
        assert p.returncode == 0 and "POD_OK" in out, out[-3000:]
    assert "gates passed" in outs[0] and "(gloo)" in outs[0]
    assert f"'block': {nproc}" in outs[0]
    zs = [np.load(tmp_path / f"z_{r}.npy") for r in range(nproc)]
    for z in zs[1:]:
        np.testing.assert_array_equal(z, zs[0])
    want = _jax_fused(nproc)
    assert zs[0].shape == want.shape == (CHANNELS, 24000)
    for c in range(CHANNELS):
        assert snr_db(want[c], zs[0][c]) >= 110.0


def test_pod_scaling_under_torchrun(tmp_path):
    """torchrun --standalone, 2 processes: initialize() from the launcher's
    environment, a 1x2 gloo mesh, the gates."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "dsp_audio_project_tpu_torch.scripts.pod_scaling", "--device", "cpu",
         "--seconds", "0.25", "--channels", "2", "--channel-hosts", "1",
         "--reps", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    assert "2 process(es) (gloo)" in proc.stdout
    assert "'block': 2" in proc.stdout and "gates passed" in proc.stdout
