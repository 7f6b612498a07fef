"""Multi-shard dry run of the sharded chain and stream on one device.

    python -m dsp_audio_project_tpu_torch.parallel.dryrun 8               # the card
    python -m dsp_audio_project_tpu_torch.parallel.dryrun 8 --device cpu  # the CPU

Counterpart of the JAX package's ``__graft_entry__.py:43
dryrun_multichip``.  Every (channel x block) factorization of n shards is
built as a virtual mesh over ONE device (the list repeats it), which runs
the real halo exchange, gather and carry algebra: ``run_sharded`` with
the configs full (3/2 SRC + EQ, the plain route), fused (160/147, the
frames kernel in each shard), eq_only (SRC bypass) and src_only (EQ
bypass), each >= 60 dB against the port's numpy oracle at 1x1 and > 110 dB
invariant against 1x1 at every factorization; then the sharded stream
(full and fused, one and three chunks) against the one-shot 1x1 z, and a
mid-stream checkpoint resumed bit for bit.  A virtual mesh measures the
sharded code on one device, not scaling.  Any failed check raises.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import EQConfig, KernelConfig, MeshConfig, PipelineConfig, \
    SRCConfig
from ..oracle import pipeline_oracle, snr_db
from ..streaming import ShardedStreamProcessor
from ..utils.device import default_device
from .mesh import build_mesh
from .pipeline import run_sharded

GATE_ORACLE_DB = 60.0
GATE_INVARIANCE_DB = 110.0


def _configs(mb_max: int) -> dict:
    """name -> (config, samples, fused), the JAX dry run's four."""
    eq_gains = {"Sub-Bass": 6, "Bass": -3, "High Mids": 5}
    return {
        "full": (PipelineConfig(src=SRCConfig(L=3, M=2),
                                eq=EQConfig.from_gains(eq_gains),
                                kernels=KernelConfig(iir_block=128)),
                 4096 * mb_max, None),
        "fused": (PipelineConfig(src=SRCConfig(L=160, M=147),
                                 eq=EQConfig.from_gains({"Sub-Bass": 6,
                                                         "Bass": -3}),
                                 kernels=KernelConfig(iir_block=128)),
                  2048 * mb_max, True),
        "eq_only": (PipelineConfig(src=SRCConfig(L=1, M=1),
                                   eq=EQConfig.from_gains(eq_gains),
                                   kernels=KernelConfig(iir_block=128)),
                    4096 * mb_max, None),
        "src_only": (PipelineConfig(src=SRCConfig(L=3, M=2), eq=EQConfig(),
                                    kernels=KernelConfig(iir_block=128)),
                     4096 * mb_max, None),
    }


def _stream(sp, x: np.ndarray, chunking) -> np.ndarray:
    outs, pos = [], 0
    for size in chunking:
        take = min(size, x.shape[-1] - pos)
        if take <= 0:
            break
        outs.append(sp.process(x[:, pos:pos + take]))
        pos += take
    outs.append(sp.flush())
    return np.concatenate(outs, axis=1)


def _check(what: str, q: float, gate: float) -> None:
    if not q > gate:
        raise RuntimeError(f"{what}: {q:.1f} dB, gate {gate:.0f}")


def dryrun_multichip(n_shards: int, device=None) -> list:
    """Run the sweep on ``device`` (the card unless "cpu" is asked);
    returns the report lines, raising at the first failed check."""
    device = torch.device(device) if device is not None else \
        default_device("dryrun_multichip")
    factorizations = [(mc, n_shards // mc) for mc in range(1, n_shards + 1)
                      if n_shards % mc == 0]
    meshes = {f: build_mesh(MeshConfig(channel_devices=f[0],
                                       block_devices=f[1]),
                            devices=[device] * n_shards)
              for f in factorizations}
    base_mesh = build_mesh(MeshConfig(), devices=[device])
    fs, channels = 44100, 4
    mb_max = max(mb for _, mb in factorizations)
    rng = np.random.default_rng(0)
    configs = _configs(mb_max)
    lines = []

    for name, (cfg, n, fused) in configs.items():
        x = (rng.standard_normal((channels, n)) * 0.5).astype(np.float32)
        z_base, _, fs_out, _ = run_sharded(x, fs, cfg, base_mesh, fused=fused)
        z_base = z_base.cpu().numpy()
        oracle_q = np.inf
        for c in range(channels):
            want, fs_want = pipeline_oracle(x[c], fs, cfg.src, cfg.eq,
                                            engine="fast")
            if fs_out != fs_want or z_base.shape[1] != want.shape[0]:
                raise RuntimeError(f"{name}: rate or length differs from "
                                   "the oracle's")
            oracle_q = min(oracle_q, snr_db(want, z_base[c]))
        _check(f"{name} 1x1 vs the oracle", oracle_q, GATE_ORACLE_DB)
        for mc, mb in factorizations:
            z = run_sharded(x, fs, cfg, meshes[(mc, mb)],
                            fused=fused)[0].cpu().numpy()
            inv_q = min(snr_db(z_base[c], z[c]) for c in range(channels))
            _check(f"{name} {mc}x{mb} vs 1x1", inv_q, GATE_INVARIANCE_DB)
            lines.append(f"{name} {mc}x{mb}: oracle>={oracle_q:.1f}dB "
                         f"invariance>={inv_q:.1f}dB")

    # The sharded stream on every factorization against the one-shot 1x1
    # z: chunk x shard invariance.
    for name in ("full", "fused"):
        cfg, n, fused = configs[name]
        x = (rng.standard_normal((channels, n)) * 0.5).astype(np.float32)
        z_base = run_sharded(x, fs, cfg, base_mesh,
                             fused=fused)[0].cpu().numpy()
        for mc, mb in factorizations:
            for chunking in ([n], [977, 4096, n]):
                sp = ShardedStreamProcessor(cfg, fs, meshes[(mc, mb)],
                                            channels, fused=fused)
                z = _stream(sp, x, chunking)
                if z.shape != z_base.shape:
                    raise RuntimeError(f"stream {name} {mc}x{mb}: shape "
                                       f"{z.shape} vs {z_base.shape}")
                inv_q = min(snr_db(z_base[c], z[c]) for c in range(channels))
                _check(f"stream {name} {mc}x{mb} chunks={len(chunking)}",
                       inv_q, GATE_INVARIANCE_DB)
                lines.append(f"stream {name} {mc}x{mb} "
                             f"chunks={len(chunking)}: "
                             f"invariance>={inv_q:.1f}dB")

    # A mid-stream checkpoint resumed in a fresh processor: bit for bit.
    cfg, n, _ = configs["full"]
    x = (rng.standard_normal((channels, n)) * 0.5).astype(np.float32)
    mesh = meshes[factorizations[-1]]
    full_run = _stream(ShardedStreamProcessor(cfg, fs, mesh, channels), x,
                       [n])
    cut = n // 2
    sp1 = ShardedStreamProcessor(cfg, fs, mesh, channels)
    part1 = sp1.process(x[:, :cut])
    sp2 = ShardedStreamProcessor.resume(cfg, mesh, channels,
                                        sp1.state_bytes())
    resumed = np.concatenate([part1, sp2.process(x[:, cut:]), sp2.flush()],
                             axis=1)
    if not np.array_equal(full_run, resumed):
        raise RuntimeError("stream resume is not bit for bit")
    lines.append(f"stream resume {dict(mesh.shape)}: bitwise after a "
                 f"checkpoint at {cut} samples")

    for ln in lines:
        print("  " + ln)
    print(f"dryrun_multichip OK: device={device} shards={n_shards} "
          f"meshes={factorizations} (every config and the stream over "
          "every factorization, bitwise mid-stream resume), all channels "
          f">= {GATE_ORACLE_DB:.0f} dB vs the oracle, > "
          f"{GATE_INVARIANCE_DB:.0f} dB invariant vs 1x1", flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shards", type=int, nargs="?", default=8)
    ap.add_argument("--device", default=None,
                    help="where the virtual mesh lives (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.shards, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
