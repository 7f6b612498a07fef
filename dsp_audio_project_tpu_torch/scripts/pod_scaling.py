"""Scaling of the sharded fused chain over several cards.

Counterpart of the repo's ``scripts/pod_scaling.py``: it joins the process
group, builds the (channel, block) mesh over every rank, runs the sharded
fused chain (the frames kernel and K9 in each shard, the halo and the IIR
carry across shards) and reports time, samples/s, the scaling efficiency
and the SNR.

    # one process over every card of this host (no launcher environment)
    python -m dsp_audio_project_tpu_torch.scripts.pod_scaling
    # one process a card, NCCL; --channel-hosts 1: 1x4, 4: 4x1, 2: 2x2
    torchrun --standalone --nproc-per-node 4 \\
        -m dsp_audio_project_tpu_torch.scripts.pod_scaling --channel-hosts 2
    # processes started by hand (a file rendezvous needs no free port);
    # --device cpu runs the plain versions over gloo
    python -m dsp_audio_project_tpu_torch.scripts.pod_scaling \\
        --coordinator file:///tmp/rdzv --num-processes 2 --process-id 0 \\
        --device cpu --seconds 0.5 --channels 2

The arguments, configuration (160/147, the five-band gains, ``src_fast =
eq_fast = True``, the fused route) and input (``default_rng(0)
.standard_normal((C, n)) * 0.4``) are the JAX script's.  Where the JAX
script falls back to one process over the local devices, so does this one,
and ``--channel-hosts`` then names the channel rows of that mesh over this
host's cards (it must divide their count).

Timing: the pipeline is built once (``build_sharded_pipeline``), the
shards go to their cards, one call warms up, and ``--reps`` calls of
``fn(shards)`` follow, each ended by a synchronise of this process's cards
and a barrier of every rank, the same count on every rank.  dt is their
mean.  The gather (``gather_grid`` and ``unshard_signal``) is timed once,
apart.  The single-card time t1 comes from the same run: rank 0 runs the
same route on a 1x1 mesh of its own card on the same input, ``--reps``
calls timed the same way, while the other ranks wait at a barrier.  The
efficiency is (t1 / n_dev) / dt.  The device time of each card comes from
``utils/deviceprof`` over three calls, with the share of the collectives'
own device work named: NCCL's kernels between processes (their time
includes their waits for the other ranks), the peer copies (``Memcpy
PtoP``) within one.  Each timed call is also split into the host's
enqueue, its wait for the cards and the barrier, and each card's span of
the call is read between CUDA events: a span near the enqueue time and
well above the card's device time means the host sets the pace.

Gates: every channel >= 60 dB against ``oracle.pipeline_oracle`` and >= 110
dB against the 1x1 z; a failed gate exits 1 on every rank.  Without a
card the script raises unless ``--device cpu`` is given; a CPU run's times
are host times and it profiles no device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..bench import FS, serving_config
from ..config import MeshConfig
from ..oracle import pipeline_oracle, snr_db
from ..parallel import distributed
from ..parallel.collectives import gather_grid
from ..parallel.mesh import (
    BLOCK_AXIS, build_mesh, shard_signal, single_device_mesh,
    unshard_signal,
)
from ..parallel.pipeline import build_sharded_pipeline
from ..utils.device import default_device
from ..utils.deviceprof import profile_device_span

ORACLE_DB = 60.0         # the JAX script's gate, here on every channel
INVARIANCE_DB = 110.0    # against the same run's 1x1 z
PROFILE_CALLS = 3


def scaling_efficiency(t1: float, n_dev: int, dt: float) -> float:
    """The share of perfect scaling: the single-card time split over
    ``n_dev`` cards, over the time the ``n_dev`` cards took."""
    return (t1 / n_dev) / dt


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m dsp_audio_project_tpu_torch.scripts.pod_scaling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--channel-hosts", type=int, default=None,
                    help="rows of the channel axis (default: one a process;"
                         " in one process: 1)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions over gloo (tests)")
    return ap.parse_args(argv)


def card_lines() -> list:
    """Each card's index, name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def local_mesh(device: torch.device, channel_hosts: Optional[int]):
    """The single-process mesh: every card of this host, ``channel_hosts``
    rows (default 1); on the CPU one shard."""
    ch = channel_hosts or 1
    if device.type == "cpu":
        if ch != 1:
            raise ValueError("a single-process CPU run has one shard")
        return single_device_mesh("cpu")
    cards = torch.cuda.device_count()
    if cards % ch:
        raise ValueError(f"channel_hosts={ch} must divide the card count "
                         f"{cards}")
    return build_mesh(MeshConfig(channel_devices=ch, block_devices=cards // ch))


def _padded(x: np.ndarray, sp, mesh_block: int) -> torch.Tensor:
    xp = torch.zeros((sp.c_pad, sp.n_in_local * mesh_block))
    xp[: x.shape[0], : x.shape[1]] = torch.from_numpy(x)
    return xp


class _Clock:
    """Ends a call: a synchronise of this process's cards, then (across
    processes) a barrier."""

    def __init__(self, mesh, joined: bool):
        self.cards = sorted({mesh.device_of(c, b)
                             for c, b in mesh.local_shards
                             if mesh.device_of(c, b).type == "cuda"},
                            key=lambda d: d.index)
        self.joined = joined

    def sync_cards(self) -> None:
        for dev in self.cards:
            torch.cuda.synchronize(dev)

    def sync(self) -> None:
        self.sync_cards()
        if self.joined:
            dist.barrier()

    def reps(self, fn, reps: int) -> dict:
        """``reps`` untimed calls, then ``reps`` timed ones, each ended by
        ``sync``: the ms of each timed call ("ms") and their means split
        into the host's enqueue (until ``fn`` returns), its wait for the
        cards and the barrier; with cards, each card's span of each call
        between CUDA events recorded before and after it ("span_ms",
        kernels and the gaps between them)."""
        for _ in range(reps):
            fn()
            self.sync()
        out = {"ms": [], "enqueue": [], "wait": [], "barrier": [],
               "span_ms": {d.index: [] for d in self.cards}}
        for _ in range(reps):
            ev = {d.index: (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                  for d in self.cards}
            for d in self.cards:
                ev[d.index][0].record(torch.cuda.current_stream(d))
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            for d in self.cards:
                ev[d.index][1].record(torch.cuda.current_stream(d))
            self.sync_cards()
            t2 = time.perf_counter()
            if self.joined:
                dist.barrier()
            t3 = time.perf_counter()
            out["ms"].append((t3 - t0) * 1e3)
            for key, a, b in (("enqueue", t0, t1), ("wait", t1, t2),
                              ("barrier", t2, t3)):
                out[key].append((b - a) * 1e3)
            for card, (start, end) in ev.items():
                out["span_ms"][card].append(start.elapsed_time(end))
        return out


def _device_profile(fn, clock: _Clock) -> list:
    """[(card, device ms a call, collective ms a call)] of this process's
    cards over ``PROFILE_CALLS`` calls of ``fn``.  The ranks start their
    profilers at different moments, so the thunk opens with a barrier, whose
    all-reduce absorbs that skew and is left out (``fn`` has none)."""
    def calls():
        if clock.joined:
            dist.barrier()
        for _ in range(PROFILE_CALLS):
            fn()
        clock.sync_cards()

    prof = profile_device_span(calls, top=None)
    out = []
    for dev in clock.cards:
        rows = [(name, ms) for name, ms in prof.by_device.get(dev.index, [])
                if "AllReduce" not in name]
        coll = sum(ms for name, ms in rows
                   if "nccl" in name.lower() or name.startswith("Memcpy PtoP"))
        out.append((dev.index, sum(ms for _, ms in rows) / PROFILE_CALLS,
                    coll / PROFILE_CALLS))
    if clock.joined:
        dist.barrier()
    return out


def run(args: argparse.Namespace) -> dict:
    """The run; returns what ``report`` prints (z included, on every rank).
    Leaves the process group (if any) joined."""
    device = (torch.device(args.device) if args.device is not None
              else default_device("pod_scaling"))
    try:
        device = distributed.initialize(args.coordinator, args.num_processes,
                                        args.process_id, device=device)
        joined = True
    except ValueError:
        # No launcher environment and no coordinator: one process over the
        # local cards, as the JAX script falls back to.
        if args.coordinator is not None:
            raise
        joined = False
    mesh = (distributed.multihost_mesh(args.channel_hosts) if joined
            else local_mesh(device, args.channel_hosts))
    primary = distributed.is_primary()
    n_dev = len(mesh.devices) * len(mesh.devices[0])
    procs = distributed.process_count()
    mesh_block = mesh.shape[BLOCK_AXIS]
    cuda = device.type == "cuda"

    n, C = int(args.seconds * FS), args.channels
    cfg = serving_config()
    x = (np.random.default_rng(0).standard_normal((C, n)) * 0.4
         ).astype(np.float32)
    clock = _Clock(mesh, joined)

    t0 = time.perf_counter()
    fn, sp = build_sharded_pipeline(mesh, cfg, FS, n, C, fused=True)
    shards = shard_signal(mesh, _padded(x, sp, mesh_block))
    z_sh, _ = fn(shards)
    clock.sync()
    first_s = time.perf_counter() - t0
    timed = clock.reps(lambda: fn(shards), args.reps)

    t0 = time.perf_counter()
    z = unshard_signal(gather_grid(mesh, z_sh))
    clock.sync()
    gather_s = time.perf_counter() - t0
    z = z[:C, : sp.n_out].cpu().numpy()

    cards = [torch.cuda.get_device_name(d) for d in clock.cards]
    prof = _device_profile(lambda: fn(shards), clock) if cuda else []
    split = {k: float(np.mean(timed[k]))
             for k in ("enqueue", "wait", "barrier")}
    mine = {"cards": cards, "prof": prof, "split": split,
            "spans": {card: float(np.mean(v))
                      for card, v in timed["span_ms"].items()}}
    everyone = [mine]
    if joined:
        everyone = [None] * procs
        dist.all_gather_object(everyone, mine)
    cards = [c for rank in everyone for c in rank["cards"]]
    prof = [p for rank in everyone for p in rank["prof"]]
    spans = {card: ms for rank in everyone
             for card, ms in rank["spans"].items()}
    splits = [rank["split"] for rank in everyone]
    del everyone

    # t1: the same route on a 1x1 mesh of rank 0's card, the others
    # waiting at the barrier.
    t1 = z1 = None
    t1_times = []
    if primary:
        mesh1 = single_device_mesh(clock.cards[0] if cuda else "cpu")
        fn1, sp1 = build_sharded_pipeline(mesh1, cfg, FS, n, C, fused=True)
        shards1 = shard_signal(mesh1, _padded(x, sp1, 1))
        z1 = fn1(shards1)[0][(0, 0)]
        clock1 = _Clock(mesh1, False)
        clock1.sync()
        t1_times = clock1.reps(lambda: fn1(shards1), args.reps)["ms"]
        t1 = float(np.mean(t1_times)) / 1e3
        z1 = z1[:C, : sp.n_out].cpu().numpy()
        del fn1, shards1
    if joined:
        dist.barrier()

    ok, snr_oracle, snr_1x1 = True, [], []
    if primary:
        for c in range(C):
            want, _ = pipeline_oracle(x[c], FS, cfg.src, cfg.eq,
                                      engine="fast")
            snr_oracle.append(snr_db(want, z[c]))
            snr_1x1.append(snr_db(z1[c], z[c]))
        ok = (min(snr_oracle) >= ORACLE_DB
              and min(snr_1x1) >= INVARIANCE_DB and z.shape == z1.shape)
    if joined:
        verdict = [ok]
        dist.broadcast_object_list(verdict, src=0)
        ok = verdict[0]

    dt = float(np.mean(timed["ms"])) / 1e3
    return {
        "primary": primary, "joined": joined,
        "backend": dist.get_backend() if joined else None,
        "mesh": dict(mesh.shape), "n_dev": n_dev, "processes": procs,
        "device": str(device), "cards": cards,
        "card_lines": card_lines() if cuda and primary else [],
        "seconds": args.seconds, "channels": C, "n": n,
        "frames_local": sp.frames_local, "first_s": first_s,
        "rep_ms": timed["ms"], "dt_ms": dt * 1e3, "splits": splits,
        "span_ms": spans, "gather_ms": gather_s * 1e3,
        "t1_ms": None if t1 is None else t1 * 1e3, "t1_rep_ms": t1_times,
        "efficiency": (scaling_efficiency(t1, n_dev, dt) if primary
                       else None),
        "samples_per_s": C * n / dt,
        "device_ms": prof, "snr_oracle": snr_oracle, "snr_1x1": snr_1x1,
        "z": z, "ok": ok,
    }


def say(msg: str) -> None:
    print(msg, flush=True)


def report(res: dict) -> None:
    """Rank 0's lines; the other ranks print nothing."""
    if not res["primary"]:
        return
    where = ("the CPU (host times; no device profile)"
             if res["device"] == "cpu" else f"{res['n_dev']} card(s)")
    if not res["joined"]:
        say("torch.distributed: no launcher environment and no "
            f"coordinator; single-process run over {where}")
    say(f"mesh: {res['mesh']} over {res['n_dev']} shard(s) on {where} / "
        f"{res['processes']} process(es)"
        + (f" ({res['backend']})" if res["joined"] else ""))
    for line in res["card_lines"]:
        say(f"nvidia-smi: {line}")
    for i, name in enumerate(res["cards"]):
        say(f"shard {i}: {name}")
    C, n = res["channels"], res["n"]
    say(f"input {C} x {res['seconds']:g} s ({n} samples a channel); "
        f"{res['frames_local']} frames a shard; build + first call "
        f"{res['first_s']:.2f} s")
    dt, n_dev = res["dt_ms"], res["n_dev"]
    sps = res["samples_per_s"]
    reps = res["rep_ms"]
    unit = "shard" if res["device"] == "cpu" else "card"
    say(f"steady-state: {dt:.4f} ms/rep (mean of {len(reps)}; median "
        f"{np.median(reps):.4f}, min {min(reps):.4f}, max {max(reps):.4f}) "
        f"-> {sps / 1e9:.3f} G input samples/s total "
        f"({sps / n_dev / 1e9:.3f} G/{unit})")
    for rank, sp in enumerate(res["splits"]):
        say(f"rank {rank} per rep (mean): host enqueue {sp['enqueue']:.4f} "
            f"ms, then the wait for its cards {sp['wait']:.4f} ms, the "
            f"barrier {sp['barrier']:.4f} ms")
    for card, ms in sorted(res["span_ms"].items()):
        say(f"card {card}: a call's span on the card (CUDA events before "
            f"and after it, kernels and gaps) {ms:.4f} ms (mean)")
    say(f"gather (gather_grid + unshard_signal, apart, once): "
        f"{res['gather_ms']:.4f} ms")
    t1r = res["t1_rep_ms"]
    say(f"single card (the same route on a 1x1 mesh of rank 0's card, this "
        f"run): t1 = {res['t1_ms']:.4f} ms/rep (mean of {len(t1r)}; median "
        f"{np.median(t1r):.4f}, min {min(t1r):.4f}, max {max(t1r):.4f})")
    say(f"scaling efficiency vs t1: {100 * res['efficiency']:.1f}% = "
        f"(t1 / {n_dev}) / dt = ({res['t1_ms']:.4f} / {n_dev}) / "
        f"{dt:.4f}")
    for card, ms, coll in res["device_ms"]:
        share = 100 * coll / ms if ms else 0.0
        say(f"device ms per call, card {card} (profiler, {PROFILE_CALLS} "
            f"calls): {ms:.4f} ms, collectives (NCCL kernels / peer copies) "
            f"{coll:.4f} ms = {share:.1f}%")
    say(f"snr vs oracle: min {min(res['snr_oracle']):.1f} dB over {C} "
        f"channel(s) (gate {ORACLE_DB:g} on each)")
    say(f"snr vs 1x1: min {min(res['snr_1x1']):.1f} dB over {C} channel(s) "
        f"(gate {INVARIANCE_DB:g} on each)")
    say("gates " + ("passed" if res["ok"] else "FAILED"))


def main(argv=None) -> int:
    res = run(parse_args(argv))
    report(res)
    if res["joined"]:
        dist.destroy_process_group()
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
