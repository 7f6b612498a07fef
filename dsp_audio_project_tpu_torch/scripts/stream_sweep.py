"""The sharded stream's super-step size against the one-shot chain.

    python -m dsp_audio_project_tpu_torch.scripts.stream_sweep [FL ...]

Counterpart of the repo's ``scripts/stream_sweep.py`` (default FL: 1024,
2048, 4096, 8192 frames a step; C = 8 channels on a 1x1 mesh, the bench's
serving config, a seeded signal long enough for three steps at the largest
FL and at least 120 s).  For each FL: the first step (its graph capture)
is fed alone, then one step's input a call; a processor under the
profiler (``utils/deviceprof``) gives the device ms a step and its rate,
then a second one, timed by the host clock, the wall ms a step and the
wall input samples/s.  Beside them stands the bench's own one-shot rate of the same work,
``forward_cat`` at 8 x 60 s timed as ``bench.time_call`` times it (call
and device).  Needs the card.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import bench
from ..models.chain import AudioPipeline
from ..ops.src import make_plan
from ..parallel.mesh import single_device_mesh
from ..streaming import ShardedStreamProcessor
from ..utils.deviceprof import profile_device_span

DEFAULT_FLS = (1024, 2048, 4096, 8192)
CHANNELS = 8
FS = bench.FS


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def one_shot_rates(cfg) -> tuple:
    """(call, device) input samples/s of ``forward_cat`` at batch 8 x 60 s."""
    pipe = AudioPipeline(cfg)
    n = int(bench.SECONDS * FS)
    batches = bench.device_batches(bench.make_signal(n, FS),
                                   bench.TIMED_BATCHES, pipe.device)
    t = bench.time_call(lambda v: pipe.forward_cat(v, FS), batches)
    samples = bench.BATCH * n
    return samples / t["call"] * 1e3, samples / t["device"] * 1e3


def run(fls=DEFAULT_FLS) -> list:
    """[(FL, steps, wall ms a step, device ms a step, wall samples/s,
    device samples/s)]."""
    if not torch.cuda.is_available():
        raise RuntimeError("stream_sweep times the card and none is visible")
    cfg = bench.serving_config()
    plan = make_plan(cfg.src.L, cfg.src.M, cfg.src.taps_rule_factor)
    mesh = single_device_mesh()
    seconds = max(120.0, max(fls) * plan.s * 3.2 / FS)
    n = int(seconds * FS)
    xs = (np.random.default_rng(3).standard_normal((CHANNELS, n))
          * 0.4).astype(np.float32)
    call_sps, dev_sps1 = one_shot_rates(cfg)
    log(f"device: {torch.cuda.get_device_name(0)}  C={CHANNELS}  signal="
        f"{seconds:.0f} s; one-shot forward_cat (bench.time_call, 8 x 60 s): "
        f"{call_sps:.4e} input samples/s a call, {dev_sps1:.4e} device")
    out = []
    for fl in fls:
        in_step = fl * plan.s
        first = in_step + plan.W

        def processor(fl=fl):
            return ShardedStreamProcessor(cfg, FS, mesh, CHANNELS,
                                          frames_per_shard=fl)

        # The profiled pass first: it fills the pinned host allocator's
        # pool for this step size before the timed pass (bench_stream).
        _, _, prof = bench.stream_pass(processor(), xs, first, in_step,
                                       profile_device_span)
        outs, wall_s, _ = bench.stream_pass(processor(), xs, first, in_step)
        steps = sum(o.shape[1] for o in outs[1:]) / (fl * plan.P)
        if steps < 2:
            log(f"FL={fl}: signal too short for a steady state, skipping")
            continue
        if not all(np.isfinite(o).all() for o in outs):
            raise RuntimeError(f"FL={fl}: the stream's output is not finite")
        samples = steps * CHANNELS * in_step
        wall_sps = samples / wall_s
        dev_sps = samples / (prof.total_ms / 1e3)
        log(f"FL={fl}: {steps:g} steps; device {prof.total_ms / steps:.4f} "
            f"ms/step -> {dev_sps:.4e} samples/s ({dev_sps / dev_sps1 * 100:.1f}"
            f"% of the one-shot device rate); wall {wall_s / steps * 1e3:.3f} "
            f"ms/step -> {wall_sps:.4e} samples/s ({wall_sps / call_sps * 100:.1f}"
            "% of the one-shot call rate)")
        for op, ms in prof.ops[:6]:
            log(f"    {op[:70]}: {ms / steps:.4f} ms/step")
        out.append((fl, steps, wall_s / steps * 1e3, prof.total_ms / steps,
                    wall_sps, dev_sps))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run([int(a) for a in argv] or DEFAULT_FLS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
