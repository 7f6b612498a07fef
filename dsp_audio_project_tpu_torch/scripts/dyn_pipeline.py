"""The dynamic-serving cycle, measured: steady, serial and pipelined loops.

    python -m dsp_audio_project_tpu_torch.scripts.dyn_pipeline [cycles]

Counterpart of the repo's ``scripts/dyn_pipeline.py`` (default 8 cycles)
at 8 x 60 s on the serving config.  A cycle is one gain change and one
batch through ``jit_forward_frames_dynamic_ops()`` (the frames kernel, the
EQ apply, K9; one CUDA graph, replayed, that copies the operators it is
given into its own buffers on every call):

  steady    - every batch at fixed operators (the per-batch floor);
  serial    - the host builder's numpy tables for gains k, their upload,
              the expand, then the batch;
  pipelined - batch k enqueued, the host tables of gains k + 1 built while
              it runs, then their upload and the expand.

The expand (the host builder's device half, ``_expand_dyn_operators``) is
a ``CompiledForward`` too: a gain change copies the new host tables into
its graph's buffers and replays it, where the JAX script calls its jitted
expand.  Its operators are held bit for bit against the eager expand.
Each loop reports its wall ms a cycle (host clock, the card synchronized
each cycle) and, run again under the profiler (``utils/deviceprof``),
its device ms a cycle.  Needs the card.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import bench
from ..models.chain import AudioPipeline
from ..ops.eq_dynamic import (
    _expand_dyn_operators, host_dyn_tables, upload_dyn_tables,
)
from ..utils.device import CompiledForward
from ..utils.deviceprof import profile_device_span

FS = bench.FS
BATCH = bench.BATCH


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cycles: int = 8) -> dict:
    """{loop: (wall ms a cycle, device ms a cycle)} for steady, serial and
    pipelined."""
    if not torch.cuda.is_available():
        raise RuntimeError("dyn_pipeline times the card and none is visible")
    cfg = bench.serving_config()
    pipe = AudioPipeline(cfg)
    dev = pipe.device
    n = int(bench.SECONDS * FS)
    v = torch.as_tensor(
        (0.3 * np.random.default_rng(0).standard_normal((BATCH, n))
         ).astype(np.float32), device=dev)
    fwd = pipe.jit_forward_frames_dynamic_ops()
    names = [nm for nm, _ in cfg.eq.band_centers]
    gain_seq = [
        np.asarray([float(((k * 7 + i * 3) % 31) - 15)
                    for i in range(len(names))])
        for k in range(cycles + 1)
    ]
    U, G, K = pipe.dynamic_eq_geometry(FS, n)
    fs_out = cfg.src.output_rate(FS)

    def host_phase(g):
        return host_dyn_tables(g, fs_out, cfg.eq, U, G, K)

    # expand(*host tables, fs_out) -> DynOperators; the rate is static.
    graph_expand = CompiledForward(
        lambda *a: _expand_dyn_operators(*a[:-1]), dev, "the expand")

    def expand(tabs):
        return graph_expand(*tabs, fs_out)

    last = host_phase(gain_seq[cycles])
    got = expand(last)
    want = _expand_dyn_operators(*upload_dyn_tables(last, dev))
    torch.cuda.synchronize()
    for name, a, b in zip(want._fields, got, want):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise RuntimeError(f"the graph expand's {name} differs from the "
                               "eager expand's")
    del got
    ops0 = pipe.dynamic_eq_operators(gain_seq[0], FS, n, builder="host")
    fwd(v, ops0, FS)
    torch.cuda.synchronize()
    host_ms = []

    def steady():
        for _ in range(cycles):
            fwd(v, ops0, FS)
            torch.cuda.synchronize()

    def serial():
        for k in range(cycles):
            fwd(v, expand(host_phase(gain_seq[k])), FS)
            torch.cuda.synchronize()

    ready = {}

    def start():
        """The operators of gains 0, ready before a pipelined loop."""
        ready["ops"] = expand(host_phase(gain_seq[0]))
        torch.cuda.synchronize()

    def pipelined():
        ops = ready.pop("ops")
        for k in range(cycles):
            fwd(v, ops, FS)                       # enqueued
            th = time.perf_counter()
            tabs = host_phase(gain_seq[k + 1])   # while the batch runs
            host_ms.append((time.perf_counter() - th) * 1e3)
            torch.cuda.synchronize()
            ops = expand(tabs)
        torch.cuda.synchronize()

    res = {}
    for name, loop in (("steady", steady), ("serial", serial),
                       ("pipelined", pipelined)):
        start()
        t0 = time.perf_counter()
        loop()
        wall = (time.perf_counter() - t0) / cycles * 1e3
        start()
        res[name] = (wall, profile_device_span(loop).total_ms / cycles)
    log(f"cycles={cycles} batch={BATCH} x {bench.SECONDS:.0f} s  host build "
        f"{min(host_ms):.2f}-{max(host_ms):.2f} ms (median "
        f"{float(np.median(host_ms)):.2f}), the expand a replayed CUDA graph")
    log("wall per cycle: " + ", ".join(f"{k} {w:.3f} ms"
                                       for k, (w, _) in res.items()))
    log("device per cycle: " + ", ".join(f"{k} {d:.3f} ms"
                                         for k, (_, d) in res.items()))
    w0, d0 = res["steady"]
    log(f"measured cycle efficiency vs steady: serial "
        f"{w0 / res['serial'][0] * 100:.1f}%, pipelined "
        f"{w0 / res['pipelined'][0] * 100:.1f}% (wall); device-side "
        f"pipelined {d0 / res['pipelined'][1] * 100:.1f}%")
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else 8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
