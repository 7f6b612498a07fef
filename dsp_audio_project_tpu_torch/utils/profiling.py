"""Stage spans, a stage timer and the HBM roofline share.

Counterpart of ``dsp_audio_project_tpu/utils/profiling.py``.
``trace_stage(name)`` opens a ``torch.profiler.record_function`` span
while a profiler runs, and nothing otherwise (a span is two dispatcher
calls, host time on a path whose call time the host sets).  A span is a
host-side marker that launches nothing on the device, so it changes no
output and may sit inside a CUDA-graph capture.  Under ``torch.profiler``
each stage gets its own row in ``key_averages()`` (and, with CUDA
activity, a span on the device timeline over the kernels it launched), as
``jax.profiler.TraceAnnotation`` marks a JAX trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, Optional

import torch
from torch.autograd import profiler as autograd_profiler

# Peak HBM bandwidth per card, bytes/s, by the prefix of
# torch.cuda.get_device_name(): NVIDIA's data sheet for the H100 SXM (used
# only for the roofline share; a card below its 700 W limit runs slower).
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100": 3.35e12,
}


def device_hbm_peak() -> Optional[float]:
    """The visible card's peak HBM bytes/s, or None without a card or for
    a card that no key of ``HBM_PEAK_BYTES_PER_S`` names."""
    if not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name().lower()
    for name, bw in HBM_PEAK_BYTES_PER_S.items():
        if kind.startswith(name.lower()):
            return bw
    return None


@contextlib.contextmanager
def trace_stage(name: str) -> Iterator[None]:
    """Mark a pipeline stage for ``torch.profiler`` (a host-side span),
    while a profiler runs."""
    # The flag torch's own profiler sets on start and clears on stop.
    if not autograd_profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


def tensors(tree) -> Iterator[torch.Tensor]:
    """The tensors of ``tree``: a tensor, or nested tuples, lists and dicts
    of them (anything else holds none)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)


@dataclasses.dataclass
class StageTimer:
    """Host-clock stage timing; a stage given a CUDA result waits for its
    device before the clock stops."""

    timings_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, result_to_block=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        for t in tensors(result_to_block):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
        self.timings_s[name] = self.timings_s.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def report(self) -> str:
        total = sum(self.timings_s.values())
        lines = [
            f"  {k}: {v*1e3:.2f} ms ({100*v/total:.0f}%)"
            for k, v in sorted(self.timings_s.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


def roofline_fraction(bytes_moved: int, seconds: float) -> Optional[float]:
    """Achieved HBM bandwidth as a fraction of the card's peak (None without
    a known card)."""
    peak = device_hbm_peak()
    if peak is None or seconds <= 0:
        return None
    return (bytes_moved / seconds) / peak
