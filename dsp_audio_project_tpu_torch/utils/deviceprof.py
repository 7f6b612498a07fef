"""Device time by kernel from ``torch.profiler``.

Counterpart of ``dsp_audio_project_tpu/utils/deviceprof.py``.  A call runs
under ``torch.profiler.profile`` with CPU and CUDA activities and ends in
``torch.cuda.synchronize()``; ``key_averages()`` then holds a row per name.
``device_rows`` decides which rows are device work: device time > 0
(``self_device_time_total``, ``self_cuda_time_total`` on older torch), no
CPU time of its own, not the profiler's ``ProfilerStep`` span and not a
user annotation (a ``trace_stage`` span mirrored on the device timeline,
which covers kernels already counted).  Those rows are kernels, copies and
fills.  ``stage_spans`` lists the user annotations apart.

The total is the sum of the device rows.  The JAX version takes the
longest XLA program for one call and sums programs for a span; the port
has no outer program, so both sum the kernels.  Work on several streams at
once is summed, not overlapped; ``by_device`` splits the rows by card (a
call over several cards of one process).  A profile with no device row
raises: a call that ran on the card shows its kernels.

On an H100 (torch 2.11, CUDA 12.8) the profiler loses kernel records at
the edges of a short session, now and then every one of them: a session
of one call of a two-kernel FFT came back empty a few times in a hundred.
A quiet host interval at both ends kept them, so a session opens and
closes with ``EDGE_S`` of host sleep around the work (the sleep adds no
device time; ``tests/test_torch_gpu.py`` runs 200 such one-call sessions
and wants every one to hold its kernels).  Where a short call needs a
device time and does not wait for the host,
``utils/benchmarking.measure_device`` takes it without the profiler.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, \
    Tuple

import torch

EDGE_S = 0.02     # host sleep at each end of a profiler session (see above)


class DeviceProfile(NamedTuple):
    """One profiled call: its device time and the rows it is made of."""

    total_ms: float                       # sum of the device rows
    ops: List[Tuple[str, float]]          # (name, ms), the top rows
    spans: List[Tuple[str, float]]        # (trace_stage name, device ms)
    # {device index: [(name, ms)]}, every device row of each card
    by_device: Dict[int, List[Tuple[str, float]]]


def _device_us(evt) -> float:
    us = getattr(evt, "self_device_time_total", None)
    return us if us is not None else getattr(evt, "self_cuda_time_total", 0.0)


def _is_annotation(evt) -> bool:
    return bool(getattr(evt, "is_user_annotation", False))


def _is_device_work(evt) -> bool:
    return (_device_us(evt) > 0 and evt.self_cpu_time_total == 0
            and not evt.key.startswith("ProfilerStep")
            and not _is_annotation(evt))


def device_rows(events: Iterable) -> List[Tuple[str, float, int]]:
    """(name, device µs, count) of each device-work row of a
    ``key_averages()`` list, longest first (see the module note)."""
    rows = [(evt.key, _device_us(evt), evt.count) for evt in events
            if _is_device_work(evt)]
    rows.sort(key=lambda r: -r[1])
    return rows


def rows_by_device(events: Iterable) -> Dict[int, List[Tuple[str, float]]]:
    """{device index: [(name, device ms)]}, longest first, of the device
    work among single profiler events (``prof.events()``, each kernel or
    copy with its card), by the rule of ``device_rows``."""
    acc: Dict[int, Dict[str, float]] = {}
    for evt in events:
        if _is_device_work(evt):
            card = acc.setdefault(evt.device_index, {})
            card[evt.key] = card.get(evt.key, 0.0) + _device_us(evt) / 1e3
    return {idx: sorted(rows.items(), key=lambda kv: -kv[1])
            for idx, rows in acc.items()}


def stage_spans(events: Iterable) -> List[Tuple[str, float]]:
    """(name, device µs) of each user annotation of a ``key_averages()``
    list other than ``ProfilerStep``: the device time of the kernels under
    a host span, or the span's length on the device timeline, the larger."""
    spans: dict = {}
    for evt in events:
        if _is_annotation(evt) and not evt.key.startswith("ProfilerStep"):
            us = max(evt.device_time_total, _device_us(evt))
            spans[evt.key] = max(spans.get(evt.key, 0.0), us)
    return sorted(spans.items(), key=lambda kv: -kv[1])


def profile_device_span(thunk: Callable[[], object],
                        top: Optional[int] = 20) -> DeviceProfile:
    """Run ``thunk()`` under the profiler and return the device time of
    everything it ran: (total ms, [(kernel, ms)] of the ``top`` rows (None:
    all), [(stage span, ms)], each card's rows).  The profiler synchronises
    the current card; a thunk that runs on other cards synchronises them
    itself."""
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("a device profile needs a CUDA device and none "
                           "is visible")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        time.sleep(EDGE_S)
        thunk()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    events = prof.key_averages()
    rows = device_rows(events)
    if not rows:
        raise RuntimeError("the profiler recorded no device activity for "
                           "this call")
    return DeviceProfile(
        total_ms=sum(r[1] for r in rows) / 1e3,
        ops=[(name, us / 1e3) for name, us, _ in rows[:top]],
        spans=[(name, us / 1e3) for name, us in stage_spans(events)],
        by_device=rows_by_device(prof.events()),
    )


def profile_device_ops(fn: Callable, *args, top: int = 20) -> DeviceProfile:
    """``profile_device_span`` of one call ``fn(*args)``."""
    return profile_device_span(lambda: fn(*args), top=top)


def print_profile(fn: Callable, *args, top: int = 20) -> float:
    """Print one call's device time by kernel; return the total ms."""
    prof = profile_device_ops(fn, *args, top=top)
    print(f"device total: {prof.total_ms:.3f} ms")
    for name, ms in prof.ops:
        print(f"  {ms:8.3f} ms  {name}")
    for name, ms in prof.spans:
        print(f"  span {name}: {ms:.3f} ms")
    return prof.total_ms
