"""CUDA-event timing of calls on the card.

Counterpart of ``dsp_audio_project_tpu/utils/benchmarking.py``, with the
same functions and results.  A PyTorch call returns once its work is
enqueued, so each timing records a ``torch.cuda.Event(enable_timing=True)``
on the current stream before the first call and after the last one, and
``synchronize()``s on the second: the time between them is what the
device's stream took for those calls, including any time it waited for the
host to enqueue them.  When the host is slower than the kernels (the
port's chains at batch 8, PERF.md section 5), that is the host's time; a
device profile (``deviceprof``) gives the kernels' own.  ``measure_device``
hides the host instead: a spin kernel holds the stream while the host
enqueues the timed calls, so its events see the device's time alone, with
no profiler (whose records a short session can lose, ``deviceprof``).

Without a CUDA device, or for a function whose output holds tensors none
of which is on a CUDA device, these raise: there is no host-clock
fallback.
"""
from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from .profiling import tensors

SPIN_CYCLES = 100_000_000    # the spin of measure_device: ~50 ms at ~2 GHz
DEVICE_PASSES = 5            # measure_device's passes; the median is kept
SPIN_HEADROOM = 4            # the spin lasts at least 4x the host's enqueue


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA-event timing needs a CUDA device and none "
                           "is visible")


def _check_on_card(out) -> None:
    ts = list(tensors(out))
    if ts and not any(t.is_cuda for t in ts):
        raise RuntimeError("the timed function returned no CUDA tensor: a "
                           "CPU function cannot be timed with CUDA events")


def _timed_queue(fn: Callable, inputs: Sequence) -> float:
    """Seconds of CUDA-event time for ``fn(*args)`` over ``inputs``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = None
    start.record()
    for args in inputs:
        out = fn(*args)
    end.record()
    end.synchronize()
    _check_on_card(out)
    return start.elapsed_time(end) / 1e3


def measure(
    fn: Callable,
    inputs: Sequence,
    *,
    warmup_input=None,
    warmup_inputs: Sequence = (),
    passes: int = 1,
) -> float:
    """Median over ``passes`` of the seconds per call of one queue of
    ``fn(*args)`` for each argument tuple of ``inputs``, back to back.

    The warm-up inputs run first (the first calls build kernels and table
    caches), then the device is synchronized.  Repeating inputs across
    passes is valid on the card: CUDA caches no results.
    """
    _require_card()
    warm = list(warmup_inputs)
    if warmup_input is not None:
        warm.insert(0, warmup_input)
    for args in warm:
        _check_on_card(fn(*args))
    torch.cuda.synchronize()
    per_pass = sorted(_timed_queue(fn, inputs) / len(inputs)
                      for _ in range(passes))
    return per_pass[len(per_pass) // 2]


def measure_differential(
    fn: Callable,
    inputs: Sequence,
    *,
    short_fraction: float = 0.25,
) -> float:
    """Seconds per call from two queue lengths: the slope of time against
    call count, (T_long - T_short) / (n_long - n_short), which removes a
    constant cost per queue (the first call's launch latency, the final
    synchronize).  The first ``short_fraction`` of ``inputs`` is the short
    queue, the rest the long one."""
    _require_card()
    n_short = max(1, int(len(inputs) * short_fraction))
    short, long_ = inputs[:n_short], inputs[n_short:]
    if len(long_) <= n_short:
        raise ValueError("need more inputs than the short queue")
    t_short = _timed_queue(fn, short)
    t_long = _timed_queue(fn, long_)
    return max(1e-9, (t_long - t_short) / (len(long_) - len(short)))


def measure_batched_differential(
    build_fn: Callable[[int], Callable],
    make_batch: Callable[[int], tuple],
    sizes: tuple = (4, 12),
    reps: int = 3,
) -> float:
    """Seconds per batch item from two batch sizes: ``build_fn(B)`` returns
    a callable taking ``make_batch(B)``'s arguments; (T(B2) - T(B1)) /
    (B2 - B1) cancels the per-call costs that do not grow with the batch.
    Each size runs twice first (warm-up), then the least positive estimate
    over ``reps`` fresh batch pairs is kept."""
    _require_card()
    b1, b2 = sizes
    f1, f2 = build_fn(b1), build_fn(b2)
    for f, b in ((f1, b1), (f2, b2)):
        for _ in range(2):
            _check_on_card(f(*make_batch(b)))
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a1, a2 = make_batch(b1), make_batch(b2)
        est = (_timed_queue(f2, [a2]) - _timed_queue(f1, [a1])) / (b2 - b1)
        if 0 < est < best:
            best = est
    return best


def _spin_seconds(cycles: int) -> float:
    """CUDA-event seconds of one ``torch.cuda._sleep(cycles)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def spin_cycles(host_s: float, spin_s: float,
                cycles: int = SPIN_CYCLES) -> int:
    """Cycles of the spin that hides ``host_s`` of host enqueue: ``cycles``
    (which took ``spin_s`` on the card), scaled up where needed so that the
    spin lasts SPIN_HEADROOM times the host's time."""
    need = SPIN_HEADROOM * host_s
    if need <= spin_s:
        return cycles
    return int(cycles * need / spin_s) + 1


def measure_device(fn: Callable, *args, calls: int = 10) -> float:
    """Median over DEVICE_PASSES of the device seconds per call of ``calls``
    calls of ``fn(*args)`` in a row, after one warm-up call.

    Each pass enqueues a spin kernel (``torch.cuda._sleep``), then the
    start event, the calls and the end event; the device reaches the start
    event with all of them queued, so the time between the events is the
    device's: the kernels and the gaps between them.  The spin is at least
    SPIN_CYCLES and lasts SPIN_HEADROOM times the host's enqueue of
    ``calls`` calls, timed once after the warm-up (``spin_cycles``): a
    function with many small launches, or a slow host, gets a longer spin.
    ``fn`` must not wait for the device: a pass whose enqueue took half the
    spin or more (a call that synchronized, which waits out any spin, or a
    host slower than that) raises.
    """
    _require_card()
    _check_on_card(fn(*args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    probe_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = spin_cycles(probe_s, _spin_seconds(SPIN_CYCLES))
    spin_s = _spin_seconds(cycles)
    per_pass = []
    for _ in range(DEVICE_PASSES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        host_s = time.perf_counter() - t0
        end.synchronize()
        if host_s >= 0.5 * spin_s:
            raise RuntimeError(
                f"the host took {host_s * 1e3:.1f} ms to enqueue {calls} "
                f"calls against a {spin_s * 1e3:.1f} ms spin: the function "
                "waits for the device, or the host is too slow to hide")
        per_pass.append(start.elapsed_time(end) / 1e3 / calls)
    per_pass.sort()
    return per_pass[len(per_pass) // 2]
