"""The port's utils/ (profiling, benchmarking, deviceprof) and the stage
spans of its chain, on the CPU.

* ``StageTimer`` and ``roofline_fraction`` as ``tests/test_utils.py``
  holds the JAX ones; the peak table keyed by the card's name (None
  without a card or for an unknown one);
* ``trace_stage`` spans leave ``pipe(x, fs)``, ``_forward``,
  ``forward_frames``, ``forward_flat`` and ``forward_cat_spectra`` bit for
  bit as they were without them, and show under ``torch.profiler`` with
  the JAX package's names;
* ``deviceprof.device_rows`` on synthetic ``key_averages`` rows: a kernel
  counts; a CPU op, a ``ProfilerStep`` row, a zero row and a user
  annotation do not; ``rows_by_device`` splits single events by card;
* ``utils/benchmarking`` and ``deviceprof`` raise without a card and for a
  CPU function.
"""
from __future__ import annotations

import contextlib
import types

import numpy as np
import pytest
import torch

import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu_torch.models import chain
from dsp_audio_project_tpu_torch.utils import (
    benchmarking, deviceprof, profiling,
)

torch.set_num_threads(2)

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def test_stage_timer():
    t = profiling.StageTimer()
    with t.stage("a"):
        sum(range(1000))
    with t.stage("b", result_to_block=(torch.ones(3), [torch.zeros(2)])):
        pass
    assert set(t.timings_s) == {"a", "b"}
    assert all(v >= 0 for v in t.timings_s.values())
    assert "a:" in t.report()


def test_roofline_helper():
    frac = profiling.roofline_fraction(810_000_000, 1.0)
    if profiling.device_hbm_peak() is None:
        assert frac is None
    else:
        assert 0 < frac < 1.1


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12),
    ("NVIDIA H100 PCIe", 3.35e12),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_peak_keyed_by_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    assert profiling.device_hbm_peak() == peak
    frac = profiling.roofline_fraction(3.35e9, 1e-3)
    assert frac == (None if peak is None else pytest.approx(1.0))
    assert profiling.roofline_fraction(1, 0.0) is None


def _cfg(L=160, M=147):
    return pt.PipelineConfig(
        src=pt.SRCConfig(L=L, M=M), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(src_fast=True, eq_fast=True))


def _x(batch=2, n=FS // 2, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((0.3 * rng.standard_normal((batch, n))
                            ).astype(np.float32))


FORWARDS = {
    "call": (lambda p, x: p(x, FS, with_spectra=True),
             ("src_frames", "eq_frames")),
    "_forward": (lambda p, x: p._forward(x, FS), ("src", "eq")),
    "forward_frames": (lambda p, x: p.forward_frames(x, FS),
                       ("src_frames", "eq_frames")),
    "forward_flat": (lambda p, x: p.forward_flat(x, FS),
                     ("src_flat", "eq_flat")),
    "forward_cat_spectra": (lambda p, x: p.forward_cat_spectra(x, FS),
                            ("src_eq_cat",)),
    "forward_cat": (lambda p, x: p.forward_cat(x, FS), ("src_eq_cat",)),
}


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, chain.PipelineOutputs):
        return [out.output, out.resampled] + [
            m for _, m in out.spectra.values()]
    return [t for o in out for t in _tensors(o)]


@pytest.mark.parametrize("name", list(FORWARDS))
def test_spans_leave_forwards_bit_identical(monkeypatch, name):
    from torch.profiler import ProfilerActivity, profile

    fwd, spans = FORWARDS[name]
    pipe = pt.AudioPipeline(_cfg(), device="cpu")
    x = _x()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with_spans = _tensors(fwd(pipe, x))
    names = {n for n, _ in deviceprof.stage_spans(prof.key_averages())}
    assert set(spans) <= names, names
    monkeypatch.setattr(chain, "trace_stage",
                        lambda name: contextlib.nullcontext())
    without = _tensors(fwd(pipe, x))
    assert len(with_spans) == len(without)
    assert all(torch.equal(a, b) for a, b in zip(with_spans, without))


def _row(key, cpu=0.0, dev=0.0, count=1, annotation=False, total=None):
    return types.SimpleNamespace(
        key=key, count=count, self_cpu_time_total=cpu,
        self_device_time_total=dev,
        device_time_total=dev if total is None else total,
        is_user_annotation=annotation)


def test_spans_only_while_a_profiler_runs(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    opened = []
    real = torch.profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profiling.trace_stage("idle"):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.trace_stage("traced"):
            pass
    assert opened == ["traced"]


def test_device_rows_filter():
    rows = [
        _row("fir_tf32_kernel<2, true>", dev=280.0, count=3),
        _row("eq_finish_kernel", dev=75.0),
        _row("aten::mm", cpu=12.0, total=40.0),            # a CPU op
        _row("ProfilerStep#1", dev=900.0),                  # the step span
        _row("cudaLaunchKernel", cpu=5.0),                  # CPU, no device
        _row("Memset (Device)", dev=0.0),                   # a zero row
        _row("src_eq_cat", dev=300.0, annotation=True),     # a device span
        _row("src_eq_cat", cpu=20.0, annotation=True, total=280.0),
    ]
    got = deviceprof.device_rows(rows)
    assert got == [("fir_tf32_kernel<2, true>", 280.0, 3),
                   ("eq_finish_kernel", 75.0, 1)]
    assert deviceprof.stage_spans(rows) == [("src_eq_cat", 300.0)]
    # Older torch names the device time self_cuda_time_total.
    old = types.SimpleNamespace(key="k", count=2, self_cpu_time_total=0.0,
                                self_cuda_time_total=7.0)
    assert deviceprof.device_rows([old]) == [("k", 7.0, 2)]


def test_rows_by_device():
    """Single events of two cards: each card's kernels and peer copies by
    name, summed and in ms; a CPU op, a step span and an annotation on the
    device timeline count on no card."""
    def evt(key, card, **kw):
        ev = _row(key, **kw)
        ev.device_index = card
        return ev

    events = [
        evt("fir_tf32_kernel<2, true>", 0, dev=250.0),
        evt("fir_tf32_kernel<2, true>", 0, dev=250.0),
        evt("Memcpy PtoP (Device -> Device)", 1, dev=50.0),
        evt("fir_tf32_kernel<2, true>", 1, dev=260.0),
        evt("aten::mm", -1, cpu=12.0, total=40.0),
        evt("ProfilerStep#1", 0, dev=900.0),
        evt("src_eq_cat", 1, dev=300.0, annotation=True),
    ]
    assert deviceprof.rows_by_device(events) == {
        0: [("fir_tf32_kernel<2, true>", 0.5)],
        1: [("fir_tf32_kernel<2, true>", 0.26),
            ("Memcpy PtoP (Device -> Device)", 0.05)]}


@pytest.mark.parametrize("host_ms,spin_ms,want", [
    (1.0, 50.0, 100_000_000),      # the host hides behind the base spin
    (12.5, 50.0, 100_000_000),     # 4x the host is the spin itself
    (26.8, 50.5, 212_277_228),     # 10 butterfly calls on a slow host
])
def test_spin_cycles_hide_the_host(host_ms, spin_ms, want):
    """measure_device's spin: SPIN_CYCLES where it lasts 4x the host's
    enqueue, else scaled so that it does; never shorter."""
    cycles = benchmarking.spin_cycles(host_ms / 1e3, spin_ms / 1e3)
    assert cycles == want
    assert cycles >= benchmarking.SPIN_CYCLES
    spin_s = spin_ms / 1e3 * cycles / benchmarking.SPIN_CYCLES
    assert spin_s >= benchmarking.SPIN_HEADROOM * host_ms / 1e3
    assert host_ms / 1e3 < 0.5 * spin_s


def test_timing_raises_without_a_card():
    f = lambda v: v * 2  # noqa: E731
    ins = [(torch.full((64,), float(i)),) for i in range(8)]
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmarking.measure(f, ins[2:], warmup_inputs=ins[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmarking.measure_differential(f, ins)
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmarking.measure_batched_differential(
            lambda b: f, lambda b: (torch.ones(b),))
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmarking.measure_device(f, ins[0][0])
    with pytest.raises(RuntimeError, match="CUDA"):
        deviceprof.profile_device_ops(f, ins[0][0])


def test_timing_refuses_a_cpu_function(monkeypatch):
    """With a card visible, a function returning CPU tensors still raises
    (at its warm-up call, before any CUDA call)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ins = [(torch.full((64,), float(i)),) for i in range(4)]
    with pytest.raises(RuntimeError, match="CPU function"):
        benchmarking.measure(lambda v: (v * 2, [v]), ins[2:],
                             warmup_inputs=ins[:2])
    with pytest.raises(RuntimeError, match="CPU function"):
        benchmarking.measure_batched_differential(
            lambda b: (lambda v: v + 1), lambda b: (torch.ones(b),))
    with pytest.raises(RuntimeError, match="CPU function"):
        benchmarking.measure_device(lambda v: v * 2, ins[0][0])
