"""The port's ``models/graph`` stages vs the JAX package's on the same input.

Both run float32 (the JAX chain as one XLA program, the port's stage by
stage with ``device="cpu"``: the frames kernel's plain version for
``Resample``, the block EQ for ``Equalize``), so the outputs must agree at
>= 100 dB, with equal shapes and equal output rates.  ``Gain``, ``Clip``
and ``Normalize`` are also held bit for bit against their float32
arithmetic done literally in numpy.
"""
from __future__ import annotations

import jax  # noqa: F401  (conftest pins it to the CPU)
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu import EQConfig as JEQ
from dsp_audio_project_tpu import SRCConfig as JSRC
from dsp_audio_project_tpu.models import graph as jg
from dsp_audio_project_tpu_torch import EQConfig, SRCConfig
from dsp_audio_project_tpu_torch.models import graph as tg
from dsp_audio_project_tpu_torch.oracle import snr_db

from conftest import make_test_signal

FS = 44100


def _both(spec):
    """A stage list built twice from one spec: (JAX stages, port stages).
    Spec items: ("resample", L, M[, factor]), ("eq", gains), ("gain", db),
    ("clip", limit), ("normalize", guard), ("chain", [specs])."""
    def build(mod, src, eq, item):
        kind, *args = item
        if kind == "resample":
            L, M, *f = args
            return mod.Resample(src(L=L, M=M, taps_rule_factor=(f or [40])[0]))
        if kind == "eq":
            return mod.Equalize(eq.from_gains(args[0]))
        if kind == "chain":
            return mod.Chain([build(mod, src, eq, s) for s in args[0]])
        return {"gain": mod.Gain, "clip": mod.Clip,
                "normalize": mod.Normalize}[kind](*args)

    return ([build(jg, JSRC, JEQ, s) for s in spec],
            [build(tg, SRCConfig, EQConfig, s) for s in spec])


def _run(spec, x, fs=FS):
    jstages, tstages = _both(spec)
    want, jfs = jg.Chain(jstages)(x, fs)
    got, tfs = tg.Chain(tstages, device="cpu")(x, fs)
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    got = got.numpy()
    assert tfs == jfs and got.shape == want.shape and got.dtype == want.dtype
    return want, got


_CHAINS = {
    # tests/test_graph.py's stagewise chain: down, EQ, back up.
    "down_eq_up": [("resample", 2, 3), ("eq", {"Bass": 6}),
                   ("resample", 3, 2)],
    # The telephone chain of the Chain docstring (44.1k -> 6k -> 44.1k).
    "telephone": [("resample", 20, 147, 4), ("eq", {"Low Mids": 6}),
                  ("resample", 147, 20, 4), ("clip", 1.0)],
    # tests/test_graph.py's rate ladder.
    "ladder_1_7": [("resample", 1, 7, 10), ("resample", 7, 1, 10),
                   ("clip", 1.0)],
    "nested": [("resample", 1, 2),
               ("chain", [("eq", {"Presence": -6}), ("gain", -3.0)])],
    "serving_rate": [("resample", 160, 147), ("eq", {"Bass": 6,
                                                     "Presence": -4})],
}


@pytest.mark.parametrize("name", sorted(_CHAINS))
def test_chain_matches_jax(name):
    x = make_test_signal(3000, FS, seed=31)
    want, got = _run(_CHAINS[name], x)
    assert snr_db(want, got) >= 100.0


def _numpy_stages(spec, x):
    """``Gain``, ``Clip`` and ``Normalize`` as literal float32 numpy."""
    for kind, arg in spec:
        if kind == "gain":
            x = x * np.float32(10.0 ** (arg / 20.0))
        elif kind == "clip":
            x = np.clip(x, np.float32(-arg), np.float32(arg))
        else:
            peak = np.max(np.abs(x))
            x = x * (np.float32(1.0) / peak if peak > arg else np.float32(1))
    return x


def test_gain_clip_normalize():
    """>= 100 dB against the JAX chain, and bit for bit against the stages'
    float32 arithmetic done literally (XLA may fold a gain into the
    normalization: its x * g * (1 / max|x * g|) comes out as x / max|x|,
    an ulp away)."""
    x = make_test_signal(4096, 48000, seed=2) * 0.5
    for spec in ([("gain", 12.0), ("clip", 1.0)],
                 [("gain", -40.0), ("normalize", 1e-6)],
                 [("clip", 0.25), ("gain", 1.5)],
                 [("normalize", 10.0)]):          # peak under the guard
        want, got = _run(spec, x, 48000)
        assert snr_db(want, got) >= 100.0
        np.testing.assert_array_equal(got, _numpy_stages(spec, x))
    _, got = _run([("gain", -40.0), ("normalize", 1e-6)], x, 48000)
    assert abs(np.max(np.abs(got)) - 1.0) < 1e-6


def test_output_rate_matches_jax():
    for spec in list(_CHAINS.values()) + [[("resample", 1, 1)], []]:
        jstages, tstages = _both(spec)
        for fs in (8000, 44100, 48000):
            assert (tg.Chain(tstages).output_rate(fs)
                    == jg.Chain(jstages).output_rate(fs))
            for j, t in zip(jstages, tstages):
                assert t.output_rate(fs) == j.output_rate(fs)


def test_chain_device_rule():
    stages = [tg.Gain(6.0), tg.Clip()]
    x = make_test_signal(512, FS, seed=4)
    # An array goes to the card, and there is none here.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.Chain(stages)(x, FS)
    # A tensor stays where it is; device="cpu" moves an array there.
    got, fs = tg.Chain(stages)(torch.as_tensor(x), FS)
    assert got.device.type == "cpu" and fs == FS
    again, _ = tg.Chain(stages, device="cpu")(x, FS)
    assert torch.equal(got, again)
    # A chain is a stage: apply() takes a tensor and returns the rate.
    inner = tg.Chain([tg.Resample(SRCConfig(L=1, M=2))])
    y, fs_out = inner.apply(torch.as_tensor(x), FS)
    assert fs_out == FS // 2 and y.shape[-1] == 256
