"""Host design tables of the torch port vs the JAX package: bit-for-bit.

The port carries numpy copies of config.py, design/, oracle.py and the
planners (make_plan, the EQ block operators, eq_cat_weights, the carry
weights, G2 = G @ w_cat), because importing anything of the JAX package
imports jax and the GPU host has none.  Same numpy code on the same inputs,
so the tolerance is zero: every table must be identical (np.array_equal).
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

import jax  # noqa: F401  (conftest pins it to the CPU)
import numpy as np
import pytest

import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu import config as jconfig
from dsp_audio_project_tpu import oracle as joracle
from dsp_audio_project_tpu.kernels.fir_class import _class_banks_cat
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu.ops.src import make_plan as jmake_plan
from dsp_audio_project_tpu_torch import oracle as toracle
from dsp_audio_project_tpu_torch.kernels.fir_class import cat_operator
from dsp_audio_project_tpu_torch.ops import eq as teq
from dsp_audio_project_tpu_torch.ops.src import make_plan as tmake_plan

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}
PLANS = [(160, 147), (441, 480), (320, 441)]
OPS_FIELDS = ("A", "B", "C", "corr", "state_corr", "group_A", "group_in",
              "group_out", "group_fir", "group_toeplitz", "group_pows")


def _ops_pair(L, M):
    fs_out = jconfig.SRCConfig(L=L, M=M).output_rate(FS)
    plan = tmake_plan(L, M)
    bands = jconfig.EQConfig.from_gains(GAINS).active_bands(fs_out)
    args = (bands, fs_out, 1.0, 128 * plan.P, plan.P)
    return jeq.make_block_operators(*args), teq.make_block_operators(*args)


@pytest.mark.parametrize("L,M", PLANS)
def test_make_plan_matches_jax(L, M):
    a, b = jmake_plan(L, M), tmake_plan(L, M)
    assert (a.lo, a.s, a.P, a.W, a.taps) == (b.lo, b.s, b.P, b.W, b.taps)
    assert np.array_equal(a.G, b.G)


def test_make_plan_short_signal_center_matches_jax():
    # The short-signal 'same' alignment (n*L < taps) passes its own center.
    a, b = jmake_plan(160, 147, 40, 799), tmake_plan(160, 147, 40, 799)
    assert (a.lo, a.W) == (b.lo, b.W)
    assert np.array_equal(a.G, b.G)


@pytest.mark.parametrize("L,M", PLANS)
def test_g2_matches_jax_banks(L, M):
    jops, tops = _ops_pair(L, M)
    plan = jmake_plan(L, M)
    w_cat = jeq.eq_cat_weights(jops)
    assert np.array_equal(w_cat, teq.eq_cat_weights(tops))
    d = w_cat.shape[1] - plan.P
    # Class 0 of the JAX kernel's bank stack sits at lane offset 0: it is G2.
    banks = _class_banks_cat(plan, 0, w_cat, split=False)
    g2 = cat_operator(tmake_plan(L, M).G, teq.eq_cat_weights(tops))
    assert g2.dtype == np.float32 and g2.shape == (plan.W, plan.P + d)
    assert np.array_equal(banks[0, : plan.W, : plan.P + d], g2)


@pytest.mark.parametrize("L,M", PLANS)
def test_block_operators_match_jax(L, M):
    jops, tops = _ops_pair(L, M)
    for name in OPS_FIELDS:
        assert np.array_equal(getattr(jops, name), getattr(tops, name)), name
    assert jops.D == tops.D and jops.unroll == tops.unroll


@pytest.mark.parametrize("K", [8, 144])
def test_carry_weights_match_jax(K):
    jops, tops = _ops_pair(160, 147)
    assert np.array_equal(jeq._carry_weights(jops, K),
                          teq._carry_weights(tops, K))


def test_config_semantics_match_jax():
    for gains in (GAINS, {}, {"Brilliance": 15}, {"Bass": 0.05}):
        a, b = jconfig.EQConfig.from_gains(gains), pt.EQConfig.from_gains(gains)
        assert a.bypass == b.bypass
        for fs in (8000, 22050, 48000):
            assert a.active_bands(fs) == b.active_bands(fs)
    for L, M in PLANS + [(1, 1), (3, 2)]:
        a, b = jconfig.SRCConfig(L=L, M=M), pt.SRCConfig(L=L, M=M)
        assert (a.num_taps, a.cutoff_norm, a.bypass) == (
            b.num_taps, b.cutoff_norm, b.bypass)
        for n in (10, 4096, FS):
            assert a.output_length(n) == b.output_length(n)
        assert a.output_rate(FS) == b.output_rate(FS)
    s = pt.SpectrumConfig()
    assert (s.nfft, s.analysis_limit) == (2048, 100_000)
    jk, tk = jconfig.KernelConfig(), pt.KernelConfig()
    for name in ("fir_path", "iir_path", "iir_block", "iir_unroll",
                 "eq_fast", "src_fast"):
        assert getattr(jk, name) == getattr(tk, name), name
    for path in ("auto", "jnp", "pallas"):
        a = jconfig.KernelConfig(fir_path=path, iir_path=path)
        b = pt.KernelConfig(fir_path=path, iir_path=path)
        assert a.resolve("fir") == b.resolve("fir")
        assert a.resolve("iir") == b.resolve("iir")


def test_oracle_matches_jax():
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal(3000)).astype(np.float32)
    src = jconfig.SRCConfig(L=160, M=147)
    eq = jconfig.EQConfig.from_gains(GAINS)
    tsrc = pt.SRCConfig(L=160, M=147)
    teqc = pt.EQConfig.from_gains(GAINS)
    for engine in ("fast", "direct"):
        a, fa = joracle.pipeline_oracle(x, FS, src, eq, engine=engine)
        b, fb = toracle.pipeline_oracle(x, FS, tsrc, teqc, engine=engine)
        assert fa == fb and np.array_equal(a, b)
    fa, ma = joracle.spectrum_oracle(x, FS)
    fb, mb = toracle.spectrum_oracle(x, FS)
    assert np.array_equal(fa, fb) and np.array_equal(ma, mb)
    assert joracle.snr_db(a, a + 1e-3) == toracle.snr_db(a, a + 1e-3)


def test_port_imports_no_jax():
    root = pathlib.Path(__file__).resolve().parent.parent
    pkg = root / "dsp_audio_project_tpu_torch"
    modules = sorted(
        ".".join(f.relative_to(root).with_suffix("").parts)
        for f in pkg.rglob("*.py") if f.name != "__init__.py"
    )
    assert "dsp_audio_project_tpu_torch.kernels.eq_finish" in modules
    code = ("import sys, importlib; "
            f"[importlib.import_module(m) for m in {modules!r}]; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'dsp_audio_project_tpu' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr


def test_import_pins_fp32():
    from dsp_audio_project_tpu_torch.utils.precision import fp32_pinned

    assert fp32_pinned()


def test_exports_cover_jax():
    """Every name the JAX package exports, the port exports too."""
    import dsp_audio_project_tpu as jpkg

    assert not set(jpkg.__all__) - set(pt.__all__)
    assert all(hasattr(pt, name) for name in pt.__all__)
