"""The port's dynamic-gain EQ (ops/eq_dynamic.py) vs the JAX package, the
port's static path and the numpy oracle, on the CPU.

The JAX references here are the cheap ones: ``host_dyn_tables`` (float64
numpy), and the apply side ``equalize_dynamic_frames_ops`` on operators of
the JAX host builder.  The JAX traced builder is not called (its compile
costs minutes on a CPU); the port's device builder is held against the
oracle and against the port's host builder instead.

Tolerances: the host tables bit for bit (the same float64 numpy
operations); the apply side >= 130 dB against the JAX apply on the same
operators (float32 products in other orders); the host builder > 140 dB
against the port's static ``equalize`` at block G*P (the same Schur
realization and quantization); the device builder > 110 dB against the
oracle (the JAX traced builder's gate) and >= 90 dB against the host
builder (two realizations, equal only to float32 rounding: the host one is
the float32-quantized Schur system, ~106-108 dB from the oracle).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.ops import eq_dynamic as jed
from dsp_audio_project_tpu_torch import EQConfig, equalize, equalize_dynamic
from dsp_audio_project_tpu_torch.kernels import fir_class
from dsp_audio_project_tpu_torch.ops import eq as teq
from dsp_audio_project_tpu_torch.ops import eq_dynamic as ted
from dsp_audio_project_tpu_torch.oracle import equalize_oracle, snr_db
from dsp_audio_project_tpu_torch.utils import device as udev

from conftest import make_test_signal

torch.set_num_threads(2)

GAIN_SETS = [
    (6.0, -3.0, 0.0, 12.0, -15.0, 4.0),
    (15.0, 15.0, 15.0, 15.0, 15.0, 15.0),
    (-15.0, -14.0, -13.0, -12.5, -3.0, 0.0),   # real-pole regime bands
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (0.05, -0.05, 0.0, 0.0, 0.0, 0.0),          # below the skip threshold
]
NAMES = [n for n, _ in EQConfig().band_centers]
FS = 48000
P, G, F = 160, 64, 301                          # K = 5: exercises the carry


def cfg_of(gains):
    return EQConfig.from_gains(dict(zip(NAMES, gains)))


def frames_signal():
    return make_test_signal(F * P, FS, seed=29)


@pytest.mark.parametrize("gains", GAIN_SETS)
def test_host_tables_match_jax_bitwise(gains):
    args = (gains, FS, EQConfig(), 160, 16, 4)
    got = ted.host_dyn_tables(*args)
    want = jed.host_dyn_tables(*args)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_host_powers_match_jax_bitwise():
    A = np.random.default_rng(4).standard_normal((12, 12)) * 0.3
    for count in (1, 2, 5, 129, 161):
        got = ted._host_powers(A, count)
        assert got.shape == (count, 12, 12)
        np.testing.assert_array_equal(got, jed._host_powers(A, count))


def test_lower_triangle_matches_direct():
    rng = np.random.default_rng(5)
    n, d = 7, 4
    pows = rng.standard_normal((n, d, d)).astype(np.float32)
    got = ted._lower_triangle(torch.as_tensor(pows), n, d).numpy()
    want = np.zeros((n * d, n * d), np.float32)
    for v in range(n):
        for r in range(v, n):
            want[v * d:(v + 1) * d, r * d:(r + 1) * d] = pows[r - v].T
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gains", GAIN_SETS)
def test_apply_matches_jax_on_same_operators(gains):
    x = frames_signal().reshape(F, P)
    K = -(-F // G)
    jops = jed.build_dynamic_operators_host(
        gains, FS, EQConfig(), unroll=P, groups_per_block=G, num_blocks=K)
    want = np.asarray(jed.equalize_dynamic_frames_ops(
        jnp.asarray(x), jops, groups_per_block=G))
    ops = ted.dyn_operators_from_numpy(jops, "cpu")
    assert ops.carry_w is not None and ops.carry_w.shape == (K * 12, K * 12)
    got = ted.equalize_dynamic_frames_ops(torch.as_tensor(x), ops,
                                          groups_per_block=G)
    assert got.shape == want.shape == (F, P)
    assert snr_db(want.ravel(), got.numpy().ravel()) >= 130


@pytest.mark.parametrize("gains", GAIN_SETS)
def test_host_builder_matches_static(gains):
    x = frames_signal()
    ops = ted.build_dynamic_operators_host(
        gains, FS, EQConfig(), P, G, -(-F // G), device="cpu")
    got = ted.equalize_dynamic_frames_ops(torch.as_tensor(x.reshape(F, P)),
                                          ops, groups_per_block=G)
    stat = equalize(x, FS, cfg_of(gains), block=G * P, unroll=P,
                    device="cpu")
    assert snr_db(stat.numpy(), got.numpy().ravel()) > 140


def host_builder_flat(x, gains, fs, block=8192, unroll=128):
    """``equalize_dynamic``'s algebra on the host builder's operators."""
    n = x.shape[-1]
    K, Gb = -(-n // block), block // unroll
    ops = ted.build_dynamic_operators_host(gains, fs, EQConfig(), unroll, Gb,
                                           K, device="cpu")
    frames = torch.nn.functional.pad(torch.as_tensor(x), (0, K * block - n))
    z = ted.equalize_dynamic_frames_ops(frames.reshape(K * Gb, unroll), ops,
                                        groups_per_block=Gb)
    return z.reshape(-1)[:n].numpy()


@pytest.mark.parametrize("gains", GAIN_SETS)
def test_device_builder_matches_oracle(gains):
    fs = 44100
    x = make_test_signal(30000, fs, seed=13)
    got = equalize_dynamic(x, torch.tensor(gains), fs, device="cpu")
    assert got.shape == (30000,)
    q = snr_db(equalize_oracle(x, fs, cfg_of(gains)), got.numpy())
    assert q > 110, f"gains={gains}: {q:.1f} dB"


@pytest.mark.parametrize("gains", GAIN_SETS)
def test_device_builder_matches_host_builder(gains):
    fs = 44100
    x = make_test_signal(30000, fs, seed=13)
    got = equalize_dynamic(x, list(gains), fs, device="cpu").numpy()
    assert snr_db(host_builder_flat(x, gains, fs), got) >= 90
    # The group FIR C A^k B, D does not depend on the state basis: the
    # two builders' fir_t agree to float32 rounding.
    dev = ted.build_dynamic_operators(torch.tensor(gains), fs, EQConfig(),
                                      160, 16, 4)
    host = ted.build_dynamic_operators_host(gains, fs, EQConfig(), 160, 16, 4,
                                            device="cpu")
    scale = float(host.fir_t.abs().max())
    assert float((dev.fir_t - host.fir_t).abs().max()) <= 1e-5 * scale


def test_small_gains_mask_to_identity_band():
    """|g| <= 0.1 dB builds exactly the 0 dB band's tables."""
    for build in (ted.build_dynamic_operators,
                  lambda g, *a: ted.build_dynamic_operators_host(
                      g, *a, device="cpu")):
        a = build(torch.tensor([0.05, -0.08, 0.0, 3.0, 0.0, 0.0]), FS,
                  EQConfig(), 160, 16, 4)
        b = build(torch.tensor([0.0, 0.0, 0.0, 3.0, 0.0, 0.0]), FS,
                  EQConfig(), 160, 16, 4)
        for name, t in a._asdict().items():
            assert torch.equal(t, getattr(b, name)), name


def test_device_builder_shapes_and_carry_form():
    """d = 12 always; the dense carry up to K*d = 2048, else None (the
    scan), and the scan agrees with the dense product."""
    g = torch.tensor(GAIN_SETS[0])
    ops = ted.build_dynamic_operators(g, FS, EQConfig(), 160, 16, 170)
    assert ops.group_in.shape == (160, 12) and ops.toe.shape == (192, 192)
    assert ops.carry_w.shape == (2040, 2040)
    assert all(t.dtype == torch.float32 for t in ops if t is not None)
    assert ted.build_dynamic_operators(g, FS, EQConfig(), 160, 16,
                                       171).carry_w is None
    assert ted.build_dynamic_operators(g, FS, EQConfig(), 160, 16,
                                       1).carry_w is None
    K = 9
    ops = ted.build_dynamic_operators(g, FS, EQConfig(), 160, 16, K)
    e = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, K, 12)).astype(np.float32))
    dense = ted.dyn_block_carry(e, ops.carry_w, ops.A_blk)
    scan = ted.dyn_block_carry(e, None, ops.A_blk)
    assert snr_db(dense.numpy().ravel(), scan.numpy().ravel()) > 120
    assert torch.equal(dense[:, 0], torch.zeros(2, 12))


def test_gain_changes_grow_no_cache():
    """Four distinct gain vectors through both builders and the apply add
    nothing to the static path's table caches."""
    x = torch.as_tensor(frames_signal().reshape(F, P))

    def sizes():
        return (teq.make_block_operators.cache_info().currsize,
                len(teq._device_tables), len(teq._carry_weight_cache),
                len(udev._tables), len(fir_class._g2_cache))

    ted.build_dynamic_operators(torch.zeros(6), FS, EQConfig(), P, G, 5)
    before = sizes()
    for i, gains in enumerate(GAIN_SETS[:4]):
        g = np.asarray(gains) + i
        for ops in (ted.build_dynamic_operators_host(g, FS, EQConfig(), P, G,
                                                     5, device="cpu"),
                    ted.build_dynamic_operators(torch.tensor(g), FS,
                                                EQConfig(), P, G, 5)):
            ted.equalize_dynamic_frames_ops(x, ops, groups_per_block=G)
    assert sizes() == before
