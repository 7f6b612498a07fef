"""The windowed-FIR kernel's 3xTF32 arithmetic, mirrored in torch, vs the JAX package.

CPU.  The CUDA kernel (csrc/fir_cat.cu) splits each operand into TF32
halves, hi = rna(v) and lo = rna(v - hi), sums each 8-tap step's a_lo b_hi
+ a_hi b_lo + a_hi b_hi into a fresh accumulator for a run of FRESH_TAPS
taps, and adds each run's sum to the running one in fp32.
``fir_class.tf32_split`` and ``fir_frames_3xtf32`` mirror that arithmetic;
here they are held against hand-built bit patterns, the fp32 plain version
and the JAX kernels (K3 ``polyphase_fir_class_rect_
frames``, K1 ``polyphase_fir_class_rect_cat``, Pallas in interpret mode at
HIGHEST precision, as tests/test_torch_frames.py and test_torch_fir_cat.py
run them).  Bounds:

* the split: hi and lo carry <= 10 explicit mantissa bits, hi is v rounded
  to nearest with ties away from zero (computed here in float64), and
  |v - (hi + lo)| <= 2^-21 |v| for normal v (lo normal too: |v| >= 2^-100);
  a subnormal v is held to half the spacing of TF32 subnormals, 2^-137;
* the mirror vs the fp32 plain version and vs the JAX kernel: >= 120 dB
  (the card's kernel-vs-plain bar; ~140 dB expected, as fp32 vs float64);
* the hi*hi product alone: < 90 dB (~72 dB), so the bar catches a lost lo.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.kernels.fir_class import (
    DPAD, polyphase_fir_class_rect_cat as jax_cat,
    polyphase_fir_class_rect_frames as jax_frames,
)
from dsp_audio_project_tpu.ops.src import make_plan as jmake_plan
from dsp_audio_project_tpu_torch import EQConfig, SRCConfig
from dsp_audio_project_tpu_torch.kernels.fir_class import (
    FRESH_TAPS, cat_operator, fir_cat_plain, fir_frames_3xtf32,
    fir_frames_plain, frame_grid, tf32_split,
)
from dsp_audio_project_tpu_torch.ops.eq import (
    eq_cat_weights, make_block_operators,
)
from dsp_audio_project_tpu_torch.ops.src import make_plan
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def f32(bits) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def rna_tf32_64(v: np.ndarray) -> np.ndarray:
    """v rounded to 10 explicit mantissa bits, ties away from zero, in
    float64 (TF32's subnormals are spaced 2^-136, as fp32's normals of the
    smallest binade with 13 bits dropped)."""
    v = v.astype(np.float64)
    a = np.abs(v)
    _, e = np.frexp(np.where(a > 0, a, 1.0))            # a = m 2^e, m in [0.5, 1)
    ulp = np.where(a >= 2.0 ** -126, np.ldexp(1.0, e - 11), 2.0 ** -136)
    return np.sign(v) * np.floor(a / ulp + 0.5) * ulp


SPLIT_CASES = {
    # exact halves between TF32 neighbours: 1 + 2^-11, 1 + 3 * 2^-11, ...
    "ties": f32([0x3F801000, 0x3F803000, 0x40A05000, 0x3F7FF000, 0x00801000]),
    "negatives": -f32([0x3F801000, 0x3F800FFF, 0x3F801001, 0x4049_0FDB,
                       0x3DCC_CCCD]),
    "subnormals": f32([0x00000001, 0x00000FFF, 0x00001000, 0x00001FFF,
                       0x007FFFFF, 0x80000001, 0x807FF000]),
    "zero": f32([0x00000000, 0x80000000]),
    "exact tf32": f32([0x3F800000, 0x40490000, 0xC2F6E000, 0x7F7FE000]),
    "random normals": (np.random.default_rng(1).standard_normal(4000)
                       * np.exp2(np.random.default_rng(2).integers(
                           -90, 90, 4000))).astype(np.float32),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_tf32_split_bit_patterns(case):
    v = SPLIT_CASES[case]
    hi, lo = (t.numpy() for t in tf32_split(torch.as_tensor(v)))
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & 0x1FFF), case  # <= 10 bits
    np.testing.assert_array_equal(hi.astype(np.float64), rna_tf32_64(v))
    np.testing.assert_array_equal(np.signbit(hi[hi == 0]), np.signbit(v[hi == 0]))
    err = np.abs(v.astype(np.float64) - (hi.astype(np.float64) + lo))
    normal = np.abs(v) >= 2.0 ** -100
    assert np.all(err[normal] <= 2.0 ** -21 * np.abs(v[normal]).astype(np.float64))
    assert np.all(err[np.abs(v) < 2.0 ** -126] <= 2.0 ** -137)


def make_x(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal((batch, n))
    return (x / np.abs(x).max()).astype(np.float32)


def hi_only(x, g, s, f_pad, pad_left):
    """The product with every lo dropped: one TF32 product."""
    return fir_frames_plain(tf32_split(x)[0], tf32_split(g)[0], s, f_pad,
                            pad_left)


def snr(a, b) -> float:
    return snr_db(np.asarray(a).ravel(), np.asarray(b).ravel())


@pytest.mark.parametrize("route,L,M,run", [
    pytest.param("frames", 160, 147, FRESH_TAPS, id="frames-160-147"),
    pytest.param("frames", 441, 480, FRESH_TAPS, id="frames-441-480"),
    pytest.param("cat", 160, 147, FRESH_TAPS, id="cat-160-147"),
    pytest.param("cat", 441, 480, FRESH_TAPS, id="cat-441-480"),
    pytest.param("cat", 160, 147, 8, id="cat-160-147-run8"),
])
def test_3xtf32_mirror_matches_plain_and_jax(route, L, M, run):
    """A few hundred frames (F_pad = 1024, the JAX grid's smallest) at the
    serving plan and at 441/480: frames with G (K3), or y0 | inj with K1's
    G2 = G @ w_cat; the kernel's fresh runs of FRESH_TAPS taps, and one
    case at runs of one 8-tap step (the mma.sync body's order)."""
    plan, jplan = make_plan(L, M), jmake_plan(L, M)
    n = 32000
    x = make_x(2, n, seed=L)
    n_out = SRCConfig(L=L, M=M).output_length(n)
    f_pad = frame_grid(n_out, plan.P)
    xt = torch.as_tensor(x)
    if route == "frames":
        g = torch.as_tensor(plan.G.astype(np.float32))
        want = np.asarray(jax_frames(jnp.asarray(x), jplan, n_out,
                                     pad_frames=True, interpret=True,
                                     precision=jax.lax.Precision.HIGHEST))
    else:
        fs_out = SRCConfig(L=L, M=M).output_rate(FS)
        bands = EQConfig.from_gains(GAINS).active_bands(fs_out)
        ops = make_block_operators(bands, fs_out, 1.0, 128 * plan.P, plan.P)
        w_cat = eq_cat_weights(ops)
        d = ops.A.shape[0]
        g = torch.as_tensor(cat_operator(plan.G, w_cat))
        y0_j, inj_j = jax_cat(jnp.asarray(x), jplan, n_out, w_cat,
                              interpret=True,
                              precision=jax.lax.Precision.HIGHEST)
        inj_j = np.asarray(inj_j).reshape(2, -1, DPAD)[..., :d]
        want = np.concatenate([np.asarray(y0_j), inj_j], axis=-1)
    mirror = fir_frames_3xtf32(xt, g, plan.s, f_pad, -plan.lo, run=run)
    plain = fir_frames_plain(xt, g, plan.s, f_pad, -plan.lo)
    assert mirror.shape == plain.shape == want.shape == (2, f_pad, g.shape[1])
    if route == "cat":      # the split of K1's plain version is a view of it
        y0, inj = fir_cat_plain(xt, g, plan.P, plan.s, f_pad, -plan.lo)
        assert torch.equal(torch.cat([y0, inj], -1), plain)
    s_plain, s_jax = snr(plain, mirror), snr(want, mirror)
    s_hi = snr(plain, hi_only(xt, g, plan.s, f_pad, -plan.lo))
    assert s_plain >= 120 and s_jax >= 120, (s_plain, s_jax)
    assert s_hi < 90, s_hi
