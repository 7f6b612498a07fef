"""The frames FIR entry points (K3-K6, E1) and resample: port vs the JAX package.

CPU, plain kernel versions.  The JAX side runs its Pallas kernels in
interpret mode, as tests/test_kernels.py does.  Tolerance: max abs err
< 1e-5 on signals of |x| <= ~1.2 (float32 sums of ~190 terms in different
orders), on every padded frame, on the first ceil(n_out/P) frames and on
the flat crop.  Plans: 160/147 and 147/160 (s >= 8, the JAX kernels'
regime); the port's s < 8 plan (3/2) is held against float64 numpy and the
JAX XLA resample.  The CUDA kernel itself is compared with the plain
version on the card in tests/test_torch_gpu.py.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.config import SRCConfig as JSRCConfig
from dsp_audio_project_tpu.kernels import fir_frames as jfir_frames
from dsp_audio_project_tpu.kernels import fir_class as jfc
from dsp_audio_project_tpu.kernels.experiments.fir import (
    polyphase_fir as jpolyphase_fir,
)
from dsp_audio_project_tpu.kernels.fir_shear import (
    polyphase_fir_shear_frames as jshear,
)
from dsp_audio_project_tpu.ops.src import make_plan as jmake_plan
from dsp_audio_project_tpu.ops.src import resample as jresample
from dsp_audio_project_tpu_torch import SRCConfig, resample
from dsp_audio_project_tpu_torch.kernels import fir_frames
from dsp_audio_project_tpu_torch.kernels import fir_class as tfc
from dsp_audio_project_tpu_torch.kernels.fir_shear import (
    polyphase_fir_shear_frames,
)
from dsp_audio_project_tpu_torch.ops.src import make_plan

torch.set_num_threads(2)

TOL = 1e-5
N = 12000


def make_x(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((batch, n))).astype(np.float32)


def max_err(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("L,M", [(160, 147), (147, 160)])
@pytest.mark.parametrize("route", ["rect", "class", "shear"])
def test_fir_frames_routes_match_jax(L, M, route):
    x = make_x(2, N, seed=L + len(route))
    n_out = SRCConfig(L=L, M=M).output_length(N)
    plan = make_plan(L, M)
    nf = -(-n_out // plan.P)
    want = np.asarray(jfir_frames(jnp.asarray(x), jmake_plan(L, M), n_out,
                                  kernel=route, pad_frames=True,
                                  interpret=True))
    xt = torch.as_tensor(x)
    got = fir_frames(xt, plan, n_out, kernel=route, pad_frames=True)
    assert max_err(want, got) < TOL          # every padded frame, same count
    unpadded = fir_frames(xt, plan, n_out, kernel=route)
    assert unpadded.shape == (2, nf, plan.P)
    assert max_err(want[:, :nf], unpadded) < TOL
    flat = unpadded.reshape(2, -1)[:, :n_out]
    assert max_err(want.reshape(2, -1)[:, :n_out], flat) < TOL
    if route == "rect":     # 'auto' is 'rect' on these plans, as in JAX
        assert torch.equal(fir_frames(xt, plan, n_out, pad_frames=True), got)


def test_shard_style_call_matches_jax():
    """num_frames / pad_left on a halo-extended shard input (the JAX
    package's shard contract, tests/test_kernels.py:311-332)."""
    plan, jplan = make_plan(160, 147), jmake_plan(160, 147)
    assert (plan.halo_left, plan.halo_right) == (jplan.halo_left,
                                                 jplan.halo_right)
    hl, hr = plan.halo_left, plan.halo_right
    x = make_x(1, hl + 147 * 256 + hr, seed=9)[0]
    kw = dict(num_frames=256, pad_left=-(plan.lo + hl))
    for jfn, tfn in ((jfc.polyphase_fir_class_frames,
                      tfc.polyphase_fir_class_frames),
                     (jfc.polyphase_fir_class_rect_frames,
                      tfc.polyphase_fir_class_rect_frames),
                     (jshear, polyphase_fir_shear_frames)):
        want = jfn(jnp.asarray(x), jplan, 256 * plan.P, interpret=True, **kw)
        got = tfn(torch.as_tensor(x), plan, 256 * plan.P, **kw)
        assert got.shape == (256, plan.P)
        assert max_err(want, got) < TOL


def test_flat_kernel_matches_jax():
    """K6 against the JAX flat class kernel: padded buffer and crop."""
    x = make_x(2, N, seed=6)
    n_out = SRCConfig(L=160, M=147).output_length(N)
    plan = make_plan(160, 147)
    want = np.asarray(jfc.polyphase_fir_class_flat(
        jnp.asarray(x), jmake_plan(160, 147), n_out, pad_out=True,
        interpret=True))
    xt = torch.as_tensor(x)
    got = tfc.polyphase_fir_class_flat(xt, plan, n_out, pad_out=True)
    assert max_err(want, got) < TOL
    assert max_err(want[:, :n_out],
                   tfc.polyphase_fir_class_flat(xt, plan, n_out)) < TOL


def test_experimental_fir_matches_jax():
    """E1 (fir_path='pallas') against the JAX experimental kernel."""
    x = make_x(2, N, seed=7)
    n_out = SRCConfig(L=160, M=147).output_length(N)
    want = jpolyphase_fir(jnp.asarray(x), jmake_plan(160, 147), n_out,
                          interpret=True)
    got = tfc.polyphase_fir(torch.as_tensor(x), make_plan(160, 147), n_out)
    assert got.shape == (2, n_out)
    assert max_err(want, got) < TOL


def test_predicates_and_errors_match_jax():
    for L, M in [(160, 147), (147, 160), (441, 480), (320, 441), (3, 2),
                 (8, 7), (1, 1), (2, 3)]:
        a, b = jmake_plan(L, M), make_plan(L, M)
        assert jfc.class_supported(a) == tfc.class_supported(b), (L, M)
        assert jfc.class_flat_supported(a) == tfc.class_flat_supported(b)
        assert tfc.rect_supported(b) == tfc.class_supported(b)
    x = torch.zeros(1000)
    narrow = make_plan(8, 7)                     # s = 7
    for fn in (tfc.polyphase_fir_class_frames,
               tfc.polyphase_fir_class_rect_frames,
               polyphase_fir_shear_frames):
        with pytest.raises(ValueError, match="s>=8"):
            fn(x, narrow, 1143)
    with pytest.raises(ValueError, match="s>=8"):
        fir_frames(x, narrow, 1143)              # 'auto' -> shear
    with pytest.raises(ValueError, match="unknown FIR kernel"):
        fir_frames(x, make_plan(160, 147), 1088, kernel="splitbank")
    with pytest.raises(ValueError):
        tfc.polyphase_fir_class_flat(x, make_plan(441, 480), 1000)


@pytest.mark.parametrize("L,M", [(3, 2), (160, 147)])
def test_frames_plain_matches_float64(L, M):
    """The frames kernel's plain version against float64 windows @ G, at an
    s < 8 plan too (the CUDA kernel has no stride limit): > 1e-5 abs."""
    plan = make_plan(L, M)
    x = make_x(2, 3000, seed=L)
    f_out = 97
    got = tfc.fir_frames_kernel(torch.as_tensor(x),
                                tfc.plan_operator(plan, "cpu"), plan.s,
                                f_out, -plan.lo)
    xp = np.zeros((2, (f_out - 1) * plan.s + plan.W + 3000))
    xp[:, -plan.lo: -plan.lo + 3000] = x
    idx = np.arange(f_out)[:, None] * plan.s + np.arange(plan.W)[None, :]
    want = xp[:, idx] @ plan.G
    assert got.shape == (2, f_out, plan.P)
    assert max_err(want, got.double()) < TOL
    # A negative pad_left drops leading samples.
    a = tfc.fir_frames_kernel(torch.as_tensor(x), tfc.plan_operator(plan, "cpu"),
                              plan.s, 5, -4)
    b = tfc.fir_frames_kernel(torch.as_tensor(x[:, 4:].copy()),
                              tfc.plan_operator(plan, "cpu"), plan.s, 5, 0)
    assert torch.equal(a, b)


def test_frames_wrapper_rejects_bad_input():
    plan = make_plan(160, 147)
    g = tfc.plan_operator(plan, "cpu")
    x = torch.zeros(2, 4000)
    with pytest.raises(TypeError):
        tfc.fir_frames_kernel(x.double(), g, plan.s, 8, 0)
    with pytest.raises(ValueError):
        tfc.fir_frames_kernel(x.t(), g, plan.s, 8, 0)
    with pytest.raises(ValueError):
        tfc.fir_frames_kernel(x, g.double(), plan.s, 8, 0)
    with pytest.raises(ValueError):
        tfc.fir_frames_kernel(x, g.t(), plan.s, 8, 0)
    assert tfc.fir_frames_kernel(x, g, plan.s, 0, 0).shape == (2, 0, plan.P)


@pytest.mark.parametrize("L,M,n", [
    (160, 147, 20000), (147, 160, 9001), (3, 2, 5000),
    (160, 147, 30),          # n*L < taps: the short-signal 'same' centring
    (1, 1, 500),             # bypass
])
def test_resample_matches_jax(L, M, n):
    x = make_x(2, n, seed=n)
    want, fs_w = jresample(jnp.asarray(x), 44100, JSRCConfig(L=L, M=M))
    got, fs_g = resample(torch.as_tensor(x), 44100, SRCConfig(L=L, M=M))
    assert fs_g == fs_w
    assert got.shape == want.shape
    assert max_err(want, got) < TOL
