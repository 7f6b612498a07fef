"""The device gain builder's kernel module (kernels/eq_design.py) on the CPU,
where the wrapper runs its plain version.

* The wrapper's CPU route (and ``ops/eq_dynamic.build_dynamic_operators``
  through it) equals, bit for bit, the torch body the kernels replaced,
  frozen here as it was (``frozen_dynamic_operators``), for every gain
  set of tests/test_torch_eq_dynamic.py at a small geometry and at the
  slider's (U = 160, G = 128, K = 144).
* Against the JAX package's traced builder (``build_dynamic_operators``,
  df32; one compile of ~1 min serves every gain set): every table within
  1e-5 of its largest magnitude and the apply on either set of operators
  >= 90 dB, the tolerances of test_torch_eq_dynamic.py's
  ``test_device_builder_matches_host_builder``.
* carry_w is None where the dense carry is not built (K = 1, K d > 2048).
* The kernel's schedule in float64 torch ops (``design_schedule_mirror``:
  every power A^e as the product of the heads of e's set bits, each
  product's sum in k order) within one float32 ulp of the plain version
  at the small and slider geometries, 441/480's unroll, three bands (d %
  4 != 0) and G = 1; its pieces against plain products.
* The CUDA route's shape limits raise through ``cuda_layout``, without a
  card, and K past the dense carry is no limit; the wrapper's argument
  checks raise on the CPU.

The kernels themselves run only on the card: tests/test_torch_gpu.py holds
them against the plain version there.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.config import EQConfig as JEQConfig
from dsp_audio_project_tpu.ops import eq_dynamic as jed
from dsp_audio_project_tpu_torch import EQConfig
from dsp_audio_project_tpu_torch.kernels.eq_design import (
    MAX_SIDE, _band_realization, _compose_cascade, cuda_layout,
    design_schedule_mirror, dynamic_operators_plain, eq_design, exponents,
    ordered_product, powers_mirror, ulp_error,
)
from dsp_audio_project_tpu_torch.ops import eq_dynamic as ted
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

GAIN_SETS = [
    (6.0, -3.0, 0.0, 12.0, -15.0, 4.0),
    (15.0, 15.0, 15.0, 15.0, 15.0, 15.0),
    (-15.0, -14.0, -13.0, -12.5, -3.0, 0.0),   # real-pole regime bands
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (0.05, -0.05, 0.0, 0.0, 0.0, 0.0),          # below the skip threshold
]
FS = 48000
SMALL = (32, 8, 4)                  # (U, G, K), a dense carry of K d = 48
SLIDER = (160, 128, 144)            # 60 s at 160/147: K d = 1728


def design_inputs(gains, fs=FS):
    cfg = EQConfig()
    nb = len(gains)                 # the first nb of the six bands
    s, c = ted._band_trig(fs, cfg.band_centers[:nb], cfg.nyquist_safety)
    return (torch.tensor(gains, dtype=torch.float32), torch.as_tensor(s),
            torch.as_tensor(c), cfg.q, cfg.bypass_threshold_db)


# ---- the torch body the kernels replaced, as it was ----------------------


def frozen_dynamic_operators(gains_db, sin_w0, cos_w0, q, threshold, U, G,
                             K):
    g = gains_db.to(torch.float64)
    g = torch.where(g.abs() > threshold, g, torch.zeros_like(g))
    one, zero = torch.ones_like(g), torch.zeros_like(g)
    amp = torch.pow(10.0, g / 40.0)
    alpha = sin_w0 / (2.0 * q)
    al_over, al_times = alpha / amp, alpha * amp
    a0 = 1.0 + al_over
    a1 = -2.0 * cos_w0 / a0
    a2 = (1.0 - al_over) / a0
    b0 = (1.0 + al_times) / a0
    c1 = a1 * (alpha * (1.0 / amp - amp) / a0)
    c0 = (1.0 - al_times) / a0 - b0 * a2
    m = -0.5 * a1
    disc4 = sin_w0 * sin_w0 * (1.0 / (amp * amp) - 4.0) / (4.0 * a0 * a0)
    cx = disc4 < 0.0
    root = torch.sqrt(disc4.abs())
    g2_c = -(c0 + c1 * m) / torch.where(cx, root.clamp(min=1e-300), one)
    l1, l2 = m + root, m - root
    g1_r = (c0 + c1 * l1) / torch.where(cx, one, 1.0 - l2 + l1)

    def pick(a, b):
        return torch.where(cx, a, b)

    Ab = torch.stack([torch.stack([pick(m, l1), pick(root, one)], -1),
                      torch.stack([pick(-root, zero), pick(m, l2)], -1)], -2)
    Bb = torch.stack([one, pick(zero, one)], -1)
    Cb = torch.stack([pick(c1, g1_r), pick(g2_c, c1 - g1_r)], -1)
    Db = b0
    nb = Db.shape[0]
    k = torch.arange(nb)
    i, j = k[:, None], k[None, :]
    kk = k[None, None, :]
    between = (kk > j[..., None]) & (kk < i[..., None])
    gap = torch.where(between, Db, torch.ones_like(Db)).prod(-1)
    off = gap[..., None, None] * Bb[:, None, :, None] * Cb[None, :, None, :]
    blocks = torch.where((j < i)[..., None, None], off,
                         torch.where((j == i)[..., None, None], Ab[:, None],
                                     torch.zeros_like(off)))
    before = torch.where(j < i, Db[None, :], torch.ones_like(gap)).prod(-1)
    after = torch.where(j > i, Db[None, :], torch.ones_like(gap)).prod(-1)
    A = blocks.permute(0, 2, 1, 3).reshape(2 * nb, 2 * nb)
    Bv = (Bb * before[:, None]).reshape(-1)
    Cv = (Cb * after[:, None]).reshape(-1)
    D = Db.prod()
    d = A.shape[0]

    def powers(M, count):
        out = torch.eye(d, dtype=M.dtype)[None]
        while out.shape[0] < count:
            n = out.shape[0]
            head = out[-1] @ M
            out = torch.cat([out, head @ out[: min(n, count - n)]])
        return out

    def triangle(pows, n):
        kn = torch.arange(n)
        lag = kn[None, :] - kn[:, None]
        t = pows[lag.clamp(min=0)].transpose(-1, -2)
        t = torch.where((lag >= 0)[..., None, None], t, t.new_zeros(()))
        return t.permute(0, 2, 1, 3).reshape(n * d, n * d)

    f32 = torch.float32
    pu = powers(A, U + 1)
    CA_u = torch.einsum("a,uab->ub", Cv, pu[:U])
    group_in = pu[:U].flip(0) @ Bv
    seq = CA_u @ Bv
    uu = torch.arange(U)
    idx = uu[:, None] - 1 - uu[None, :]
    fir = torch.where(idx >= 0, seq[idx.clamp(0, U - 1)],
                      torch.zeros_like(seq))
    fir = fir + D * torch.eye(U, dtype=fir.dtype)
    pg = powers(pu[U], G + 1)
    pows_g = pg[:G].to(f32)
    carry_w = None
    if K is not None and 1 < K and K * d <= 2048:
        carry_w = triangle(powers(pg[G], K).to(f32), K)
    return (group_in.to(f32), CA_u.T.contiguous().to(f32),
            fir.T.contiguous().to(f32), triangle(pows_g, G), pows_g,
            pg[G].to(f32), carry_w)


def assert_same(got, want):
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
        assert torch.equal(torch.signbit(a), torch.signbit(b))


@pytest.mark.parametrize("geometry", [SMALL, SLIDER], ids=["small", "slider"])
@pytest.mark.parametrize("gains", GAIN_SETS)
def test_cpu_route_equals_the_replaced_body(gains, geometry):
    args = design_inputs(gains) + geometry
    before = eq_design.launches
    got = eq_design(*args)
    assert eq_design.launches == before        # the CPU runs no kernel
    want = frozen_dynamic_operators(*args)
    assert_same(got, want)
    assert_same(dynamic_operators_plain(*args), want)
    ops = ted.build_dynamic_operators(torch.tensor(gains), FS, EQConfig(),
                                      *geometry, device="cpu")
    assert_same(tuple(ops), want)


@pytest.fixture(scope="module")
def jax_operators():
    """The JAX traced builder's operators for every gain set at SMALL (one
    compile: the gains are traced)."""
    return [tuple(None if a is None else np.asarray(a)
                  for a in jed.build_dynamic_operators(
                      jnp.asarray(g, jnp.float32), FS, JEQConfig(), *SMALL))
            for g in GAIN_SETS]


@pytest.mark.parametrize("k", range(len(GAIN_SETS)))
def test_matches_the_jax_traced_builder(jax_operators, k):
    got = eq_design(*design_inputs(GAIN_SETS[k]), *SMALL)
    want = jax_operators[k]
    for name, a, b in zip(ted.DynOperators._fields, got, want):
        assert a.shape == b.shape, name
        scale = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * scale, name
    U, G, _ = SMALL
    F_ = 4 * G - 3                                   # K = 4 blocks, ragged
    x = np.random.default_rng(17).standard_normal((F_, U)).astype(np.float32)
    x *= 0.3
    z = ted.equalize_dynamic_frames_ops(torch.as_tensor(x),
                                        ted.DynOperators(*got),
                                        groups_per_block=G)
    z_jax = ted.equalize_dynamic_frames_ops(
        torch.as_tensor(x), ted.dyn_operators_from_numpy(want, "cpu"),
        groups_per_block=G)
    assert snr_db(z_jax.numpy().ravel(), z.numpy().ravel()) >= 90


@pytest.mark.parametrize("K,dense", [(1, False), (171, False), (170, True),
                                     (None, False)])
def test_carry_triangle_only_where_dense(K, dense):
    U, G = 20, 6
    got = eq_design(*design_inputs(GAIN_SETS[0]), U, G, K)
    if dense:
        assert got[6].shape == (K * 12, K * 12)
    else:
        assert got[6] is None
    assert cuda_layout(6, U, G, K)["K_dense"] == (K if dense else 0)


def test_cuda_layout_at_the_slider_geometry():
    """The chains' passes: the bits of each table's largest exponent of A
    (159, 160 * 128, 160 * 128 * 143 < 2^22); a pair of powers a block;
    two launches; a call's one scratch the transposed float32 pg and pk,
    and no flags."""
    lay = cuda_layout(6, *SLIDER)
    assert lay == {"d": 12, "K_dense": 144, "heads": (8, 15, 22),
                   "power_blocks": 80 + 65 + 72, "launches": 2,
                   "table_floats": (129 + 144) * 144}
    small = cuda_layout(6, 20, 6, 1)
    assert small["K_dense"] == 0 and small["heads"] == (5, 7, 0)
    assert small["power_blocks"] == 10 + 4
    assert [max(e, default=0).bit_length()
            for e in exponents(*SLIDER)] == list(lay["heads"])


@pytest.mark.parametrize("nb,U,G,K,match", [
    (9, 160, 128, 144, "bands"),
    (0, 160, 128, 144, "bands"),
    (6, 0, 128, 144, "U"),
    (6, 160, MAX_SIDE + 1, 144, "G"),
    (6, 160, 128, 0, "K"),
])
def test_cuda_layout_raises_beyond_the_kernels(nb, U, G, K, match):
    with pytest.raises(ValueError, match=match):
        cuda_layout(nb, U, G, K)
    # The plain version takes what the kernels do not.
    if nb == 9:
        cfg = EQConfig()
        centers = tuple(cfg.band_centers) + (("a", 150.0), ("b", 3000.0),
                                             ("c", 9000.0))
        s, c = ted._band_trig(FS, centers, cfg.nyquist_safety)
        out = eq_design(torch.zeros(9), torch.as_tensor(s),
                        torch.as_tensor(c), cfg.q, 0.1, 16, 4, 3)
        assert out[0].shape == (16, 18) and out[6].shape == (54, 54)


@pytest.mark.parametrize("K", [MAX_SIDE + 1, 18000, 1 << 20])
def test_cuda_layout_takes_any_K_past_the_dense_carry(K):
    """The kernels read K only as K_dense (0 once K d > 2048), so a long
    upload (K = 18,000: 60 s at one group a block) is no error."""
    lay = cuda_layout(6, 160, 128, K)
    assert lay["K_dense"] == 0 and lay["heads"] == (8, 15, 0)
    assert lay["power_blocks"] == 80 + 65
    assert lay["table_floats"] == 129 * 144


def test_wrapper_checks_its_arguments():
    g, s, c, q, thr = design_inputs(GAIN_SETS[0])
    with pytest.raises(TypeError, match="float32"):
        eq_design(g.double(), s, c, q, thr, 16, 4, 2)
    with pytest.raises(TypeError, match="float64"):
        eq_design(g, s.float(), c, q, thr, 16, 4, 2)
    with pytest.raises(ValueError, match=r"\(6,\)"):
        eq_design(g, s[:5], c, q, thr, 16, 4, 2)
    with pytest.raises(ValueError, match=r"\(nb,\)"):
        eq_design(g[None], s, c, q, thr, 16, 4, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        eq_design(g.to("meta"), s.to("meta"), c.to("meta"), q, thr, 16, 4, 2)


# ---- the kernel's schedule (design_schedule_mirror) -----------------------

# (gains, (U, G, K)): the small and slider geometries, 441/480's unroll
# (nine bits of A's chain), three bands (d = 6, d % 4 != 0: the 8-byte
# expand) and G = 1.
MIRROR_CASES = [(g, SMALL) for g in GAIN_SETS] + [
    (g, SLIDER) for g in GAIN_SETS] + [
    (GAIN_SETS[0], (441, 32, 40)), (GAIN_SETS[2], (441, 32, 40)),
    ((6.0, -3.0, 12.0), SLIDER), ((-15.0, 9.0, 0.05), (160, 16, 129)),
    (GAIN_SETS[0], (160, 1, 144)), (GAIN_SETS[1], (32, 1, 4)),
]


@pytest.mark.parametrize("gains,geometry", MIRROR_CASES)
def test_schedule_mirror_within_one_ulp_of_plain(gains, geometry):
    args = design_inputs(gains) + geometry
    want = dynamic_operators_plain(*args)
    got = design_schedule_mirror(*args)
    for name, a, b in zip(ted.DynOperators._fields, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert ulp_error(a, b) <= 1.0, name


def test_ordered_product_sums_in_k_order():
    """Each output's sum in k order, checked against that order spelled
    out, and near X @ Y."""
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.standard_normal((5, 12, 12)))
    Y = torch.as_tensor(rng.standard_normal((12, 12)))
    got = ordered_product(X, Y)
    for i, c in ((0, 0), (3, 7), (11, 11)):
        want = torch.zeros(5, dtype=torch.float64)
        for k in range(12):
            want = want + X[:, i, k] * Y[k, c]
        assert torch.equal(got[:, i, c], want)
    assert torch.allclose(got, X @ Y, rtol=1e-13, atol=1e-13)


def test_powers_mirror_feeds_each_power_its_heads():
    """A^e for e = 0 (the identity), a lone bit (a head, copied), and
    exponents of several bits against torch's matrix_power."""
    g, s, c, q, _ = design_inputs(GAIN_SETS[0])
    A = _compose_cascade(*_band_realization(s, c, g.double(), q))[0]
    exps = [0, 1, 2, 3, 64, 159, 160 * 37, 160 * 128 * 143]
    got = powers_mirror(A, exps)
    assert torch.equal(got[0], torch.eye(12, dtype=torch.float64))
    assert torch.equal(got[1], A)
    assert torch.equal(got[2], ordered_product(A, A))
    head = A
    for _ in range(6):
        head = ordered_product(head, head)
    assert torch.equal(got[4], head)                  # A^64, a head
    scale = float(A.abs().max())
    for e, P in zip(exps, got):
        want = torch.linalg.matrix_power(A, e)
        assert float((P - want).abs().max()) <= 1e-9 * scale, e


def test_design_phases_probe_reads_the_kernels_stamps():
    """scripts/design_phases.py names every stamp of the kernel's source
    (the chain's passes from its one ranged stamp) and defines the macro
    in its stamped copy."""
    from dsp_audio_project_tpu_torch.kernels import _build
    from dsp_audio_project_tpu_torch.scripts import design_phases as dp

    marked = dp.stamped((_build.CSRC / "eq_design.cu").read_text())
    assert "#define DESIGN_STAMP(phase) design_stamp(phase)" in marked
    names = dp.phases(marked)
    assert names[0] == ("design", "start")
    assert names[4] == ("design", "pass 0")
    assert names[34] == ("design", "pass 30")
    assert {"bands", "composition", "chain done", "zeros written",
            "R's powers written", "rows written"} <= {
                phase for _, phase in names.values()}


def test_library_bounds_at_the_cells_shapes():
    """scripts/library_bounds.py: the three library products at the cells'
    shapes (60 s at 160/147: 18,432 padded frames of P = 160), each bound
    the larger of its bytes and its operations."""
    from dsp_audio_project_tpu_torch.scripts.library_bounds import products

    got = products()
    shapes = [b["shape"] for b in got.values()]
    assert shapes == ["8 x (14, 187) @ (187, 160)",
                      "1 x (18432, 160) @ (160, 172)",
                      "8 x (18432, 160) @ (160, 172)"]
    slider = got["slider weight-concat x_g @ dyn_frames_weights"]
    nbytes = 4.0 * (18432 * 160 + 160 * 172 + 18432 * 172)
    assert slider["bytes_us"] == pytest.approx(nbytes / 3.35e12 * 1e6)
    assert slider["tf32x3_us"] == pytest.approx(
        3 * slider["fp32_us"] * 67 / 495)
