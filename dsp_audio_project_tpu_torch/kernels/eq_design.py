"""The dynamic EQ's device gain builder: CUDA kernels, wrapper, plain version.

From a gain vector on the device, the ``DynOperators`` tables of one gain
change, in float64 and rounded to float32 once at the end: each band's
peaking biquad as a 2-state system in closed form, the bands' series
composition into one order-d system (d = 2 nb), its powers pu = A^u
(u < U), pg = Q^g (g <= G, Q = A^U) and pk = R^k (k < K, R = Q^G), and
from them group_in (U, d), group_out (d, U), fir_t (U, U), toe (G d, G d),
pows_g (G, d, d), A_blk (d, d) and carry_w (K d, K d), which is None
unless the dense carry is built (1 < K and K d <= 2048).

Replaces no TPU kernel: the JAX package builds these tables with plain JAX
ops in df32 (``dsp_audio_project_tpu/ops/eq_dynamic.py:228
_dynamic_operators``, ``:304 _lower_triangle``, ``:536
build_dynamic_operators``).  Written by hand because the plain torch
version, ~220 small float64 ops a gain change, was half of a slider
render's device time.  Two launches (``csrc/eq_design.cu``): in
``eq_design_f64_kernel`` a power block owns a pair of powers of one
table, each A^e for its exponent e (u, U g or U G k), designs the bands
itself and squares the heads A^(2^i) in a chain, multiplying each power's
running product by the heads of its exponent's set bits side by side with
the squarings, then writes its powers' share of the small tables (and the
powers of Q and R, transposed, to a table); the other blocks write the
zeros left of the triangles' block diagonal meanwhile.  No block waits for
another.  ``eq_expand_f64_kernel``, a programmatic dependent launch,
writes the triangles' rows from their diagonal block on.  The chain (22
passes at the slider's geometry, U = 160, G = 128, K = 144, d = 12) is
bound by its latency, the tables' ~21.5 MB by bytes.

``dynamic_operators_plain`` is the torch body the kernels replace, kept as
it was (``ops/eq_dynamic.py`` before them): the wrapper's route for a CPU
tensor, and what the card tests and ``chip_smoke.py`` hold the kernels
against.  It raises the powers by batched doubling; the kernels multiply
the same float64 values in another order, so every table agrees with it
to one float32 ulp of the table's largest magnitude.
``design_schedule_mirror`` repeats the kernel's order in float64 torch
ops (which heads feed which power, each product's sum in k order) for the
CPU tests and ``chip_smoke.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

_LAUNCHERS = {
    "eq_design_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 9,
    "eq_design_occupancy": [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "eq_design_grid": [ctypes.c_int] * 4 + [ctypes.c_void_p],
}

# Dense-carry ceiling: up to this K*d the block carry is ONE (K d, K d)
# triangle product; above it the log-depth scan.  2048: a 16 MB f32 table.
_CARRY_DENSE_MAX_KD = 2048

MAX_BANDS = 8              # the kernel's instantiations: d = 2 .. 16
MAX_SIDE = 1 << 14         # U, G and a dense carry's K: keeps every index
                           # of the kernels in int


def _dense_carry(K: Optional[int], d: int) -> bool:
    return K is not None and 1 < K and K * d <= _CARRY_DENSE_MAX_KD


# ---- the plain version (float64 torch ops) --------------------------------


def _band_realization(sin_w0, cos_w0, gain_db, q: float):
    """The peaking biquads (Q = q) of every band as 2-state systems in closed
    form, float64, vectorized over the nb bands: (A (nb, 2, 2), B (nb, 2),
    C (nb, 2), D (nb,)).

    disc/4 = sin^2(w0) (1/A^2 - 4) / (4 a0^2) has an exact sign: poles are
    complex for amp > 1/2.  A complex pair is the rotation block [[m, r],
    [-r, m]] with B = [1, 0]; a real pair [[l1, 1], [0, l2]] with B = [1, 1]
    (the unit coupling keeps the maps bounded as l1 -> l2).  Both branches
    are computed and ``torch.where`` picks one; the divisions of the branch
    not taken are guarded, so no Inf or NaN reaches a product or a
    gradient.
    """
    one = torch.ones_like(gain_db)
    zero = torch.zeros_like(gain_db)
    amp = torch.pow(10.0, gain_db / 40.0)
    alpha = sin_w0 / (2.0 * q)
    al_over = alpha / amp
    al_times = alpha * amp
    a0 = 1.0 + al_over
    a1 = -2.0 * cos_w0 / a0
    a2 = (1.0 - al_over) / a0
    b0 = (1.0 + al_times) / a0
    # b1 == a1: the numerator residual c(z) = c1 z + c0 with c1 = a1 (1 - b0)
    # and 1 - b0 in closed form, alpha (1/A - A) / a0, free of cancellation.
    c1 = a1 * (alpha * (1.0 / amp - amp) / a0)
    c0 = (1.0 - al_times) / a0 - b0 * a2
    m = -0.5 * a1
    disc4 = sin_w0 * sin_w0 * (1.0 / (amp * amp) - 4.0) / (4.0 * a0 * a0)
    is_complex = disc4 < 0.0
    root = torch.sqrt(disc4.abs())

    # Complex pair: C adj(zI - A) B = g1 z - g1 m - g2 r with g1 = c1,
    # g2 = -(c0 + c1 m) / r.
    r_safe = torch.where(is_complex, root.clamp(min=1e-300), one)
    g2_c = -(c0 + c1 * m) / r_safe
    # Real pair: g1 (1 - l2 + l1) = c0 + c1 l1 and g2 = c1 - g1.
    l1, l2 = m + root, m - root
    denom = torch.where(is_complex, one, 1.0 - l2 + l1)
    g1_r = (c0 + c1 * l1) / denom

    def pick(c, r):
        return torch.where(is_complex, c, r)

    A = torch.stack([torch.stack([pick(m, l1), pick(root, one)], -1),
                     torch.stack([pick(-root, zero), pick(m, l2)], -1)], -2)
    B = torch.stack([one, pick(zero, one)], -1)
    C = torch.stack([pick(c1, g1_r), pick(g2_c, c1 - g1_r)], -1)
    return A, B, C, b0


def _compose_cascade(A, B, C, D):
    """Series composition of nb 2-state bands (band 0 first) into one
    order-2nb system, as ``design.biquad.series`` folds them: block (i, i)
    of A is A_i, block (i, j < i) is B_i C_j times the D of the bands
    between them; B_i carries the D of the bands before it, C_j of those
    after it.  Returns (A (2nb, 2nb), B (2nb,), C (2nb,), D ())."""
    nb = D.shape[0]
    k = torch.arange(nb, device=D.device)
    i, j = k[:, None], k[None, :]
    kk = k[None, None, :]
    between = (kk > j[..., None]) & (kk < i[..., None])           # j < k < i
    gap = torch.where(between, D, torch.ones_like(D)).prod(-1)    # (i, j)
    off = gap[..., None, None] * B[:, None, :, None] * C[None, :, None, :]
    blocks = torch.where((j < i)[..., None, None], off,
                         torch.where((j == i)[..., None, None], A[:, None],
                                     torch.zeros_like(off)))
    before = torch.where(j < i, D[None, :], torch.ones_like(gap)).prod(-1)
    after = torch.where(j > i, D[None, :], torch.ones_like(gap)).prod(-1)
    return (blocks.permute(0, 2, 1, 3).reshape(2 * nb, 2 * nb),
            (B * before[:, None]).reshape(-1),
            (C * after[:, None]).reshape(-1), D.prod())


def _cumulative_powers(A: torch.Tensor, count: int) -> torch.Tensor:
    """[I, A, ..., A^{count-1}] by batched doubling: log2(count) products,
    each of a shape fixed by ``count`` alone."""
    out = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)[None]
    while out.shape[0] < count:
        m = out.shape[0]
        head = out[-1] @ A                               # A^m
        out = torch.cat([out, head @ out[: min(m, count - m)]])
    return out


def _lower_triangle(pows: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(n d, n d) block Toeplitz with block (v, r) = pows[r-v]^T for v <= r.

    Row-vector convention: vecs_flat @ result accumulates pows[r-v] vecs[v]
    into slot r, the expanded lower-triangular recurrence solve.  One
    gather of the n x n blocks (a copy, exact).
    """
    k = torch.arange(n, device=pows.device)
    lag = k[None, :] - k[:, None]                       # [v, r] = r - v
    blocks = pows[lag.clamp(min=0)].transpose(-1, -2)   # [v, r] = pows[r-v]^T
    blocks = torch.where((lag >= 0)[..., None, None], blocks,
                         blocks.new_zeros(()))
    return blocks.permute(0, 2, 1, 3).reshape(n * d, n * d)


def dynamic_operators_plain(gains_db: torch.Tensor, sin_w0: torch.Tensor,
                            cos_w0: torch.Tensor, q: float,
                            threshold_db: float, U: int, G: int,
                            K: Optional[int] = None) -> tuple:
    """The plain version: float64 design on gains' device, tables rounded
    to float32 at the end (they are float32 views of one float64 system).
    Returns (group_in, group_out, fir_t, toe, pows_g, A_blk, carry_w), the
    ``DynOperators`` field order."""
    g = gains_db.to(torch.float64)
    # The reference's band skip (dsp_core.py:234): a 0 dB band is exactly
    # the identity (b == a), so masking reproduces the skip.
    g = torch.where(g.abs() > threshold_db, g, torch.zeros_like(g))
    A, Bv, Cv, D = _compose_cascade(*_band_realization(sin_w0, cos_w0, g, q))
    d = A.shape[0]
    f32 = torch.float32

    pu = _cumulative_powers(A, U + 1)                    # (U+1, d, d)
    CA_u = torch.einsum("a,uab->ub", Cv, pu[:U])         # (U, d): C A^u
    group_in = pu[:U].flip(0) @ Bv                       # (U, d): A^{U-1-v} B
    seq = CA_u @ Bv                                      # (U,):  C A^u B
    uu = torch.arange(U, device=g.device)
    idx = uu[:, None] - 1 - uu[None, :]
    fir = torch.where(idx >= 0, seq[idx.clamp(0, U - 1)],
                      torch.zeros_like(seq))
    fir = fir + D * torch.eye(U, dtype=fir.dtype, device=fir.device)
    pg = _cumulative_powers(pu[U], G + 1)                # (G+1, d, d): (A^U)^g
    pows_g = pg[:G].to(f32)
    carry_w = None
    if _dense_carry(K, d):
        carry_w = _lower_triangle(_cumulative_powers(pg[G], K).to(f32), K, d)
    return (group_in.to(f32), CA_u.T.contiguous().to(f32),
            fir.T.contiguous().to(f32), _lower_triangle(pows_g, G, d),
            pows_g, pg[G].to(f32), carry_w)


# ---- the CUDA route -------------------------------------------------------


def exponents(U: int, G: int, k_dense: int) -> tuple:
    """The kernel's powers as exponents of A: (u for u < U, U g for g <=
    G, U G k for k < K_dense)."""
    return (list(range(U)), [U * g for g in range(G + 1)],
            [U * G * k for k in range(k_dense)])


def cuda_layout(nb: int, U: int, G: int, K: Optional[int]) -> dict:
    """The kernel's geometry for nb bands at (U, G, K), or ValueError
    where the CUDA route does not take the shape (nb above ``MAX_BANDS``, U
    or G outside 1..``MAX_SIDE``, K below 1).  The kernel reads K only as
    ``K_dense``, which the dense carry's K d <= 2048 bounds, so any K >= 1
    (or None) is taken.

    ``K_dense``: K when the dense carry is built, else 0.  ``heads``: the
    bits of each table's largest exponent of A (A^u, Q^g, R^k), the passes
    of its blocks' chain.  ``power_blocks``: a pair of powers a block (the
    design kernel's other blocks write zeros).  ``launches``: two, the
    design kernel and the expand.  ``table_floats``: the transposed float32
    pg and pk the expand reads, the one scratch a call allocates besides
    its outputs (no flags: no block waits for another of its grid)."""
    if not 1 <= nb <= MAX_BANDS:
        raise ValueError(f"the CUDA gain builder takes 1..{MAX_BANDS} bands "
                         f"(d <= {2 * MAX_BANDS}), got {nb}")
    for name, v in (("U", U), ("G", G)):
        if not 1 <= v <= MAX_SIDE:
            raise ValueError(f"the CUDA gain builder takes {name} in "
                             f"1..{MAX_SIDE}, got {v}")
    if K is not None and K < 1:
        raise ValueError(f"the CUDA gain builder takes K >= 1, got {K}")
    d = 2 * nb
    k_dense = K if _dense_carry(K, d) else 0
    heads = ((U - 1).bit_length(), (U * G).bit_length(),
             (U * G * (k_dense - 1)).bit_length() if k_dense else 0)
    blocks = sum((n + 1) // 2 for n in (U, G + 1, k_dense))
    return {"d": d, "K_dense": k_dense, "heads": heads,
            "power_blocks": blocks, "launches": 2,
            "table_floats": (G + 1 + k_dense) * d * d}


def _launch(gains, sin_w0, cos_w0, q, threshold_db, U, G, lay, outs,
            table):
    lib = _build.load("eq_design", _LAUNCHERS)
    group_in, group_out, fir_t, toe, pows_g, A_blk, carry_w = outs
    with torch.cuda.device(gains.device):
        err = lib.eq_design_launch(
            gains.data_ptr(), sin_w0.data_ptr(), cos_w0.data_ptr(),
            gains.shape[0], U, G, lay["K_dense"], 2.0 * q, threshold_db,
            group_in.data_ptr(), group_out.data_ptr(), fir_t.data_ptr(),
            toe.data_ptr(), pows_g.data_ptr(), A_blk.data_ptr(),
            0 if carry_w is None else carry_w.data_ptr(), table.data_ptr(),
            torch.cuda.current_stream(gains.device).cuda_stream,
        )
    _build.check(lib, err, "eq_design_launch")


def eq_design(gains_db: torch.Tensor, sin_w0: torch.Tensor,
              cos_w0: torch.Tensor, q: float, threshold_db: float, U: int,
              G: int, K: Optional[int] = None) -> tuple:
    """The tables of one gain change -> (group_in, group_out, fir_t, toe,
    pows_g, A_blk, carry_w), float32 on gains' device (``DynOperators``'
    field order; carry_w None unless 1 < K and K d <= 2048).

    ``gains_db`` (nb,) float32; ``sin_w0``, ``cos_w0`` (nb,) float64, the
    bands' geometry at the output rate (Nyquist clamp applied); ``q``, the
    bands' Q; ``threshold_db``, the band-skip threshold; U, G, K the
    unroll, groups a block and blocks.  A CPU tensor runs the plain
    version; a CUDA tensor launches the two kernels (``cuda_layout``
    raises for a shape they do not take); anything else raises.
    """
    if not isinstance(gains_db, torch.Tensor) or gains_db.dtype != torch.float32:
        raise TypeError(f"gains_db must be a float32 tensor, got "
                        f"{getattr(gains_db, 'dtype', type(gains_db))}")
    if gains_db.ndim != 1:
        raise ValueError(f"gains_db must be (nb,), got {tuple(gains_db.shape)}")
    nb = gains_db.shape[0]
    for name, t in (("sin_w0", sin_w0), ("cos_w0", cos_w0)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float64:
            raise TypeError(f"{name} must be a float64 tensor")
        if tuple(t.shape) != (nb,):
            raise ValueError(f"{name} {tuple(t.shape)} must be ({nb},)")
        if t.device != gains_db.device:
            raise ValueError(f"{name} is on {t.device}, gains on "
                             f"{gains_db.device}")
    if not (U >= 1 and G >= 1):
        raise ValueError(f"U and G must be >= 1, got {U}, {G}")
    dev = gains_db.device
    if dev.type == "cpu":
        return dynamic_operators_plain(gains_db, sin_w0, cos_w0, q,
                                       threshold_db, U, G, K)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lay = cuda_layout(nb, U, G, K)
    d, kd = lay["d"], lay["K_dense"]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = (empty(U, d), empty(d, U), empty(U, U), empty(G * d, G * d),
            empty(G, d, d), empty(d, d), empty(kd * d, kd * d) if kd else None)
    _launch(gains_db.contiguous(), sin_w0.contiguous(), cos_w0.contiguous(),
            q, threshold_db, U, G, lay, outs, empty(lay["table_floats"]))
    eq_design.launches += 1
    return outs


eq_design.launches = 0


def occupancy(which: str, nb: int) -> dict:
    """The card's view of a kernel (``which``: 'design' or 'expand') at nb
    bands: blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local (spilled) bytes a thread, static shared bytes and
    threads a block."""
    lib = _build.load("eq_design", _LAUNCHERS)
    out = (ctypes.c_int * 5)()
    err = lib.eq_design_occupancy(("design", "expand").index(which), nb, out)
    _build.check(lib, err, "eq_design_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes", "threads"), out))


def launch_grid(nb: int, U: int, G: int, K: Optional[int]) -> dict:
    """What the launcher gives the card for one call at (nb, U, G, K):
    launches, the design kernel's blocks (power blocks first, then zero
    blocks) and its power blocks."""
    lib = _build.load("eq_design", _LAUNCHERS)
    out = (ctypes.c_int * 3)()
    err = lib.eq_design_grid(nb, U, G, cuda_layout(nb, U, G, K)["K_dense"],
                             out)
    _build.check(lib, err, "eq_design_grid")
    return dict(zip(("launches", "blocks", "power_blocks"), out))


# ---- the kernel's schedule in float64 torch ops (tests, chip_smoke.py) -----


def ordered_product(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X @ Y for (..., d, d) float64, each output's d-term sum in k order,
    as the kernel's k-steps of 4 run in order on the tensor cores (which
    fuse each multiply-add; here each product is rounded first)."""
    acc = torch.zeros(torch.broadcast_shapes(X.shape, Y.shape),
                      dtype=X.dtype, device=X.device)
    for k in range(X.shape[-1]):
        acc = acc + X[..., :, k, None] * Y[..., None, k, :]
    return acc


def powers_mirror(A: torch.Tensor, exps) -> torch.Tensor:
    """A^e for each exponent in ``exps`` (n, d, d), float64, in the
    kernel's order: pass p squares head p (A^(2^p)) into head p + 1 and
    multiplies the running product of each exponent with bit p by head p
    (run @ head; its first factor copied).  0 gives the identity."""
    e = torch.tensor(list(exps), dtype=torch.int64, device=A.device)
    d = A.shape[-1]
    run = torch.eye(d, dtype=A.dtype, device=A.device).repeat(len(e), 1, 1)
    started = torch.zeros(len(e), dtype=torch.bool, device=A.device)
    head = A
    for p in range(int(e.max()).bit_length() if len(e) else 0):
        take = ((e >> p) & 1).bool()
        grown = ordered_product(run, head)
        run = torch.where((take & started)[:, None, None], grown,
                          torch.where((take & ~started)[:, None, None],
                                      head.expand_as(run), run))
        started |= take
        head = ordered_product(head, head)
    return run


def design_schedule_mirror(gains_db: torch.Tensor, sin_w0: torch.Tensor,
                           cos_w0: torch.Tensor, q: float,
                           threshold_db: float, U: int, G: int,
                           K: Optional[int] = None) -> tuple:
    """The kernel's tables by its schedule, float64 torch ops rounded to
    float32 at the end, in ``dynamic_operators_plain``'s field order: the
    plain version's band design and composition (the kernel repeats its
    operations), every power by ``powers_mirror``, the vectors' sums in the
    kernel's k order, fir_t and the triangles as the kernel writes them."""
    g = gains_db.to(torch.float64)
    g = torch.where(g.abs() > threshold_db, g, torch.zeros_like(g))
    A, Bv, Cv, D = _compose_cascade(*_band_realization(sin_w0, cos_w0, g, q))
    d = A.shape[0]
    f32 = torch.float32
    k_dense = K if _dense_carry(K, d) else 0
    e_u, e_g, e_k = exponents(U, G, k_dense)
    pu = powers_mirror(A, e_u)                             # (U, d, d)
    pg = powers_mirror(A, e_g)                             # (G + 1, d, d)
    gin = torch.zeros(U, d, dtype=A.dtype, device=A.device)
    CA_u = torch.zeros(U, d, dtype=A.dtype, device=A.device)
    for k in range(d):
        gin = gin + pu[:, :, k] * Bv[k]
        CA_u = CA_u + Cv[k] * pu[:, k, :]
    seq = torch.zeros(U, dtype=A.dtype, device=A.device)
    for c in range(d):
        seq = seq + CA_u[:, c] * Bv[c]
    uu = torch.arange(U, device=A.device)
    idx = uu[:, None] - 1 - uu[None, :]
    fir = torch.where(idx >= 0, seq[idx.clamp(0, U - 1)],
                      torch.zeros_like(seq))
    fir = fir + D * torch.eye(U, dtype=fir.dtype, device=fir.device)
    pows_g = pg[:G].to(f32)
    carry_w = None
    if k_dense:
        carry_w = _lower_triangle(powers_mirror(A, e_k).to(f32), k_dense,
                                  d)
    return (gin.flip(0).to(f32), CA_u.T.contiguous().to(f32),
            fir.T.contiguous().to(f32), _lower_triangle(pows_g, G, d),
            pows_g, pg[G].to(f32), carry_w)


def ulp_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| in float32 ulps of max |ref| (0 where both are all
    zeros; inf where only ref is)."""
    err = float((got.double() - ref.double()).abs().max()) if ref.numel() else 0.0
    top = float(ref.abs().max()) if ref.numel() else 0.0
    if top == 0.0:
        return 0.0 if err == 0.0 else math.inf
    return err / math.ldexp(1.0, math.frexp(top)[1] - 24)
