"""Dynamic-gain EQ: the band gains as an input, so a new gain vector needs
no host redesign of the chain and grows no table cache.

Counterpart of ``dsp_audio_project_tpu/ops/eq_dynamic.py``.  The static
path (ops/eq.py) designs the active bands on the host and caches their
tables per gain vector; here every gain change builds one ``DynOperators``
of device tables, which the per-batch apply side takes as an argument:

* ``build_dynamic_operators_host`` (the serving builder for concrete
  gains): float64 numpy tables of the float32-quantized Schur system
  (``host_dyn_tables``, a copy of the JAX package's, held bit for bit by
  the tests), a small upload (``upload_dyn_tables``) and the two large
  triangles expanded on the device (``_expand_dyn_operators``);
* ``build_dynamic_operators`` (gains as a device tensor): the whole design
  on the device in float64, rounded to float32 at the end, by
  ``kernels/eq_design.eq_design``: on the card three hand-written kernels
  (``csrc/eq_design.cu``), on the CPU the plain torch version.  Each band
  is a 2x2 realization in closed form (a rotation block for a complex pole
  pair, [[l1, 1], [0, l2]] for a real one), the six bands compose into one
  order-12 system, and the block tables are views of its powers.  It
  never reads a value back to the host, so a gain change can be captured
  in a CUDA graph.  The JAX package builds in df32 because a TPU has no
  float64; the H100 has it, so ``utils/df32.py`` is not ported.

The apply side is the static path's algebra on these tables: the group
Toeplitz solve and the block carry (up to K*d = 2048, where the builder
makes the dense carry triangle, the two kernels of ``group_true_states``,
which read the triangle's first block row; else the zero-entry scan, the
log-depth carry scan, ``dyn_block_carry``, and the entry states), and
the readout with the clip as one K9 pass (``kernels/eq_finish``).  The cat
path's operator G2 = G @ [fir_t | group_in] is one float64 device product
per gain change (``build_cat_tables_dyn``); the JAX package's rotated
banks, DPAD packing and bf16 hi/lo split are TPU layouts and are not
ported.  Every product is float32: ``fast`` is accepted and has no effect.

The sharded stream's dynamic mode (streaming.py) takes
``DynStreamOperators``: the same tables plus its carry tables (pk, the
cross-shard weights, w_out, pow_nb, the local carry triangle), built on
the host in float64 by ``build_dynamic_stream_operators_host`` as the JAX
package builds them, bit for bit; ``dyn_stream_operators_from_numpy``
carries the JAX package's across (tests).

Semantics, the dynamic path's and not the static path's: all six bands are
kept (d = 12), a gain with |g| <= 0.1 dB is masked to an exact 0 dB band,
and the output is always clipped.  Nothing here calls
``cfg.active_bands``, ``ops/eq.make_block_operators`` or
``ops/eq.block_tables``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EQConfig
from ..design.biquad import cascade_state_space, peaking_coeffs, schur_form
from ..kernels.eq_design import _dense_carry, _lower_triangle, eq_design
from ..kernels.eq_finish import eq_finish
from ..kernels.fir_class import plan_operator
from ..kernels.group_states import group_true_states
from ..utils.device import as_input, default_device, device_tables
from .eq import _carry_states, _entry_states, _group_states


class DynOperators(NamedTuple):
    """Block operators of one gain vector: float32 tensors on one device."""

    group_in: torch.Tensor    # (U, d)   A^{U-1-v} B
    group_out: torch.Tensor   # (d, U)   (C A^u)^T columns
    fir_t: torch.Tensor       # (U, U)   group_fir^T
    toe: torch.Tensor         # (G d, G d) within-block group Toeplitz
    pows_g: torch.Tensor      # (G, d, d)  A^{gU}
    A_blk: torch.Tensor       # (d, d)   A^block
    carry_w: Optional[torch.Tensor]  # (K d, K d) dense carry triangle or None


class CatDynTables(NamedTuple):
    """The cat path's per-gain-change table: K1's operator."""

    g2: torch.Tensor          # (W, P + d) float32, G @ [fir_t | group_in]


# ---- the host builder (float64 numpy, as the JAX package's) ---------------


def _host_powers(A, count: int):
    """[I, A, ..., A^{count-1}] float64 via batched doubling (host numpy)."""
    d = A.shape[0]
    out = np.eye(d)[None]
    while out.shape[0] < count:
        m = out.shape[0]
        take = min(m, count - m)
        head = out[-1] @ A                       # A^m
        out = np.concatenate(
            [out, np.einsum("ab,jbc->jac", head, out[:take])]
        )
    return out


def host_dyn_tables(
    gains_db,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: Optional[int] = None,
):
    """Host-float64 half of the serving builder: the small numpy tables.

    Returns (group_in (U, d), group_out_T (d, U), fir_T (U, U),
    pows_g (G, d, d), A_blk (d, d), pk (K, d, d) | None) as float64 numpy:
    everything ``_expand_dyn_operators`` needs.
    """
    g = np.asarray(gains_db, np.float64).reshape(-1).copy()
    g[np.abs(g) <= cfg.bypass_threshold_db] = 0.0
    ceiling = (fs / 2.0) * cfg.nyquist_safety
    sections = []
    for (name, fc), gain in zip(cfg.band_centers, g):
        fc_eff = ceiling if fc >= ceiling else fc
        sections.append(peaking_coeffs(fc_eff, fs, float(gain), cfg.q))
    ss = schur_form(cascade_state_space(sections))

    A32 = ss.A.astype(np.float32).astype(np.float64)
    B32 = ss.B.astype(np.float32).astype(np.float64)
    C32 = ss.C.astype(np.float32).astype(np.float64)
    D32 = float(np.float32(ss.D))
    d = ss.order
    U, G, K = unroll, groups_per_block, num_blocks

    pu = _host_powers(A32, U + 1)                       # (U+1, d, d)
    group_in = pu[U - 1 :: -1] @ B32                    # (U, d): A^{U-1-v} B
    CA_u = np.einsum("a,uab->ub", C32, pu[:U])          # (U, d): C A^u
    seq = CA_u @ B32                                    # (U,):  C A^u B
    uu = np.arange(U)
    idx = uu[:, None] - 1 - uu[None, :]
    fir = np.where(idx >= 0, seq[np.clip(idx, 0, U - 1)], 0.0)
    fir = fir + D32 * np.eye(U)
    pg = _host_powers(pu[U], G + 1)                     # (G+1, d, d): (A^U)^g
    pk = None
    if _dense_carry(K, d):
        pk = _host_powers(pg[G], K)                     # (K, d, d)
    return (group_in, CA_u.T, fir.T, pg[:G], pg[G], pk)


def upload_dyn_tables(tabs, device):
    """``host_dyn_tables``' output as float32 tensors on ``device`` (the
    upload phase)."""
    return tuple(None if a is None
                 else torch.as_tensor(np.array(a, np.float32, order="C"),
                                     device=device)
                 for a in tabs)


def _expand_dyn_operators(group_in, group_out, fir_t, pows_g, A_blk, pk
                          ) -> DynOperators:
    """Device half of the host builder: the two large triangles."""
    d = pows_g.shape[-1]
    carry_w = None if pk is None else _lower_triangle(pk, pk.shape[0], d)
    return DynOperators(
        group_in=group_in, group_out=group_out, fir_t=fir_t,
        toe=_lower_triangle(pows_g, pows_g.shape[0], d), pows_g=pows_g,
        A_blk=A_blk, carry_w=carry_w,
    )


def build_dynamic_operators_host(
    gains_db,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: Optional[int] = None,
    device=None,
) -> DynOperators:
    """``DynOperators`` for concrete gains (host values), designed in float64
    numpy as the static path designs (the float32-quantized Schur system):
    ``host_dyn_tables``, ``upload_dyn_tables``, ``_expand_dyn_operators``.

    ``device``: the card unless the caller asks for another.
    ``num_blocks``: K = ceil(F / groups_per_block), to also build the
    dense carry triangle (1 < K and K*d <= 2048).
    """
    if device is None:
        device = default_device("build_dynamic_operators_host")
    tabs = host_dyn_tables(gains_db, fs, cfg, unroll, groups_per_block,
                           num_blocks)
    return _expand_dyn_operators(*upload_dyn_tables(tabs, device))


def dyn_operators_from_numpy(arrays: Sequence, device) -> DynOperators:
    """``DynOperators`` from arrays in its field order (a JAX
    ``DynOperators``, or numpy arrays; carry_w may be None), as float32
    tensors on ``device``."""
    arrays = tuple(arrays)
    if len(arrays) != len(DynOperators._fields):
        raise ValueError(f"expected {len(DynOperators._fields)} arrays "
                         f"({', '.join(DynOperators._fields)}), got "
                         f"{len(arrays)}")
    return DynOperators(*upload_dyn_tables(arrays, device))


class DynStreamOperators(NamedTuple):
    """``DynOperators`` + the sharded stream's carry tables (float32 tensors
    on one device), as the JAX package's:

    * ``pk[k]`` = (A^block)^k for k < K_loc;
    * ``weights`` (nb, nb, d, d): [dst, src] = A_shard^{dst-1-src} for
      src < dst (A_shard = A^{block*K_loc}), the cross-shard map;
    * ``w_out[i]`` = A_shard^{nb-1-i}, the outgoing carry's weights;
    * ``pow_nb[k]`` = A_shard^k for k <= nb, the incoming carry's;
    * ``carry_loc`` (K_loc d, K_loc d): the local carry triangle mapping
      [0, e_0..e_{K-2}] to [sigma_0..sigma_{K-1}], None when K_loc == 1.

    ``ShardedStreamProcessor.set_gains`` copies a new set into the step's
    table buffers in place, so a captured step is replayed as it is.
    """

    ops: DynOperators
    pk: torch.Tensor
    weights: torch.Tensor
    w_out: torch.Tensor
    pow_nb: torch.Tensor
    carry_loc: Optional[torch.Tensor]


def build_dynamic_stream_operators_host(
    gains_db,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: int = 1,
    num_shards: int = 1,
    device=None,
) -> DynStreamOperators:
    """``DynStreamOperators`` for concrete gains: float64 numpy tables
    (``host_dyn_tables`` without its pk, then pk, weights, w_out and
    pow_nb, computed as the JAX package computes them) rounded to float32
    last, uploaded, and the two triangles (the group Toeplitz, the local
    carry) expanded on the device by exact gathers; the same float32
    values as the JAX package's builder.  ``num_blocks`` = K_loc (EQ
    blocks a step), ``num_shards`` = nb (the mesh's block axis).
    ``device``: the card unless the caller asks for another."""
    if device is None:
        device = default_device("build_dynamic_stream_operators_host")
    tabs = host_dyn_tables(gains_db, fs, cfg, unroll, groups_per_block)
    A_blk = tabs[4]
    d, K, nb = A_blk.shape[0], num_blocks, num_shards
    pk = _host_powers(A_blk, K)                         # (K, d, d)
    A_shard = np.linalg.matrix_power(A_blk, K)          # A^{block*K}
    pow_nb = _host_powers(A_shard, nb + 1)              # (nb+1, d, d)
    weights = np.zeros((nb, nb, d, d))
    for dst in range(nb):
        for srcd in range(dst):
            weights[dst, srcd] = pow_nb[dst - 1 - srcd]
    w_out = np.stack([pow_nb[nb - 1 - i] for i in range(nb)])
    ops = _expand_dyn_operators(*upload_dyn_tables(tabs[:5] + (None,),
                                                   device))
    pk, weights, w_out, pow_nb = upload_dyn_tables(
        (pk, weights, w_out, pow_nb), device)
    carry_loc = _lower_triangle(pk, K, d) if K > 1 else None
    return DynStreamOperators(ops=ops, pk=pk, weights=weights, w_out=w_out,
                              pow_nb=pow_nb, carry_loc=carry_loc)


def dyn_stream_operators_from_numpy(arrays, device) -> DynStreamOperators:
    """``DynStreamOperators`` from arrays in its field order (a JAX
    ``DynStreamOperators``: its ``ops`` as in ``dyn_operators_from_numpy``,
    then pk, weights, w_out, pow_nb and carry_loc, which may be None), as
    float32 tensors on ``device``."""
    arrays = tuple(arrays)
    if len(arrays) != len(DynStreamOperators._fields):
        raise ValueError(f"expected {len(DynStreamOperators._fields)} "
                         f"entries ({', '.join(DynStreamOperators._fields)})"
                         f", got {len(arrays)}")
    return DynStreamOperators(dyn_operators_from_numpy(arrays[0], device),
                              *upload_dyn_tables(arrays[1:], device))


# ---- the device builder (gains as a device tensor, float64) ---------------


def _band_trig(fs: int, band_centers, nyquist_safety: float):
    """(sin w0, cos w0) float64 numpy (nb,) of the bands at rate fs, the
    Nyquist clamp applied as in the JAX builder.  Held on the device by
    ``utils/device.device_tables``, so that a captured gain change copies
    nothing from the host."""
    ceiling = (fs / 2.0) * nyquist_safety
    w0 = np.array([2.0 * np.pi * (ceiling if fc >= ceiling else fc) / fs
                   for _, fc in band_centers])
    return np.sin(w0), np.cos(w0)


def _dynamic_operators(gains_db: torch.Tensor, fs: int, cfg: EQConfig,
                       U: int, G: int, K: Optional[int] = None
                       ) -> DynOperators:
    """The device builder's body: ``kernels/eq_design.eq_design`` on the
    gains' device (the two float64 kernels on the card, the plain torch
    version on the CPU).  ``K`` as in ``build_dynamic_operators``."""
    sin_w0, cos_w0 = device_tables(_band_trig, int(fs), cfg.band_centers,
                                   cfg.nyquist_safety, device=gains_db.device)
    return DynOperators(*eq_design(gains_db, sin_w0, cos_w0, cfg.q,
                                   cfg.bypass_threshold_db, U, G, K))


def build_dynamic_operators(
    gains_db,
    fs: int,
    cfg: EQConfig = EQConfig(),
    unroll: int = 128,
    groups_per_block: int = 128,
    num_blocks: Optional[int] = None,
    device=None,
) -> DynOperators:
    """``DynOperators`` from gains as a device tensor (the device builder).

    ``gains_db`` (nb,), ordered like ``cfg.band_centers``: a tensor stays
    on its device; other input goes to ``device`` (the card by default).
    The design runs on that device in float64 and reads nothing back to the
    host, so the call can be captured in a CUDA graph (after a first call
    has put the band geometry on the device).  ``num_blocks``: K, to also
    build the dense carry triangle (1 < K and K*d <= 2048).
    """
    gains = as_input(gains_db, device, "build_dynamic_operators")
    return _dynamic_operators(gains, fs, cfg, unroll, groups_per_block,
                              num_blocks)


# ---- the apply side ------------------------------------------------------


def dyn_block_carry(e_states: torch.Tensor, carry_w: Optional[torch.Tensor],
                    A_blk: torch.Tensor) -> torch.Tensor:
    """Zero-init cross-block carry sigma_{k+1} = A_blk sigma_k + e_k over
    (..., K, d): one product against ``carry_w`` where the builder made it,
    else the log-depth scan (``ops/eq._carry_states``, the static path's
    carry)."""
    return _carry_states(e_states, A_blk, carry_w)


def _dyn_states(inj: torch.Tensor, ops: DynOperators) -> torch.Tensor:
    """The true state entering each group, (..., K, G, d), from the
    injections (..., K, G, d): where the builder made the carry triangle,
    ``group_true_states`` (on the card the ends and solve kernels); else
    the zero-entry scan, the carry scan and the entry states."""
    if ops.carry_w is not None:
        return group_true_states(inj, ops.toe, ops.carry_w)[0]
    s_in, e_states = _group_states(inj, ops.toe)
    sigma = dyn_block_carry(e_states, None, ops.A_blk)
    return _entry_states(s_in, sigma, ops.toe)


def dyn_frames_weights(ops: DynOperators) -> torch.Tensor:
    """(U, Vp) [fir_t | group_in | 0]: the frames EQ's first product, its
    columns padded to a multiple of 4, so that K9 reads y0 as a column
    slice with 16-byte aligned rows (``ops/eq.frames_weights``)."""
    U, d = ops.group_in.shape
    return F.pad(torch.cat([ops.fir_t, ops.group_in], dim=1),
                 (0, -(U + d) % 4))


def _dynamic_grouped(x_g: torch.Tensor, ops: DynOperators) -> torch.Tensor:
    """Grouped input (..., K, G, U) -> clipped output (..., K, G, U).

    As the static frames EQ: one product against ``dyn_frames_weights``,
    the states, then K9.
    """
    U, d = ops.group_in.shape
    cat = x_g @ dyn_frames_weights(ops)
    s_true = _dyn_states(cat[..., U:U + d], ops)
    return eq_finish(cat[..., :U], s_true, ops.group_out)


def _apply_dynamic_frames(frames: torch.Tensor, ops: DynOperators,
                          G: int) -> torch.Tensor:
    P, F_ = frames.shape[-1], frames.shape[-2]
    lead = frames.shape[:-2]
    if P != ops.group_in.shape[0]:
        raise ValueError(f"operators built for unroll "
                         f"{ops.group_in.shape[0]}, frames are {P} wide")
    K = -(-F_ // G)
    x = frames.to(torch.float32)
    if K * G != F_:
        x = F.pad(x, (0, 0, 0, K * G - F_))
    z = _dynamic_grouped(x.reshape(lead + (K, G, P)), ops)
    return z.reshape(lead + (K * G, P))[..., :F_, :]


def equalize_dynamic_frames_ops(frames: torch.Tensor, ops: DynOperators,
                                groups_per_block: int = 128,
                                fast: bool = False) -> torch.Tensor:
    """Frame-major EQ (..., F, P) -> clipped frames with prebuilt
    operators: the per-batch half of the serving split.  ``fast`` has no
    effect."""
    return _apply_dynamic_frames(frames, ops, groups_per_block)


def equalize_dynamic_frames(frames: torch.Tensor, gains_db, fs: int,
                            cfg: EQConfig = EQConfig(),
                            groups_per_block: int = 128,
                            fast: bool = False) -> torch.Tensor:
    """Frame-major EQ with gains as an input: the device builder on frames'
    device (unroll P, block G*P), then the apply.  ``fast`` has no
    effect."""
    G = groups_per_block
    K = -(-frames.shape[-2] // G)
    ops = build_dynamic_operators(gains_db, fs, cfg, frames.shape[-1], G, K,
                                  device=frames.device)
    return _apply_dynamic_frames(frames, ops, G)


def equalize_dynamic(x, gains_db, fs: int, cfg: EQConfig = EQConfig(),
                     block: int = 8192, unroll: int = 128,
                     fast: bool = False, device=None) -> torch.Tensor:
    """EQ of (..., N) signals with gains as an input (the device builder).

    The same result as the static ``equalize`` to float32 rounding, with
    the dynamic path's semantics: a gain with |g| <= 0.1 dB is an exact
    0 dB band and the output is always clipped.  ``x`` and ``device`` as
    in ``equalize``; ``fast`` has no effect.
    """
    if block % unroll:
        raise ValueError(f"block {block} is not a multiple of unroll {unroll}")
    x = as_input(x, device, "equalize_dynamic")
    G = block // unroll
    lead, n = x.shape[:-1], x.shape[-1]
    K = -(-n // block)
    ops = build_dynamic_operators(gains_db, fs, cfg, unroll, G, K,
                                  device=x.device)
    frames = F.pad(x, (0, K * block - n)).reshape(lead + (K * G, unroll))
    z = _apply_dynamic_frames(frames, ops, G)
    return z.reshape(lead + (K * block,))[..., :n]


# ---- the cat path ---------------------------------------------------------


def build_cat_tables_dyn(plan, ops: DynOperators) -> CatDynTables:
    """K1's operator for a gain change: G2 = G @ [fir_t | group_in], one
    float64 product on ops' device cast to float32, as the static path's
    host fold (``kernels/fir_class.cat_operator``) composes it."""
    w_cat = torch.cat([ops.fir_t, ops.group_in], dim=1).to(torch.float64)
    G = plan_operator(plan, w_cat.device, torch.float64)
    return CatDynTables(g2=(G @ w_cat).to(torch.float32))


def equalize_dynamic_cat_ops(y0_frames: torch.Tensor, inj: torch.Tensor,
                             ops: DynOperators,
                             fast: bool = False) -> torch.Tensor:
    """EQ finish on K1's emission with prebuilt operators: the group
    Toeplitz solve, the carry and K9.  ``y0_frames`` (..., F, U), ``inj``
    (..., F, d) unpacked, F a multiple of the operators' groups per block.
    Returns z frames (..., F, U), clipped; ``fast`` has no effect."""
    U, d = ops.group_in.shape
    G = ops.pows_g.shape[0]
    F_ = y0_frames.shape[-2]
    if y0_frames.shape[-1] != U:
        raise ValueError(f"y0 width {y0_frames.shape[-1]} != unroll {U}")
    if F_ % G:
        raise ValueError(f"frame count {F_} not a multiple of {G}")
    if tuple(inj.shape[-2:]) != (F_, d):
        raise ValueError(f"inj shape {tuple(inj.shape[-2:])} != {(F_, d)}")
    lead = y0_frames.shape[:-2]
    s_true = _dyn_states(inj.reshape(lead + (F_ // G, G, d)), ops)
    return eq_finish(y0_frames, s_true.reshape(lead + (F_, d)),
                     ops.group_out)
