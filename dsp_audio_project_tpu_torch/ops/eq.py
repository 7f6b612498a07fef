"""The EQ cascade as a block-parallel state-space recurrence (torch glue + K9).

The reference applies up to six peaking biquads through sequential
``scipy.signal.lfilter`` passes (dsp_core.py:216-254).  As in the JAX package
(``dsp_audio_project_tpu/ops/eq.py``) the active bands are composed on the
host into ONE order-d state-space system in Schur form, and the signal is
cut into blocks of G groups of U samples:

1. per group g:  y0 = x_g @ group_fir^T (zero-state output) and
   inj = x_g @ group_in (state injection): one product against the weight
   concat [group_fir^T | group_in], or folded into the cat FIR kernel
   (kernels/fir_class.py), which emits (y0, inj) per frame (U = P);
2. per block:    [s_1..s_G] = inj @ group_toeplitz (zero-init group states);
3. across blocks: sigma_{k+1} = A^block sigma_k + e_k (``_carry_states``);
4. readout:      z = clip(y0 + (s_in + A^{gU} sigma) @ group_out, -1, 1),
   one pass of K9 (kernels/eq_finish.py).

Steps 1-3 are the glue the JAX package leaves to XLA.  Step 1 is a plain
torch product, in float32 with TF32 off (utils/precision); steps 2-3 and
the entry states s_true = s_in + A^{gU} sigma of step 4 are the kernels of
kernels/group_states.py (float64 sums on the CUDA cores; the dense float32
products and the einsum on a CPU tensor): where the tables hold the carry
triangle (K <= _CARRY_ALLPAIRS_MAX) two launches, the blocks' ends and
then the carry and the states seeded with it; elsewhere the zero-entry
scan, the carry's log-depth scan in torch and the entry states.  Host tables
(float64 numpy) are copies of the JAX design code and are held bit-for-bit
equal by the tests.  Entry points: ``equalize`` (flat signals, block 8192 /
unroll 128 by default), ``equalize_frames`` (the frames path's (F, P)
frames at unroll P), ``equalize_frames_cat`` (the cat kernel's output),
``equalize_pallas`` (``iir_path='pallas'``: the same recurrence as two
kernel passes over the blocks, E2a and E2b, around the carry solve) and
``equalize_stream`` / ``final_state`` (a chunk and its carry state, for
the streams of streaming.py, which also use the split passes
``_grouped_parts`` / ``_grouped_finish``).
Every product is float32: the JAX package's ``fast`` bf16x3 option is
accepted and has no effect.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, Tuple

import numpy as np
import torch

from ..config import EQConfig
from ..kernels.eq_finish import eq_finish, eq_finish_plain
from ..kernels.group_states import (
    carry_plain, group_entry_states, group_states, group_true_states,
)
from ..kernels.experiments.iir import apply_rows, end_states_rows
from ..utils.device import as_input
from ..design.biquad import (
    BlockOperators,
    block_operators,
    cascade_state_space,
    peaking_coeffs,
    schur_form,
)


@functools.lru_cache(maxsize=None)
def make_block_operators(
    bands: Tuple[Tuple[float, float], ...], fs: int, q: float, block: int,
    unroll: int = 16,
) -> BlockOperators:
    """Compose active (fc, gain_db) bands at rate fs into block operators."""
    sections = [peaking_coeffs(fc, fs, gain, q) for fc, gain in bands]
    ss = schur_form(cascade_state_space(sections))
    return block_operators(ss, block, unroll)


def eq_cat_weights(ops: BlockOperators) -> np.ndarray:
    """(U, U+d) float64 weight concat [group_fir^T | group_in].

    cat = x_g @ w_cat yields [y0 | inj] per group; the cat FIR kernel folds
    it into its operator (G2 = G @ w_cat, float64 on the host).
    """
    return np.concatenate(
        [ops.group_fir.T.astype(np.float64),
         ops.group_in.astype(np.float64)], axis=1
    )


def frames_weights(group_fir: np.ndarray, group_in: np.ndarray) -> np.ndarray:
    """(U, Vp) float32 [group_fir^T | group_in | 0] for the frames EQ.

    x_g @ it yields [y0 | inj] per group in one product.  Vp = U + d is
    rounded up to a multiple of 4 with zero columns, so that y0, read as a
    column slice of the product, has 16-byte aligned rows for K9.
    """
    w = np.concatenate([np.asarray(group_fir, np.float64).T,
                        np.asarray(group_in, np.float64)], axis=1)
    pad = -w.shape[1] % 4
    return np.pad(w, ((0, 0), (0, pad))).astype(np.float32)


# Below this K the carry solve is ONE dense (K d, K d) matmul against a
# host-precomputed weight triangle; above it, a log-depth scan.
_CARRY_ALLPAIRS_MAX = 512
_carry_weight_cache: dict = {}


def _carry_weights(ops, K: int) -> np.ndarray:
    """(K d, K d) float32 map from [sigma0, e_0..e_{K-2}] to [sigma_0..sigma_{K-1}].

    WT[(j, jj), (k, dd)] = (A^block)^{k-j}[dd, jj] for j <= k, else 0 — the
    expanded block recurrence sigma_k = A^{bk} sigma0 + sum A^{b(k-1-i)} e_i.
    ``ops`` is anything with a float64 ``state_corr`` (A^block); cached on
    its bytes and K.
    """
    Ab = np.asarray(ops.state_corr, dtype=np.float64)
    key = (Ab.tobytes(), Ab.shape, K)
    w = _carry_weight_cache.get(key)
    if w is None:
        d = Ab.shape[0]
        pows = np.zeros((K, d, d))
        acc = np.eye(d)
        for p in range(K):
            pows[p] = acc
            acc = acc @ Ab
        WT = np.zeros((K, d, K, d))
        for k in range(K):
            for j in range(k + 1):
                WT[j, :, k, :] = pows[k - j].T
        w = np.asarray(WT.reshape(K * d, K * d), dtype=np.float32)
        _carry_weight_cache[key] = w
    return w


def _carry_scan(mats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Inclusive Hillis–Steele scan over (M, v) pairs along axis -3 / -2.

    Combine (M2, v2) o (M1, v1) = (M2 M1, M2 v1 + v2), element k after
    element k-1.  log2(K) rounds, each one batched product over all K.
    Returns the scanned v (..., K, d).
    """
    K = vecs.shape[-2]
    step = 1
    while step < K:
        m_prev = mats[..., : K - step, :, :]
        v_prev = vecs[..., : K - step, :]
        m_cur = mats[..., step:, :, :]
        v_cur = vecs[..., step:, :]
        new_v = (m_cur @ v_prev.unsqueeze(-1)).squeeze(-1) + v_cur
        new_m = m_cur @ m_prev
        vecs = torch.cat([vecs[..., :step, :], new_v], dim=-2)
        mats = torch.cat([mats[..., :step, :, :], new_m], dim=-3)
        step *= 2
    return vecs


def _carry_states(
    end_states: torch.Tensor,
    state_corr: torch.Tensor,
    carry_w: torch.Tensor | None = None,
    sigma0: torch.Tensor | None = None,
) -> torch.Tensor:
    """True initial state per block: sigma_{k+1} = A^block sigma_k + e_k.

    ``end_states`` (..., K, d); ``state_corr`` (d, d) float32 A^block.
    sigma_0 = sigma0 (zero by default).  With ``carry_w`` (the (K d, K d)
    carry triangle, as ``_carry_weights`` builds it for K <=
    _CARRY_ALLPAIRS_MAX) the triangular solve is one matmul against it;
    without, the log-depth scan over [(I, sigma0), (A^block, e_0), ...,
    (A^block, e_{K-2})], whose position k is sigma_k.
    """
    if carry_w is not None:
        return carry_plain(end_states, carry_w, sigma0)
    d = end_states.shape[-1]
    K = end_states.shape[-2]
    lead = end_states.shape[:-2]
    if sigma0 is None:
        sigma0 = end_states.new_zeros(lead + (d,))
    vecs = torch.cat([sigma0.unsqueeze(-2), end_states[..., : K - 1, :]],
                     dim=-2)
    eye = torch.eye(d, dtype=state_corr.dtype, device=state_corr.device)
    mats = torch.cat([
        eye.expand(lead + (1, d, d)),
        state_corr.expand(lead + (K - 1, d, d)),
    ], dim=-3)
    return _carry_scan(mats, vecs)


EQ_TABLES = ("group_out", "group_pows", "group_toeplitz", "state_corr")
FINISHES = ("auto", "torch", "kernel")


_device_tables: dict = {}


def block_tables(ops: BlockOperators, device, K: int) -> dict:
    """Every float32 device table of ``ops`` for K blocks: ``EQ_TABLES``,
    ``w_frames`` (``frames_weights``) and, for K <= _CARRY_ALLPAIRS_MAX,
    ``carry_w``.  Cached per (ops, device[, K]); BlockOperators instances
    are ``make_block_operators`` singletons, so id() is a stable key."""
    key = (id(ops), str(torch.device(device)))
    out = _device_tables.get(key)
    if out is None:
        out = {name: torch.as_tensor(np.asarray(getattr(ops, name),
                                                dtype=np.float32),
                                     device=device)
               for name in EQ_TABLES}
        out["w_frames"] = torch.as_tensor(
            frames_weights(ops.group_fir, ops.group_in), device=device)
        _device_tables[key] = out
    return {**out, **carry_tables(ops, device, K)}


def carry_tables(ops: BlockOperators, device, K: int) -> dict:
    """The carry solve's float32 device tables for K blocks: ``state_corr``
    (A^block) and, for K <= _CARRY_ALLPAIRS_MAX, ``carry_w``; cached per
    (ops, device[, K])."""
    key = ("carry", id(ops), str(torch.device(device)))
    out = _device_tables.get(key)
    if out is None:
        out = {"state_corr": torch.as_tensor(
            np.asarray(ops.state_corr, dtype=np.float32), device=device)}
        _device_tables[key] = out
    out = dict(out)
    if K <= _CARRY_ALLPAIRS_MAX:
        cw = _device_tables.get(key + (K,))
        if cw is None:
            cw = torch.as_tensor(_carry_weights(ops, K), device=device)
            _device_tables[key + (K,)] = cw
        out["carry_w"] = cw
    return out


def _group_states(inj: torch.Tensor, toe: torch.Tensor):
    """Step 2 on (..., K, G, d) injections: (s_in (..., K, G, d), the
    zero-init state entering each group, and end_states (..., K, d)); the
    block-Toeplitz scan of ``kernels/group_states.py`` on a CUDA tensor."""
    return group_states(inj, toe)


def _true_states(inj: torch.Tensor, tables: Mapping[str, torch.Tensor],
                 sigma0: torch.Tensor | None = None):
    """Steps 2-3 and the state half of step 4 on (..., K, G, d) injections.

    Returns (s_true (..., K, G, d) contiguous: the true state entering each
    group, end_states (..., K, d), sigma (..., K, d)).  ``sigma0``: the
    incoming state of block 0 (zero by default).  Where the tables hold the
    carry triangle, ``group_true_states``: on the card the ends kernel and
    the solve kernel, which takes its carry from the triangle's first
    block row and writes s_true once; else the zero-entry scan, the carry
    scan and the entry states.
    """
    toe = tables["group_toeplitz"]
    carry_w = tables.get("carry_w")
    if carry_w is not None:
        return group_true_states(inj, toe, carry_w, sigma0)
    s_in, end_states = _group_states(inj, toe)
    sigma = _carry_states(end_states, tables["state_corr"], None, sigma0)
    return _entry_states(s_in, sigma, toe), end_states, sigma


def _entry_states(s_in: torch.Tensor, sigma: torch.Tensor,
                  toe: torch.Tensor) -> torch.Tensor:
    """s_true = s_in + A^{gU} sigma: the true state entering each group,
    (..., K, G, d) contiguous, from the zero-init group states and the true
    block-initial states sigma (..., K, d); the powers are the group
    Toeplitz table's taps (the kernel's entry mode on a CUDA tensor)."""
    return group_entry_states(s_in, sigma, toe)


def _frames_product(x_g: torch.Tensor, tables: Mapping[str, torch.Tensor]):
    """Step 1 on (..., K, G, U): (y0, inj), column slices of one product
    against ``w_frames``, which K9 and the state kernels read in place."""
    U = x_g.shape[-1]
    d = tables["state_corr"].shape[0]
    cat = x_g @ tables["w_frames"]                      # (..., K, G, Vp)
    return cat[..., :U], cat[..., U:U + d]


def _grouped_parts(x_g: torch.Tensor, tables: Mapping[str, torch.Tensor]):
    """Steps 1-2 on (..., K, G, U): (y0, s_in, end_states), the state pass
    split before the carry solve, for callers that inject the carry between
    the passes (the streams)."""
    y0, inj = _frames_product(x_g, tables)
    s_in, end_states = _group_states(inj, tables["group_toeplitz"])
    return y0, s_in, end_states


def _grouped_finish(y0: torch.Tensor, s_in: torch.Tensor,
                    sigma: torch.Tensor,
                    tables: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Output pass of ``_grouped_parts`` once the true sigma is known: the
    readout and the clip as one K9 pass.  Clipping is memoryless, so a
    stream that clips each step equals the JAX package's clip after its
    finish."""
    return eq_finish(y0, _entry_states(s_in, sigma, tables["group_toeplitz"]),
                     tables["group_out"])


def _grouped_run(
    x_g: torch.Tensor,
    tables: Mapping[str, torch.Tensor],
    sigma0: torch.Tensor | None = None,
):
    """One full grouped EQ pass on (..., K, G, U): (z, s_true, end_states,
    sigma).

    The JAX package's ``_grouped_run`` followed by its callers' clip: z is
    clipped, because the readout and the clip are one K9 pass
    (``eq_finish``).  ``sigma0``: the incoming state of block 0.
    """
    y0, inj = _frames_product(x_g, tables)
    s_true, end_states, sigma = _true_states(inj, tables, sigma0)
    return (eq_finish(y0, s_true, tables["group_out"]), s_true, end_states,
            sigma)


def equalize(x, fs: int, cfg: EQConfig, block: int = 8192,
             unroll: int = 128, fast: bool = False, device=None):
    """Apply the EQ cascade to (..., N) float32 signals.

    A tensor stays on its device; an array goes to the card (raising
    without one) unless ``device`` says otherwise (``device="cpu"``).
    Whole-EQ bypass returns the input tensor untouched and unclipped
    (dsp_core.py:222-223); an active request whose bands all clamp away
    still clips.  ``fast`` is accepted and has no effect (float32
    throughout).
    """
    x = as_input(x, device, "equalize")
    if cfg.bypass:
        return x
    bands = cfg.active_bands(fs)
    if not bands:
        return torch.clamp(x, -1.0, 1.0)
    ops = make_block_operators(bands, int(fs), cfg.q, block, unroll)
    K = -(-x.shape[-1] // block)
    return _equalize_blocks(x, block_tables(ops, x.device, K), block)


def equalize_pallas(x, fs: int, cfg: EQConfig, block: int = 1024,
                    unroll: int = 16, device=None):
    """``equalize`` through the block-IIR kernels E2a and E2b
    (kernels/experiments/iir.py, ``csrc/iir_block.cu``): the route of
    ``KernelConfig(iir_path='pallas')``, named as in the JAX package.

    E2a (the zero-init end state of each block, zeros read past n),
    ``_carry_states`` (the true initial states), E2b (each block re-run
    from its true state, clipped and cropped to n as it is written): x is
    read twice and y written once, with no correction product and no pad
    or clip pass.  Bypass and the no-active-band clip as in ``equalize``;
    ``unroll`` only shapes the design tables (the kernels group at their
    own length).  On a CPU tensor the kernels' plain versions run.
    """
    x = as_input(x, device, "equalize_pallas")
    if cfg.bypass:
        return x
    bands = cfg.active_bands(fs)
    if not bands:
        return torch.clamp(x, -1.0, 1.0)
    ops = make_block_operators(bands, int(fs), cfg.q, block, unroll)
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    K = -(-n // block)
    tables = carry_tables(ops, x.device, K)
    sigma = _carry_states(end_states_rows(x2, block, ops),
                          tables["state_corr"], tables.get("carry_w"))
    return apply_rows(x2, sigma.contiguous(), block, ops).reshape(
        lead + (n,))


def equalize_frames(
    frames: torch.Tensor,
    fs: int,
    cfg: EQConfig,
    groups_per_block: int = 128,
    fast: bool = False,
    tables: Mapping[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """EQ on frame-major input (..., F, P) -> frame-major output, clipped.

    The frames path's handoff: unroll = P and block = G*P, so every reshape
    between the SRC frames and the EQ is a free leading-axis regroup.  The
    same result as ``equalize`` on the flattened signal at that block and
    unroll (zero-padded tail blocks sliced off).  ``tables``: the device
    tables (``block_tables`` names), built from the config when omitted.
    """
    if cfg.bypass:
        return frames
    bands = cfg.active_bands(fs)
    if not bands:
        return torch.clamp(frames, -1.0, 1.0)
    P = frames.shape[-1]
    F_ = frames.shape[-2]
    G = groups_per_block
    lead = frames.shape[:-2]
    K = -(-F_ // G)
    if tables is None:
        ops = make_block_operators(bands, int(fs), cfg.q, G * P, P)
        tables = block_tables(ops, frames.device, K)
    x = frames.to(torch.float32)
    if K * G != F_:
        x = torch.nn.functional.pad(x, (0, 0, 0, K * G - F_))
    z = _grouped_run(x.reshape(lead + (K, G, P)), tables)[0]
    return z.reshape(lead + (K * G, P))[..., :F_, :]


def _equalize_blocks(
    x: torch.Tensor,
    tables: Mapping[str, torch.Tensor],
    block: int,
    sigma0: torch.Tensor | None = None,
    with_state: bool = False,
):
    """Block-parallel recurrence over (..., N) -> clipped (..., N).

    ``sigma0``: optional incoming state (..., d).  ``with_state``: also
    return the state after sample N, s_end = A^block sigma_last + e_last;
    it requires N to be a multiple of ``block`` (zero-pad blocks would
    corrupt the carry; ``equalize_stream`` takes ragged lengths).  The
    output is clipped: the readout and the clip are one K9 pass.
    """
    n = x.shape[-1]
    U = tables["w_frames"].shape[0]
    K = -(-n // block)
    if with_state and K * block != n:
        raise ValueError(
            f"state carry requires length {n} to be a multiple of block "
            f"{block}")
    if K * block != n:
        x = torch.nn.functional.pad(x, (0, K * block - n))
    x_g = x.reshape(x.shape[:-1] + (K, block // U, U))
    z, _, end_states, sigma = _grouped_run(x_g, tables, sigma0)
    z = z.reshape(x.shape[:-1] + (K * block,))[..., :n]
    if not with_state:
        return z
    return z, (sigma[..., -1, :] @ tables["state_corr"].T
               + end_states[..., -1, :])


def stream_tables(ops: BlockOperators, device) -> dict:
    """The ragged tail's float32 device tables: ``group_in`` (U, d) and
    ``pows_u`` (U, d, d), A^m for m < U built in float64; cached per (ops,
    device)."""
    key = ("stream", id(ops), str(torch.device(device)))
    out = _device_tables.get(key)
    if out is None:
        A = np.asarray(ops.A, dtype=np.float64)
        pows = [np.eye(A.shape[0])]
        for _ in range(ops.unroll - 1):
            pows.append(pows[-1] @ A)
        out = {"group_in": torch.as_tensor(
                   np.asarray(ops.group_in, np.float32), device=device),
               "pows_u": torch.as_tensor(
                   np.asarray(pows, np.float32), device=device)}
        _device_tables[key] = out
    return out


def equalize_stream(x, fs: int, cfg: EQConfig, state=None,
                    block: int = 1024, device=None):
    """Streaming EQ: process a chunk, return (z, carry_state).

    Feeding chunks of any sizes through this function gives the samples of
    one ``equalize`` call on their concatenation: the carry is the
    cascade's whole internal state (d values, two a band), in the Schur
    basis of the config, the basis the JAX package's ``equalize_stream``
    uses, so a state from either package continues in the other; treat it
    as opaque.  ``x`` (..., n) and ``device`` as in ``equalize``;
    ``state`` (..., d) or None (zero).  Each chunk's output is clipped as
    the one-shot path clips once (memoryless, so they agree).  Bypass
    returns x unclipped and an empty (..., 0) state; no active band clips
    and returns an empty state.

    One grouped pass over ceil(n / block) blocks from ``state`` (group
    length gcd(block, 128); the JAX package's 16 only shapes its own
    tables).  A ragged chunk is zero-padded to whole blocks, which leaves
    its outputs exact (the recurrence is causal); the JAX package runs the
    ragged tail as a per-sample scan, which on a card would be one tiny
    launch per sample.  The state after sample r = gU + m of the last
    block comes from the group algebra instead: A^m s_true[g] + the last
    m samples @ the last m rows of group_in.
    """
    x = as_input(x, device, "equalize_stream")
    lead, n = x.shape[:-1], x.shape[-1]
    if cfg.bypass:
        return x, x.new_zeros(lead + (0,))
    bands = cfg.active_bands(fs)
    if not bands:
        return torch.clamp(x, -1.0, 1.0), x.new_zeros(lead + (0,))
    U = math.gcd(block, 128)
    ops = make_block_operators(bands, int(fs), cfg.q, block, U)
    d = ops.A.shape[0]
    state = (x.new_zeros(lead + (d,)) if state is None
             else torch.as_tensor(state, dtype=torch.float32,
                                  device=x.device))
    if n == 0:
        return x, state
    K = -(-n // block)
    tables = block_tables(ops, x.device, K)
    r = n - (K - 1) * block                   # samples in the last block
    if r == block:
        return _equalize_blocks(x, tables, block, state, with_state=True)
    x_g = torch.nn.functional.pad(x, (0, K * block - n)).reshape(
        lead + (K, block // U, U))
    z, s_true, _, _ = _grouped_run(x_g, tables, state)
    z = z.reshape(lead + (K * block,))[..., :n]
    g, m = divmod(r, U)
    s_end = s_true[..., K - 1, g, :]
    if m:
        tail = stream_tables(ops, x.device)
        s_end = (s_end @ tail["pows_u"][m].T
                 + x[..., n - m:] @ tail["group_in"][U - m:])
    return z, s_end


def final_state(x, fs: int, cfg: EQConfig, block: int = 1024, device=None):
    """End state of the cascade after consuming ``x`` (see
    ``equalize_stream``)."""
    return equalize_stream(x, fs, cfg, None, block, device)[1]


def equalize_frames_cat(
    y0_frames: torch.Tensor,
    inj: torch.Tensor,
    fs: int,
    cfg: EQConfig,
    unroll: int,
    groups_per_block: int = 128,
    rows: Tuple[int, int] | None = None,
    tables: Mapping[str, torch.Tensor] | None = None,
    finish: str = "auto",
):
    """EQ finish on the cat FIR kernel's emission.

    ``y0_frames`` (..., F, U): frames @ group_fir^T; ``inj`` (..., F, d):
    the per-frame state injections, unpacked.  F must be a multiple of
    ``groups_per_block``.  Returns z frames (..., F, U), clipped; with
    ``rows=(r0, r1)`` also the rows [r0, r1) of z (the spectra consumer's
    side tensor).  ``tables``: the device tables (``block_tables``),
    built from the config when omitted.  ``finish``: 'auto' or 'kernel' runs the readout and clip as
    one K9 pass (``eq_finish``: the kernel on a CUDA tensor, its plain
    version on a CPU one); 'torch' runs them as torch products (the JAX
    package's 'xla' finish).  Every product here is float32 (the JAX
    package's ``fast`` bf16x3 option has no counterpart).
    """
    if finish not in FINISHES:
        raise ValueError(f"unknown finish {finish!r}; expected one of "
                         f"{FINISHES}")
    bands = cfg.active_bands(fs)
    if cfg.bypass or not bands:
        raise ValueError("cat path requires an active EQ "
                         "(fold happens against its operators)")
    U = unroll
    G = groups_per_block
    F_ = y0_frames.shape[-2]
    if F_ % G:
        raise ValueError(f"frame count {F_} not a multiple of {G}")
    K = F_ // G
    d = 2 * len(bands)
    if y0_frames.shape[-1] != U:
        raise ValueError(f"y0 width {y0_frames.shape[-1]} != unroll {U}")
    if tuple(inj.shape[-2:]) != (F_, d):
        raise ValueError(f"inj shape {tuple(inj.shape[-2:])} != {(F_, d)}")
    if tables is None:
        ops = make_block_operators(bands, int(fs), cfg.q, G * U, U)
        tables = block_tables(ops, y0_frames.device, K)
    lead = y0_frames.shape[:-2]
    s_true, _, _ = _true_states(inj.reshape(lead + (K, G, d)), tables)
    s_true = s_true.reshape(lead + (F_, d))
    readout = eq_finish_plain if finish == "torch" else eq_finish
    z = readout(y0_frames, s_true, tables["group_out"])
    if rows is None:
        return z
    # The JAX package recomputes these rows from slices so that XLA never
    # slices its fused output; eager torch has z materialized, and a row
    # slice is a view.
    r0, r1 = rows
    return z, z[..., r0:r1, :]
