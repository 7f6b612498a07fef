"""The group algebra of the block-IIR kernels (E2a, E2b, E7): tables, launcher and torch mirror.

One CUDA body (``csrc/iir_block.cu``) serves three rows of the TPU kernel
table in three modes: END (E2a, ``iir.block_end_states``), APPLY (E2b,
``iir.block_apply``) and SEQ (E7, ``iir_seq.equalize_seq_flat``).  A block
of B samples is cut into G = ceil(B / U) groups of U = ``GROUP`` samples,
the last one ragged with r = B - (G-1) U samples; per group

    inj[g]  = sum_v A^{U-1-v} B x_v        (a ragged group: the table's
                                            last r rows)
    s[g+1]  = A^U s[g] + inj[g]             (A^r for the ragged group)
    y[g, u] = sum_{k<=u} h[k] x_{u-k} + C A^u s[g],   h = [D, C A^{k-1} B]

and SEQ carries the block state along each row by a fixed-window look-back,

    sigma_k = sum_{j=1..W} A_blk^{j-1} agg_k-j + A_blk^W sigma_{k-W},

agg the block's zero-entry end state.  The tables are built here in float64
from the float32-quantized system (``ops.A/B/C/D``) at the kernel's group
length, whatever ``ops.unroll`` is, and cast once.  The torch mirror below
repeats the kernel's arithmetic (the same tables, the Horner pass, the
ragged group, the look-back) so the CPU tests can hold it against the JAX
kernels and the plain versions; the wrappers never run it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ...design.biquad import StateSpace, block_operators
from ...utils.device import device_tables

GROUP = 128         # U: the kernel's group length (``iir_group_length()``)
CHUNK = 32          # groups a chunk in E2a and E2b (E7: the whole block)
WINDOW = 31         # W: E7's look-back window (lanes 1..W of one warp)
PAY = 16            # 64-bit words a published vector in E7's scratch
_LAUNCHERS = {
    "iir_group_length": [],
    "iir_seq_max_block": [ctypes.c_int] * 2,
    "iir_end_states_launch": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "iir_apply_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "iir_seq_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
}


def groups(block: int, U: int = GROUP) -> tuple[int, int]:
    """(G, r): the group count of a block and the last group's length."""
    G = -(-block // U)
    return G, block - (G - 1) * U


@functools.lru_cache(maxsize=None)
def group_tables(ops, block: int, U: int = GROUP, window: int = 1) -> dict:
    """The kernel's float32 tables for blocks of ``block`` samples.

    ``h`` (U,), ``gin`` (U, d), ``gout`` (d, U), ``au`` = A^U and ``ar`` =
    A^r (d, d), ``pw`` (W+1, d, d) = A_blk^j for j = 0..W (E7's look-back,
    ``window`` W) and ``pows`` (G, d, d) = A^{gU} (the segments' and the
    carry's propagation).  Every table is computed in float64 from the
    float32 system and cast once.
    """
    A = np.asarray(ops.A, np.float64)
    ss = StateSpace(A=A, B=np.asarray(ops.B, np.float64),
                    C=np.asarray(ops.C, np.float64), D=float(ops.D))
    grp = block_operators(ss, U, U)
    G, r = groups(block, U)
    f32 = np.float32
    out = {"h": grp.group_fir[:, 0].astype(f32),
           "gin": grp.group_in.astype(f32),
           "gout": grp.group_out.astype(f32),
           "au": grp.state_corr.astype(f32),
           "ar": np.linalg.matrix_power(A, r).astype(f32)}
    ablk = np.linalg.matrix_power(A, block)
    out["pw"] = np.stack([np.linalg.matrix_power(ablk, j)
                          for j in range(window + 1)]).astype(f32)
    pows = [np.eye(A.shape[0])]
    for _ in range(G - 1):
        pows.append(pows[-1] @ grp.state_corr)
    out["pows"] = np.stack(pows).astype(f32)
    return out


def flat_table(tab: dict) -> np.ndarray:
    """The kernel's one table: h | gin (rows padded to a multiple of 4) |
    gout | A^U | A^r | A_blk^0..W | A^{gU} (csrc/iir_block.cu TabLayout)."""
    gin = tab["gin"]
    gin = np.pad(gin, ((0, 0), (0, -gin.shape[1] % 4)))
    parts = [tab["h"], gin, tab["gout"], tab["au"], tab["ar"], tab["pw"],
             tab["pows"]]
    return np.concatenate([np.ravel(p) for p in parts]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flat(ops, block: int, window: int) -> np.ndarray:
    return flat_table(group_tables(ops, block, GROUP, window))


def library():
    """The built kernel library; raises if its group length is not GROUP."""
    lib = _build.load("iir_block", _LAUNCHERS)
    if lib.iir_group_length() != GROUP:
        raise RuntimeError(f"csrc/iir_block.cu groups {lib.iir_group_length()} "
                           f"samples, the tables {GROUP}")
    return lib


def launch(name: str, *args) -> None:
    """Launch ``name`` (tensors as pointers, ints as they are) on the
    current stream of the first tensor's device; raise on a launch error."""
    lib = library()
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    with torch.cuda.device(dev):
        err = getattr(lib, name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, name)


def device_table(ops, block: int, device, window: int = 1) -> torch.Tensor:
    """``flat_table`` of the kernel's tables as a cached device tensor."""
    return device_tables(_flat, ops, block, window, device=device)


# ---- the torch mirror of the kernel's arithmetic (CPU tests) ------------

def _grouped(xb: torch.Tensor, U: int) -> torch.Tensor:
    """(..., B) -> (..., G, U), zeros past B."""
    G = -(-xb.shape[-1] // U)
    pad = G * U - xb.shape[-1]
    return torch.nn.functional.pad(xb, (0, pad)).reshape(
        xb.shape[:-1] + (G, U))


def _t(tab: dict, name: str, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(tab[name], device=like.device)


def mirror_inj(xg: torch.Tensor, tab: dict, r: int) -> torch.Tensor:
    """inj (..., G, d): each group @ gin, the ragged group's r samples
    against the table's last r rows."""
    gin = _t(tab, "gin", xg)
    inj = xg @ gin
    U = xg.shape[-1]
    if r < U:
        inj[..., -1, :] = xg[..., -1, :r] @ gin[U - r:]
    return inj


def segments(d: int) -> int:
    """The serial warp's lane groups: 32 // d Horner segments a chunk."""
    return 32 // d


def mirror_horner(inj: torch.Tensor, s0: torch.Tensor, tab: dict,
                  chunk: int | None = None, segs: int | None = None):
    """The kernel's Horner pass over the groups from s0 (..., d): (true
    entry states (..., G, d), the end state (..., d)).

    Per chunk of ``chunk`` groups (the whole block by default), segments
    of L = ceil(groups / min(``segs``, groups)) groups (the last shorter)
    run Horner from a zero state each (the last step through A^r); their entry states T_j
    follow by T_0 = the chunk's entry state, T_j = A^{LU} T_{j-1} + e_{j-1}
    (e the segments' zero-entry end states); a group's entry state is its
    local one plus A^{(g - jL)U} T_j; the chunk's end is one step from its
    last group's.  ``segs`` = 1 is plain Horner.
    """
    au, ar = _t(tab, "au", inj), _t(tab, "ar", inj)
    pows = _t(tab, "pows", inj)
    G, d = inj.shape[-2:]
    chunk = chunk or G
    segs = segs or segments(d)
    s, out = s0, []
    for c0 in range(0, G, chunk):
        cg = min(chunk, G - c0)
        L = -(-cg // min(segs, cg))
        S = -(-cg // L)                   # none empty, the last shorter
        local, ends = [], []
        for j in range(S):
            e = torch.zeros_like(s0)
            for g in range(j * L, min(cg, (j + 1) * L)):
                local.append(e)
                e = e @ (ar if c0 + g == G - 1 else au).T + inj[..., c0 + g, :]
            ends.append(e)
        T = [s]
        for j in range(1, S):
            T.append(T[-1] @ pows[L].T + ends[j - 1])
        st = torch.stack([local[g] + T[g // L] @ pows[g - g // L * L].T
                          for g in range(cg)], dim=-2)
        last = ar if c0 + cg == G else au
        s = st[..., -1, :] @ last.T + inj[..., c0 + cg - 1, :]
        out.append(st)
    return torch.cat(out, dim=-2), s


def mirror_fir(xg: torch.Tensor, tab: dict) -> torch.Tensor:
    """y0 (..., G, U): the triangular Toeplitz product, y0[u] = sum_{k<=u}
    h[k] x[u-k]."""
    h = _t(tab, "h", xg)
    U = xg.shape[-1]
    idx = torch.arange(U, device=h.device)
    lag = idx[:, None] - idx[None, :]                 # [u, v] = u - v
    toe = torch.where(lag >= 0, h[lag.clamp(min=0)], h.new_zeros(()))
    return xg @ toe.T


def mirror_end_states(xb: torch.Tensor, tab: dict) -> torch.Tensor:
    """E2a: (..., B) blocks -> the zero-state end state (..., d)."""
    U = tab["h"].shape[0]
    xg = _grouped(xb, U)
    _, r = groups(xb.shape[-1], U)
    d = tab["au"].shape[0]
    _, end = mirror_horner(mirror_inj(xg, tab, r),
                           xb.new_zeros(xb.shape[:-1] + (d,)), tab, CHUNK)
    return end


def mirror_apply(xb: torch.Tensor, sigma: torch.Tensor,
                 tab: dict) -> torch.Tensor:
    """E2b: (..., B) blocks from their entry states (..., d) -> y (..., B),
    unclipped; the ragged group's product and readout cut to r samples."""
    U = tab["h"].shape[0]
    xg = _grouped(xb, U)
    _, r = groups(xb.shape[-1], U)
    st, _ = mirror_horner(mirror_inj(xg, tab, r), sigma, tab, CHUNK)
    y = mirror_fir(xg, tab) + st @ _t(tab, "gout", xg)
    return y.reshape(xb.shape[:-1] + (-1,))[..., : xb.shape[-1]]


def lookback(aggs: torch.Tensor, pw: torch.Tensor, window: int) -> torch.Tensor:
    """Entry states (rows, K, d) from the aggregates (rows, K, d) by the
    fixed window: sigma_k = sum_{j=1..W} pw[j-1] agg_{k-j} + pw[W]
    sigma_{k-W}, terms before the row's start dropped (sigma_0 = 0)."""
    K = aggs.shape[-2]
    sig = []
    for k in range(K):
        s = torch.zeros_like(aggs[..., 0, :])
        for j in range(1, window + 1):
            if k - j >= 0:
                s = s + aggs[..., k - j, :] @ pw[j - 1].T
        if k - window >= 0:
            s = s + sig[k - window] @ pw[window].T
        sig.append(s)
    return torch.stack(sig, dim=-2)


def mirror_seq(x3: torch.Tensor, tab: dict, window: int) -> torch.Tensor:
    """E7: (rows, K, B) -> clipped y, the state carried along each row by
    the look-back: the zero-entry group states, each block's aggregate,
    the window's sigma, s_true = entry + A^{gU} sigma, the readout."""
    U = tab["h"].shape[0]
    xg = _grouped(x3, U)
    _, r = groups(x3.shape[-1], U)
    d = tab["au"].shape[0]
    st, agg = mirror_horner(mirror_inj(xg, tab, r),
                            x3.new_zeros(x3.shape[:-1] + (d,)), tab)
    sigma = lookback(agg, _t(tab, "pw", x3), window)
    st = st + torch.einsum("gef,rkf->rkge", _t(tab, "pows", x3), sigma)
    y = mirror_fir(xg, tab) + st @ _t(tab, "gout", xg)
    y = y.reshape(x3.shape[:-1] + (-1,))[..., : x3.shape[-1]]
    return torch.clamp(y, -1.0, 1.0)
