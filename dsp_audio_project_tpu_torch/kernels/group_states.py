"""The EQ's group-state solve: CUDA kernels, wrappers, plain versions and
torch mirrors of the kernels' arithmetic.

Step 2 of the grouped EQ (ops/eq.py) turns each block row's per-group
injections inj (K, G, d) into the state after every group,

    s_g = sigma_k T_{g+1} + sum_{j <= g} inj_j T_{g-j},    T_m = (A^{mU})^T,

a product against the block-lower-triangular Toeplitz table
``group_toeplitz`` (G d, G d), whose block (j, g) is T_{g-j} for j <= g and
0 above, plus the block's entering state sigma_k.  Step 3, the carry,
gives sigma_k from the zero-entry ends e_i = s_{G-1}(sigma = 0) of the
earlier blocks: sigma_k = sigma0 C_k + sum_{i<k} e_i C_{k-1-i}, C_m =
(A^{block m})^T, a product against the carry triangle ``carry_w`` (K d, K
d) where the tables hold one (ops/eq._carry_weights, the dynamic builder).

Two routes on the card, from one source (``csrc/group_states.cu``):

* where ``carry_w`` exists, two launches: ``group_ends`` (e_k for every
  block row) and ``group_solve`` (sigma_k from the ends and ``carry_w``'s
  first block row, then the states seeded with it: s_true, the state
  entering each group, written once); ``group_true_states`` runs both;
* elsewhere (the streams' and shards' split passes, long uploads),
  ``group_states`` (the same scan with a zero seed: s_in, shifted by one
  group, and the ends), a carry of the caller's own, then
  ``group_entry_states`` (s_true = s_in + sigma T_g).

Replaces no TPU kernel: the JAX package leaves all three to XLA as a dense
product, a matmul against the carry triangle and an einsum
(``dsp_audio_project_tpu/ops/eq.py:106 _grouped_states``, ``:568
_carry_states``, ``:186``).  The plain versions here are those torch ops on
cuBLAS (``group_states_plain``: one (B K, G d) @ (G d, G d) product, 3.78
GFLOP in fp32 at the serving shape, half of it zeros; ``carry_plain``;
``group_entry_states_plain``; ``group_solve_plain`` all three); the
wrappers run them on a CPU tensor, and ``chip_smoke.py`` and the card tests
hold the kernels against them.  The kernels read only the tables' first
block rows (``toeplitz_taps``): a warp a block row, each lane a chunk of
c = ``CHUNK`` groups of a 128-group tile (its triangle of taps in
registers), a scan over the lanes by shuffles in five steps (S_l +=
S_{l-2^k} T_{c 2^k}), then each group adds the state entering its chunk
times T_{i+1}; float32 in and out, summed in float64.  Float32 sums ran
1.6x faster but fell ~9 dB below the float64 product, and below the dense
float32 product, where the poles lie close to 1 within a group
(``scripts/state_variants.py``).  The mirrors repeat each kernel's
arithmetic in torch for the CPU tests; the wrappers never run them.  The
tables must be block Toeplitz: every table of the port is
(``design/biquad.block_operators``, ``ops/eq._carry_weights``,
``eq_design``'s ``_lower_triangle``), as tests/test_torch_group_states.py
checks.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILE = 128                 # group positions a tile (lanes x CHUNK)
CHUNK = 4                  # c: groups a lane's chunk of the kernels' scan
CHUNKS = TILE // CHUNK     # chunks a tile (lanes a warp): the scan runs over them
DIMS = tuple(range(2, 17, 2))  # d: the kernels' instantiations

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LAUNCHERS = {
    "group_ends_launch": [_P] * 4 + [_I] * 4 + [_L] * 4 + [_P],
    "group_solve_launch": [_P] * 8 + [_I] * 4 + [_L] * 5 + [_P],
    "group_states_launch": [_P] * 4 + [_I] * 4 + [_L] * 4 + [_P],
    "group_entry_launch": [_P] * 4 + [_I] * 3 + [_L] + [_P],
    "group_states_occupancy": [_I] * 3 + [_P],
}
WARPS = 4                  # block rows a CUDA block of the ends and solve kernels


def toeplitz_taps(toe: torch.Tensor, d: int) -> torch.Tensor:
    """(G, d, d) view of the taps T_m[f, e] = toe[f, m d + e]: the table's
    first block row, all a block-Toeplitz table holds (``carry_w``'s too:
    its first block row holds the carry's powers C_m)."""
    G = toe.shape[-1] // d
    return toe[:d].reshape(d, G, d).permute(1, 0, 2)


def _dense_states(inj: torch.Tensor, toe: torch.Tensor) -> torch.Tensor:
    """The zero-entry state after every group, (..., K, G, d): one dense
    product of the (..., K, G d) injections against the (G d, G d) table."""
    K, G, d = inj.shape[-3:]
    lead = inj.shape[:-3]
    return (inj.reshape(lead + (K, G * d)) @ toe).reshape(lead + (K, G, d))


def group_states_plain(inj: torch.Tensor, toe: torch.Tensor):
    """Plain version: (s_in, end_states) from the dense product."""
    K, G, d = inj.shape[-3:]
    lead = inj.shape[:-3]
    s_tail = _dense_states(inj, toe)
    s_in = torch.cat(
        [s_tail.new_zeros(lead + (K, 1, d)), s_tail[..., : G - 1, :]], dim=-2
    )
    return s_in, s_tail[..., G - 1, :]


def group_entry_states_plain(s_in: torch.Tensor, sigma: torch.Tensor,
                             toe: torch.Tensor) -> torch.Tensor:
    """Plain version: s_in + A^{gU} sigma, the einsum against the powers
    (``group_pows[g][e][f]``, read here from the table's taps)."""
    d = s_in.shape[-1]
    pows = toeplitz_taps(toe, d).transpose(-1, -2)            # (G, e, f)
    return s_in + torch.einsum("gef,...kf->...kge", pows, sigma)


def carry_plain(end_states: torch.Tensor, carry_w: torch.Tensor,
                sigma0: torch.Tensor | None = None) -> torch.Tensor:
    """The carry against the (K d, K d) triangle: sigma (..., K, d) from the
    zero-entry ends (..., K, d), one product of [sigma0, e_0 .. e_{K-2}]
    (sigma0 zero by default) against ``carry_w``."""
    K, d = end_states.shape[-2:]
    lead = end_states.shape[:-2]
    if carry_w.shape != (K * d, K * d):
        raise ValueError(f"carry_w {tuple(carry_w.shape)} != "
                         f"{(K * d, K * d)}")
    if sigma0 is None:
        sigma0 = end_states.new_zeros(lead + (d,))
    vecs = torch.cat([sigma0.unsqueeze(-2), end_states[..., : K - 1, :]],
                     dim=-2)
    return (vecs.reshape(lead + (K * d,)) @ carry_w).reshape(lead + (K, d))


def group_ends_plain(inj: torch.Tensor, toe: torch.Tensor):
    """Plain version of ``group_ends``: (end_states (..., K, d), pre (...,
    K, ceil(G / 4), d)) from the dense product: the state after the last
    group and after every CHUNK-th (pre[c] = s_{4c+3}; a partial last
    chunk's entry, which no kernel reads, zero)."""
    G, d = inj.shape[-2:]
    s_tail = _dense_states(inj, toe)
    pre = s_tail[..., CHUNK - 1::CHUNK, :]
    if G % CHUNK:
        pre = torch.cat([pre, pre.new_zeros(pre.shape[:-2] + (1, d))], -2)
    return s_tail[..., G - 1, :], pre


def group_solve_plain(inj: torch.Tensor, toe: torch.Tensor,
                      carry_w: torch.Tensor,
                      sigma0: torch.Tensor | None = None,
                      end: torch.Tensor | None = None):
    """Plain version of the carry route: (s_true, end_states, sigma) from
    the dense product, ``carry_plain`` and the entry states' einsum.
    ``end``: the ends to carry (those of ``group_ends``, as the solve
    kernel takes them); the dense product's by default."""
    s_in, e = group_states_plain(inj, toe)
    if end is not None:
        e = end
    sigma = carry_plain(e, carry_w, sigma0)
    return group_entry_states_plain(s_in, sigma, toe), e, sigma


def _mirror_taps(toe: torch.Tensor, d: int, count: int) -> torch.Tensor:
    """The table's taps in float64, zero from the table's end to ``count``
    (as the kernels' zero-filled copies)."""
    taps = toeplitz_taps(toe, d).double()
    if taps.shape[0] >= count:
        return taps
    return torch.cat([taps, taps.new_zeros(count - taps.shape[0], d, d)])


def _lane_scan(S: torch.Tensor, tap) -> torch.Tensor:
    """The kernels' Kogge-Stone scan over the lanes (axis 1 of S (rows, 32,
    d)): S_l += S_{l-2^k} tap(k), k = 0..4."""
    for k in range(CHUNKS.bit_length() - 1):
        off = 1 << k
        S = torch.cat([S[:, :off], S[:, off:] + S[:, :-off] @ tap(k)], 1)
    return S


def _tiles(inj: torch.Tensor, chunk: int):
    """(rows, tiles, 32, chunk, d) float64 injections of the kernels'
    warps: tiles of 32 chunks of ``chunk`` groups, the last zero-filled."""
    K, G, d = inj.shape[-3:]
    x = inj.reshape(-1, G, d).double()
    tile = CHUNKS * chunk
    tiles = -(-G // tile)
    x = torch.cat([x, x.new_zeros(x.shape[0], tiles * tile - G, d)], 1)
    return x.reshape(x.shape[0], tiles, CHUNKS, chunk, d)


def group_ends_mirror(inj: torch.Tensor, toe: torch.Tensor,
                      chunk: int = CHUNK):
    """The ends kernel in torch, for the CPU tests: (end_states (..., K,
    d), pre (..., K, ceil(G / chunk), d)), float64 sums rounded to float32.
    Each tile of 32 chunks of ``chunk`` groups (the kernel's is
    ``CHUNK``): every chunk's end from the taps T_1 .. T_{chunk-1}, the
    earlier tiles' state entering at chunk 0 (T_chunk), the scan over the
    chunks (T_{chunk 2^k}): the zero-entry state at every chunk's end;
    the row's end inside its last chunk from the chunk before it."""
    K, G, d = inj.shape[-3:]
    lead = inj.shape[:-3]
    x = _tiles(inj, chunk)
    rows, tiles = x.shape[:2]
    taps = _mirror_taps(toe, d, chunk * CHUNKS // 2 + 1)
    seed = x.new_zeros(rows, d)
    pre = []
    for t in range(tiles):
        c = x[:, t]
        S = c[:, :, chunk - 1].clone()
        for i in range(chunk - 1):
            S = S + c[:, :, i] @ taps[chunk - 1 - i]
        S[:, 0] = S[:, 0] + seed @ taps[chunk]
        S = _lane_scan(S, lambda k: taps[chunk << k])
        pre.append(S)
        if t < tiles - 1:
            seed = S[:, -1]
    nt = G - (tiles - 1) * CHUNKS * chunk
    at, i = divmod(nt - 1, chunk)
    if i == chunk - 1:
        end = S[:, at]
    else:
        c = x[:, -1, at]
        end = c[:, i] + (S[:, at - 1] if at else seed) @ taps[i + 1]
        for l in range(1, i + 1):
            end = end + c[:, i - l] @ taps[l]
    pre = torch.cat(pre, 1)[:, : -(-G // chunk)]
    return (end.float().reshape(lead + (K, d)),
            pre.float().reshape(lead + (K, pre.shape[1], d)))


def group_states_mirror(inj: torch.Tensor, toe: torch.Tensor,
                        chunk: int = CHUNK, seed: torch.Tensor | None = None):
    """The state kernels in torch, for the CPU tests: the ends kernel
    (``group_ends_mirror``), then the solve kernel from its float32 chunk
    ends: the state entering chunk l is pre[l-1] plus the seed's share,
    seed T_{chunk l}, and each group of the chunk s = s T_1 + inj.
    ``seed`` (..., K, d): the state entering each block (float64 kept as
    it is; zero by default).  Float64 sums, rounded to float32.  Returns
    (out, end_states): out[..., 0, :] = the seed, out[..., g + 1, :] = the
    state after group g (s_in with no seed, s_true with one), and the
    zero-entry state after the last group."""
    K, G, d = inj.shape[-3:]
    lead = inj.shape[:-3]
    end, pre = group_ends_mirror(inj, toe, chunk)
    x = _tiles(inj, chunk)
    rows, tiles = x.shape[:2]
    taps = _mirror_taps(toe, d, chunk * CHUNKS + 1)
    seed = (x.new_zeros(rows, d) if seed is None
            else seed.reshape(rows, d).double())
    first = seed
    p = pre.reshape(rows, -1, d).double()
    p = torch.cat([p, p.new_zeros(rows, tiles * CHUNKS - p.shape[1], d)], 1)
    prev = x.new_zeros(rows, d)
    lane_taps = taps[chunk * torch.arange(1, CHUNKS + 1)]      # (32, d, d)
    s = []
    for t in range(tiles):
        P = p[:, t * CHUNKS:(t + 1) * CHUNKS]
        ends = torch.einsum("rf,lfe->rle", seed, lane_taps)
        r = (torch.cat([seed[:, None], ends[:, :-1]], 1)
             + torch.cat([prev[:, None], P[:, :-1]], 1))
        for i in range(chunk):
            r = x[:, t, :, i] + r @ taps[1]
            s.append(r)
        seed, prev = ends[:, -1], P[:, -1]
    s = torch.stack(s, 1).reshape(rows, tiles, chunk, CHUNKS, d)
    s = s.permute(0, 1, 3, 2, 4).reshape(rows, -1, d)[:, :G]
    s = s.float().reshape(lead + (K, G, d))
    out = torch.cat([first.float().reshape(lead + (K, 1, d)),
                     s[..., : G - 1, :]], dim=-2)
    return out, end


def carry_mirror(end_states: torch.Tensor, carry_w: torch.Tensor,
                 sigma0: torch.Tensor | None = None) -> torch.Tensor:
    """The solve kernel's carry in torch, for the CPU tests: for block k,
    lane l sums its chunk of n = ceil(K / 32) blocks m in (k - n (32 - l),
    k - n (31 - l)] as sum_i v_{top-i} C_i (v_0 = sigma0, v_m = e_{m-1};
    C_0 = I), then the scan over the lanes with C_{n 2^k} carries the sums
    to lane 31: the first of each CUDA block's ``WARPS`` block rows (a
    signal's first is sigma0), the others by sigma_{k+1} = sigma_k C_1 +
    e_k.  Float64 from the float32 ends and carry taps; returns
    sigma (..., K, d) in float64, the seed the solve kernel keeps."""
    K, d = end_states.shape[-2:]
    lead = end_states.shape[:-2]
    n = -(-K // CHUNKS)
    e = end_states.reshape(-1, K, d).double()
    rows = e.shape[0]
    v0 = (e.new_zeros(rows, 1, d) if sigma0 is None
          else sigma0.reshape(rows, 1, d).double())
    # v_m at m + 32 n, 32 n zeros in front.
    v = torch.cat([e.new_zeros(rows, CHUNKS * n, d), v0, e[:, : K - 1]], 1)
    C = _mirror_taps(carry_w, d, CHUNKS * n // 2 + 1)
    k = torch.arange(K)[:, None, None]
    lane = torch.arange(CHUNKS)[None, :, None]
    i = torch.arange(n)[None, None, :]
    m = k - n * (CHUNKS - 1 - lane) - i                  # (K, 32, n)
    V = v[:, (m + CHUNKS * n).clamp(min=0)]              # (rows, K, 32, n, d)
    X = torch.einsum("rklif,ife->rkle", V, C[:n])
    X = X.reshape(rows * K, CHUNKS, d)
    X = _lane_scan(X, lambda s: C[n << s])
    sigma = X[:, -1].reshape(rows * K, d)
    e = e.reshape(rows * K, d)
    for row in range(rows * K):
        if row % WARPS and row % K:
            sigma[row] = e[row - 1] + sigma[row - 1] @ C[1]
    return sigma.reshape(lead + (K, d))


def group_solve_mirror(inj: torch.Tensor, toe: torch.Tensor,
                       carry_w: torch.Tensor,
                       sigma0: torch.Tensor | None = None):
    """The carry route's two kernels in torch: (s_true, end_states, sigma)
    as ``group_true_states`` returns them, the ends rounded to float32
    between the kernels as the card keeps them."""
    end = group_ends_mirror(inj, toe)[0]
    sigma = carry_mirror(end, carry_w, sigma0)
    s_true = group_states_mirror(inj, toe, seed=sigma)[0]
    return s_true, end, sigma.float()


# The kernels' agreement with the plain versions: > PLAIN_DB and max abs
# err <= 1e-5 * max|ref|, or else >= FLOAT64_DB against the float64
# chain.  Where the poles lie close to 1 within a group (config_matrix's
# P = 1 plans at low rates) the dense float32 product is itself only 104 to
# 126 dB accurate on an H100, so no other order of the sums can match it
# at PLAIN_DB; the scan's own floor there, the float32 taps' rounding
# compounded by its factored products, is ~110 dB.
PLAIN_DB, FLOAT64_DB = 120.0, 100.0


def _snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    err = (got.double() - ref).pow(2).mean()
    return float(10.0 * torch.log10(ref.pow(2).mean() / err))


def states_agree(got, plain, inj, toe, carry_w=None, sigma0=None,
                 end=None, part=None) -> tuple[bool, str]:
    """Whether a state kernel's output ``got`` holds against the plain
    version's ``plain`` on injections ``inj`` and table ``toe`` (the rule
    above), and the numbers that decided it.  ``part`` names the output
    for the float64 reference: 's_in' or 'end' (the dense product's),
    'pre' (its every CHUNK-th state, the first ``got.shape[-2]`` chunks),
    's_true' or 'sigma' (``group_solve_plain``'s with ``carry_w``,
    ``sigma0`` and, where given, the kernel's ``end``); by default s_in or
    the ends by shape without ``carry_w``, s_true or sigma with it."""
    top = float(plain.abs().max())
    err = float((got - plain).abs().max())
    if top == 0.0:
        return err == 0.0, f"all zeros, max abs err {err:.3e}"
    snr = _snr_db(plain, got)
    what = (f"snr {snr:.1f} dB (bound {PLAIN_DB:.0f}), max abs err "
            f"{err:.3e} (bound 1e-05 * {top:.3e})")
    if snr > PLAIN_DB and err <= 1e-5 * top:
        return True, what
    if part is None:
        full = got.shape == inj.shape
        part = (("s_true" if full else "sigma") if carry_w is not None
                else ("s_in" if full else "end"))
    inj64, toe64 = inj.double(), toe.double()
    if part in ("s_true", "sigma"):
        ref = group_solve_plain(
            inj64, toe64, carry_w.double(),
            None if sigma0 is None else sigma0.double(),
            None if end is None else end.double())
        ref = ref[0] if part == "s_true" else ref[2]
    elif part == "pre":
        ref = group_ends_plain(inj64, toe64)[1][..., : got.shape[-2], :]
    else:
        ref = group_states_plain(inj64, toe64)[0 if part == "s_in" else 1]
    plain_db, got_db = _snr_db(ref, plain), _snr_db(ref, got)
    what += (f"; against the float64 chain: kernel {got_db:.1f} dB "
             f"(bound {FLOAT64_DB:.0f}), plain {plain_db:.1f} dB")
    return got_db >= FLOAT64_DB, what


def chunk_multiply_adds(G: int, d: int) -> int:
    """Multiply-adds of the solve kernel's states a block row of G groups
    (a ragged last tile counted whole): a product by T_1 a group, and with
    a seed (the carry route) the seed's share of each chunk's entering
    state, a product by the lane's own tap."""
    tiles = -(-G // TILE)
    return tiles * TILE * d * d


def ends_multiply_adds(G: int, d: int) -> int:
    """Multiply-adds of the ends kernel a block row of G groups (a ragged
    last tile counted whole): each chunk's end (3 taps), the scan's steps
    (32 - 2^k chunks at step k), the earlier tiles' state at chunk 0."""
    tiles = -(-G // TILE)
    scan = sum(CHUNKS - (1 << k) for k in range(CHUNKS.bit_length() - 1))
    return (tiles * ((CHUNK - 1) * CHUNKS + scan) + tiles - 1) * d * d


def solve_multiply_adds(G: int, d: int, K: int) -> int:
    """Multiply-adds of the solve kernel with its carry over the K block
    rows of one signal: each ``WARPS``-th row's carry tree (its lanes'
    chunks of n = ceil(K / 32) blocks past the first, and the scan steps
    that reach them), one product for each row between, and each row's
    states (``chunk_multiply_adds`` and the seed's share)."""
    n = -(-K // CHUNKS)
    states = chunk_multiply_adds(G, d) + -(-G // TILE) * CHUNKS * d * d
    total = K * states
    for k in range(K):
        if k % WARPS:
            total += d * d
            continue
        tops = [k - n * (CHUNKS - 1 - lane) for lane in range(CHUNKS)]
        chunk = sum(max(0, min(n - 1, top)) for top in tops)
        steps = (-(-(k + 1) // n) - 1).bit_length()
        scan = sum(CHUNKS - (1 << s) for s in range(steps))
        total += (chunk + scan) * d * d
    return total


def occupancy(which: str, d: int, K: int = 1) -> dict:
    """The card's view of a kernel (``which``: 'ends', 'solve' or
    'states', the zero-seed solve) at d and K: blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    (spilled) bytes a thread, dynamic shared bytes and threads a block."""
    lib = _build.load("group_states", _LAUNCHERS)
    out = (ctypes.c_int * 5)()
    err = lib.group_states_occupancy(("ends", "solve", "states").index(which),
                                     d, K, out)
    _build.check(lib, err, "group_states_occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes",
                     "smem_bytes", "threads"), out))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _strides(inj4):
    outer, K, G, d = inj4.shape
    so, sk, sg, _ = inj4.stride()
    return outer * K, K, G, d, so, sk, sg


def _launch_ends(inj4, taps, end, pre):
    lib = _build.load("group_states", _LAUNCHERS)
    with torch.cuda.device(inj4.device):
        err = lib.group_ends_launch(
            inj4.data_ptr(), taps.data_ptr(), end.data_ptr(), pre.data_ptr(),
            *_strides(inj4), taps.stride(0), _stream(inj4))
    _build.check(lib, err, "group_ends_launch")


def _launch_solve(inj4, taps, pre, end, cw, sigma0, s_true, sigma):
    lib = _build.load("group_states", _LAUNCHERS)
    with torch.cuda.device(inj4.device):
        err = lib.group_solve_launch(
            inj4.data_ptr(), taps.data_ptr(), pre.data_ptr(), end.data_ptr(),
            cw.data_ptr(), 0 if sigma0 is None else sigma0.data_ptr(),
            s_true.data_ptr(), sigma.data_ptr(), *_strides(inj4),
            taps.stride(0), cw.stride(0), _stream(inj4))
    _build.check(lib, err, "group_solve_launch")


def _launch_states(inj4, taps, pre, s_in):
    lib = _build.load("group_states", _LAUNCHERS)
    with torch.cuda.device(inj4.device):
        err = lib.group_states_launch(
            inj4.data_ptr(), taps.data_ptr(), pre.data_ptr(), s_in.data_ptr(),
            *_strides(inj4), taps.stride(0), _stream(inj4))
    _build.check(lib, err, "group_states_launch")


def _launch_entry(s_in, sigma, toe, s_true):
    lib = _build.load("group_states", _LAUNCHERS)
    G, d = s_in.shape[-2:]
    with torch.cuda.device(s_in.device):
        err = lib.group_entry_launch(
            s_in.data_ptr(), sigma.data_ptr(), toe.data_ptr(),
            s_true.data_ptr(), s_in.numel() // (G * d), G, d, toe.stride(0),
            _stream(s_in))
    _build.check(lib, err, "group_entry_launch")


def _check(what: str, *named):
    dev = named[0][1].device
    for name, t in named:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be a float32 tensor, got "
                            f"{getattr(t, 'dtype', type(t))}")
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"{named[0][0]} on {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _even(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at an 8-byte aligned address (the kernels' 8-byte
    loads), copied where it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _first_rows(table: torch.Tensor, d: int) -> torch.Tensor:
    """A table's first d rows as the kernels read them: unit column
    stride, an even row stride, an 8-byte aligned start (a copy of those
    rows otherwise: the builders' d x d table at G = 1 is a transposed
    view)."""
    if (table.stride(1) == 1 and table.stride(0) % 2 == 0
            and table.data_ptr() % 8 == 0):
        return table
    return _even(table[:d])


def _check_table(toe: torch.Tensor, G: int, d: int, cuda: bool,
                 name: str = "group_toeplitz"):
    """The table as the kernels read it (``_first_rows``), after its
    shape."""
    if tuple(toe.shape) != (G * d, G * d):
        raise ValueError(f"{name} {tuple(toe.shape)} != {(G*d, G*d)}")
    if not cuda:
        return toe
    if d not in DIMS:
        raise ValueError(f"the state kernels take d in {DIMS}, got {d}")
    return _first_rows(toe, d)


def _injections(what: str, inj: torch.Tensor, toe: torch.Tensor):
    """(device, the table as the kernels read it, K, G, d) after the checks
    of a state kernel's (..., K, G, d) injections."""
    dev = _check(what, ("inj", inj), ("toe", toe))
    if inj.ndim < 3:
        raise ValueError(f"inj {tuple(inj.shape)} must be (..., K, G, d)")
    K, G, d = inj.shape[-3:]
    return dev, _check_table(toe, G, d, dev.type == "cuda"), K, G, d


def _rows(inj: torch.Tensor) -> torch.Tensor:
    """inj viewed (outer, K, G, d) as the kernels read it: unit stride
    along d, even strides and start, else a contiguous copy."""
    inj4 = inj.reshape((-1,) + tuple(inj.shape[-3:]))
    if (inj4.stride(-1) != 1 or inj4.data_ptr() % 8
            or any(s % 2 for s in inj4.stride()[:3])):
        inj4 = _even(inj4)
    return inj4


def group_ends(inj: torch.Tensor, toe: torch.Tensor):
    """The zero-entry ends of (..., K, G, d) injections -> (end_states
    (..., K, d): the state after each block's last group from a zero
    start, the carry's input; pre (..., K, ceil(G / CHUNK), d): the state
    after every CHUNK-th group, the solve kernel's input).

    ``inj`` float32 with unit stride along d (any other strides: the frames
    route passes a column slice of its weight-concat product); ``toe`` the
    (G d, G d) block-Toeplitz table.  A CPU tensor runs the plain version
    (``group_ends_plain``); a CUDA tensor launches the ends kernel (d even
    in 2..16), raising if it cannot."""
    dev, taps, K, G, d = _injections("group_ends", inj, toe)
    if dev.type == "cpu":
        return group_ends_plain(inj, toe)
    lead = inj.shape[:-3]
    end = torch.empty(lead + (K, d), dtype=torch.float32, device=dev)
    pre = torch.empty(lead + (K, -(-G // CHUNK), d), dtype=torch.float32,
                      device=dev)
    if end.numel() and G:
        _launch_ends(_rows(inj), taps, end, pre)
        group_ends.launches += 1
    return end, pre


group_ends.launches = 0


def group_solve(inj: torch.Tensor, toe: torch.Tensor, end: torch.Tensor,
                pre: torch.Tensor, carry_w: torch.Tensor,
                sigma0: torch.Tensor | None = None):
    """The carry and the states of (..., K, G, d) injections -> (s_true
    (..., K, G, d) contiguous, the true state entering each group; sigma
    (..., K, d), each block's entering state).

    ``end`` and ``pre``: ``group_ends``' outputs on the same injections;
    ``carry_w`` the (K d, K d) carry triangle, whose first block row holds
    the powers C_m; ``sigma0`` (..., d): the state entering block 0 (zero
    by default).  A CPU tensor runs the plain version (the dense product,
    ``carry_plain`` from ``end``, the entry states' einsum); a CUDA tensor
    launches the solve kernel (d even in 2..16), raising if it cannot."""
    named = [("inj", inj), ("toe", toe), ("end", end), ("pre", pre),
             ("carry_w", carry_w)]
    if sigma0 is not None:
        named.append(("sigma0", sigma0))
    dev = _check("group_solve", *named)
    if inj.ndim < 3:
        raise ValueError(f"inj {tuple(inj.shape)} must be (..., K, G, d)")
    K, G, d = inj.shape[-3:]
    lead = tuple(inj.shape[:-3])
    for name, t, want in (("end", end, lead + (K, d)),
                          ("pre", pre, lead + (K, -(-G // CHUNK), d)),
                          ("sigma0", sigma0, lead + (d,))):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} must be {want}")
    cuda = dev.type == "cuda"
    taps = _check_table(toe, G, d, cuda)
    ctaps = _check_table(carry_w, K, d, cuda, "carry_w")
    if not cuda:
        s_true, _, sigma = group_solve_plain(inj, toe, carry_w, sigma0, end)
        return s_true, sigma
    s_true = torch.empty(lead + (K, G, d), dtype=torch.float32, device=dev)
    sigma = torch.empty(lead + (K, d), dtype=torch.float32, device=dev)
    if s_true.numel():
        _launch_solve(_rows(inj), taps, _even(pre), _even(end), ctaps,
                      None if sigma0 is None else _even(sigma0), s_true,
                      sigma)
        group_solve.launches += 1
    return s_true, sigma


group_solve.launches = 0


def group_true_states(inj: torch.Tensor, toe: torch.Tensor,
                      carry_w: torch.Tensor,
                      sigma0: torch.Tensor | None = None):
    """Steps 2-3 and the entry states where the carry triangle exists ->
    (s_true (..., K, G, d) contiguous, end_states (..., K, d), sigma (...,
    K, d)).  A CUDA tensor runs two launches, ``group_ends`` then
    ``group_solve`` (no s_in, no cuBLAS); a CPU tensor the plain version,
    ``group_solve_plain``."""
    if inj.device.type == "cpu":
        _injections("group_true_states", inj, toe)
        return group_solve_plain(inj, toe, carry_w, sigma0)
    end, pre = group_ends(inj, toe)
    s_true, sigma = group_solve(inj, toe, end, pre, carry_w, sigma0)
    return s_true, end, sigma


def group_states(inj: torch.Tensor, toe: torch.Tensor):
    """Step 2 on (..., K, G, d) injections -> (s_in (..., K, G, d), the
    zero-entry state entering each group, contiguous; end_states (..., K,
    d)), for the callers that run a carry of their own between the passes.

    ``inj`` and ``toe`` as ``group_ends`` takes them.  A CPU tensor runs
    the plain version (the dense product); a CUDA tensor runs the ends
    kernel (``group_ends``) and the solve kernel with a zero seed (counted
    here), raising if it cannot.
    """
    dev, taps, K, G, d = _injections("group_states", inj, toe)
    if dev.type == "cpu":
        return group_states_plain(inj, toe)
    lead = inj.shape[:-3]
    end, pre = group_ends(inj, toe)
    s_in = torch.empty(lead + (K, G, d), dtype=torch.float32, device=dev)
    if s_in.numel():
        _launch_states(_rows(inj), taps, pre, s_in)
        group_states.launches += 1
    return s_in, end


group_states.launches = 0


def group_entry_states(s_in: torch.Tensor, sigma: torch.Tensor,
                       toe: torch.Tensor) -> torch.Tensor:
    """s_true = s_in + A^{gU} sigma -> (..., K, G, d) contiguous: the true
    state entering each group, from the zero-entry states ``s_in`` (...,
    K, G, d) and the blocks' true initial states ``sigma`` (..., K, d),
    the taps read from ``toe``.  A CPU tensor runs the plain version; a
    CUDA tensor launches the entry kernel (d even in 2..16)."""
    dev = _check("group_entry_states", ("s_in", s_in), ("sigma", sigma),
                 ("toe", toe))
    if s_in.ndim < 3:
        raise ValueError(f"s_in {tuple(s_in.shape)} must be (..., K, G, d)")
    G, d = s_in.shape[-2:]
    if tuple(sigma.shape) != tuple(s_in.shape[:-2]) + (d,):
        raise ValueError(f"sigma {tuple(sigma.shape)} must be "
                         f"{tuple(s_in.shape[:-2]) + (d,)}")
    taps = _check_table(toe, G, d, dev.type == "cuda")
    if dev.type == "cpu":
        return group_entry_states_plain(s_in, sigma, toe)
    s_in, sigma = s_in.contiguous(), sigma.contiguous()
    s_true = torch.empty_like(s_in)
    if s_true.numel():
        _launch_entry(s_in, sigma, taps, s_true)
        group_entry_states.launches += 1
    return s_true


group_entry_states.launches = 0
