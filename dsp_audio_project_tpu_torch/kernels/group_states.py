"""The EQ's group-state solve: CUDA kernel (two modes), wrappers, plain
versions and a torch mirror of the kernel's scan.

Step 2 of the grouped EQ (ops/eq.py) turns each block row's per-group
injections inj (K, G, d) into the zero-entry state after every group,

    s_g = sum_{j <= g} inj_j T_{g-j},    T_m = (A^{mU})^T,

a product against the block-lower-triangular Toeplitz table
``group_toeplitz`` (G d, G d), whose block (j, g) is T_{g-j} for j <= g and
0 above; after the carry gives each block's true initial state sigma, the
state entering group g is s_true = s_in + sigma T_g.  ``group_states``
returns (s_in, end_states) as the dense product did: s_in shifted by one
group (s_in[0] = 0) and end_states = s_{G-1}; ``group_entry_states``
returns s_true.

Replaces no TPU kernel: the JAX package leaves both to XLA as a dense
product and an einsum (``dsp_audio_project_tpu/ops/eq.py:106
_grouped_states``, ``:186``).  The plain versions here are the torch ops
the port ran on cuBLAS until the kernel (``group_states_plain``: one (B K,
G d) @ (G d, G d) product, 3.78 GFLOP in fp32 at the serving shape, half
of it zeros); the wrappers run them on a CPU tensor, and ``chip_smoke.py``
and the card tests hold the kernel against them.  ``csrc/group_states.cu``
reads only the table's first block row (the taps; ``toeplitz_taps``) and
runs a chunked scan on the CUDA cores, float32 in and out, summed in
float64: inside each chunk of c = ``CHUNK`` groups the lower triangle of
taps, across the tile's 32 chunks a scan in five steps (S_m += S_{m-2^k}
T_{c 2^k}), then each group adds the state entering its chunk times
T_{i+1}; the entry mode adds sigma T_g in float32.  Float32 sums ran 1.6x
faster but fell ~9 dB below the float64 product, and below the dense
float32 product, where the poles lie close to 1 within a group
(``scripts/state_variants.py``).  ``group_states_mirror`` repeats the
scan's arithmetic in torch for the CPU tests (tile by tile, chunk by
chunk, at any c); the wrappers never run it.  The table must be block
Toeplitz: every table of the port is (``design/biquad.block_operators``,
``eq_design``'s ``_lower_triangle``), as tests/test_torch_group_states.py
checks.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

TILE = 128                 # group positions a tile (threads a block)
CHUNK = 4                  # c: groups a chunk of the kernel's scan
CHUNKS = TILE // CHUNK     # chunks a tile: the scan runs over them
DIMS = tuple(range(2, 17, 2))  # d: the kernels' instantiations

_LAUNCHERS = {
    "group_states_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p],
    "group_entry_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_longlong] + [ctypes.c_void_p],
}


def toeplitz_taps(toe: torch.Tensor, d: int) -> torch.Tensor:
    """(G, d, d) view of the taps T_m[f, e] = toe[f, m d + e]: the table's
    first block row, all a block-Toeplitz table holds."""
    G = toe.shape[-1] // d
    return toe[:d].reshape(d, G, d).permute(1, 0, 2)


def group_states_plain(inj: torch.Tensor, toe: torch.Tensor):
    """Plain version: (s_in, end_states) from one dense product of the
    (..., K, G d) injections against the (G d, G d) table."""
    K, G, d = inj.shape[-3:]
    lead = inj.shape[:-3]
    s_tail = (inj.reshape(lead + (K, G * d)) @ toe).reshape(lead + (K, G, d))
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


def group_states_mirror(inj: torch.Tensor, toe: torch.Tensor,
                        chunk: int = CHUNK):
    """The kernel's scan in torch, for the CPU tests: tiles of 32 chunks of
    ``chunk`` groups (the kernel's is ``CHUNK``: 128 groups a tile; the
    last tile zero-filled), the three phases in the kernel's order and, as
    the kernel, in float64 from the float32 injections and taps (read from
    the first block row, zero past G), rounded to float32 at the end.
    Returns (s_in, end_states) as the plain version."""
    K, G, d = inj.shape[-3:]
    lead = inj.shape[:-3]
    x = inj.reshape(-1, G, d).double()
    rows, tile = x.shape[0], CHUNKS * chunk
    taps = x.new_zeros(max(G, chunk * CHUNKS // 2 + 1), d, d)
    taps[:G] = toeplitz_taps(toe, d)
    s = x.new_empty(rows, G, d)
    carry = x.new_zeros(rows, d)
    for t0 in range(0, G, tile):
        nt = min(tile, G - t0)
        loc = x.new_zeros(rows, tile, d)
        loc[:, :nt] = x[:, t0:t0 + nt]
        loc = loc.reshape(rows, CHUNKS, chunk, d)
        # A: loc_i = inj_i + sum_{l=1..i} inj_{i-l} T_l, from the top (the
        # terms read injections not yet overwritten), l rising.
        for i in range(chunk - 1, 0, -1):
            for l in range(1, i + 1):
                loc[:, :, i] = loc[:, :, i] + loc[:, :, i - l] @ taps[l]
        # B: S_c = loc_{c, last} (+ carry T_chunk at chunk 0), then the
        # steps S_c += S_{c-2^k} T_{chunk 2^k} over the chunks.
        S = loc[:, :, chunk - 1].clone()
        S[:, 0] = S[:, 0] + carry @ taps[chunk]
        for k in range(CHUNKS.bit_length() - 1):
            off = 1 << k
            S = torch.cat([S[:, :off], S[:, off:] + S[:, :-off] @ taps[chunk * off]], 1)
        # C: s_{c,i} = loc_{c,i} + S_{c-1} T_{i+1} (the carry at chunk 0).
        r = torch.cat([carry[:, None], S[:, :-1]], 1)
        loc = loc + torch.einsum("rmf,ife->rmie", r, taps[1:chunk + 1])
        loc = loc.reshape(rows, tile, d)
        s[:, t0:t0 + nt] = loc[:, :nt]
        carry = loc[:, tile - 1]
    s = s.float().reshape(lead + (K, G, d))
    s_in = torch.cat([s.new_zeros(lead + (K, 1, d)), s[..., : G - 1, :]],
                     dim=-2)
    return s_in, s[..., G - 1, :]


# The kernels' agreement with the plain versions: > PLAIN_DB and max abs
# err <= 1e-5 * max|ref|, or else >= FLOAT64_DB against the float64
# product.  Where the poles lie close to 1 within a group (config_matrix's
# P = 1 plans at low rates) the dense float32 product is itself only 104 to
# 126 dB accurate on an H100, so no other order of the sums can match it
# at PLAIN_DB; the scan's own floor there, the float32 taps' rounding
# compounded by its factored products, is ~110 dB.
PLAIN_DB, FLOAT64_DB = 120.0, 100.0


def _snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    err = (got.double() - ref).pow(2).mean()
    return float(10.0 * torch.log10(ref.pow(2).mean() / err))


def states_agree(got, plain, inj, toe) -> tuple[bool, str]:
    """Whether the scan's states ``got`` hold against the plain version's
    ``plain`` on injections ``inj`` and table ``toe`` (the rule above), and
    the numbers that decided it."""
    top = float(plain.abs().max())
    err = float((got - plain).abs().max())
    if top == 0.0:
        return err == 0.0, f"all zeros, max abs err {err:.3e}"
    snr = _snr_db(plain, got)
    what = (f"snr {snr:.1f} dB (bound {PLAIN_DB:.0f}), max abs err "
            f"{err:.3e} (bound 1e-05 * {top:.3e})")
    if snr > PLAIN_DB and err <= 1e-5 * top:
        return True, what
    ref = group_states_plain(inj.double(), toe.double())
    ref = ref[0] if got.shape == ref[0].shape else ref[1]
    plain_db, got_db = _snr_db(ref, plain), _snr_db(ref, got)
    what += (f"; against the float64 product: kernel {got_db:.1f} dB "
             f"(bound {FLOAT64_DB:.0f}), plain {plain_db:.1f} dB")
    return got_db >= FLOAT64_DB, what


def chunk_multiply_adds(G: int, d: int) -> int:
    """Multiply-adds of the kernel's scan a block row of G groups (a
    ragged last tile counted whole, as the kernel runs it): the chunks'
    triangles of taps (i d^2 at a position i of its chunk), the scan's
    steps (32 - 2^k chunks at step k), the carry into every tile but the
    first, and the entering state of every group but those of the first
    tile's first chunk."""
    tiles = -(-G // TILE)
    tri = TILE * (CHUNK - 1) // 2
    scan = sum(CHUNKS - (1 << k) for k in range(CHUNKS.bit_length() - 1))
    return (tiles * (tri + scan + TILE + 1) - 1 - CHUNK) * d * d


def _launch_states(inj4, toe, s_in, end):
    lib = _build.load("group_states", _LAUNCHERS)
    outer, K, G, d = inj4.shape
    so, sk, sg, _ = inj4.stride()
    with torch.cuda.device(inj4.device):
        err = lib.group_states_launch(
            inj4.data_ptr(), toe.data_ptr(), s_in.data_ptr(), end.data_ptr(),
            outer * K, K, G, d, so, sk, sg, toe.stride(0),
            torch.cuda.current_stream(inj4.device).cuda_stream,
        )
    _build.check(lib, err, "group_states_launch")


def _launch_entry(s_in, sigma, toe, s_true):
    lib = _build.load("group_states", _LAUNCHERS)
    G, d = s_in.shape[-2:]
    with torch.cuda.device(s_in.device):
        err = lib.group_entry_launch(
            s_in.data_ptr(), sigma.data_ptr(), toe.data_ptr(),
            s_true.data_ptr(), s_in.numel() // (G * d), G, d, toe.stride(0),
            torch.cuda.current_stream(s_in.device).cuda_stream,
        )
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


def _check_table(toe: torch.Tensor, G: int, d: int, cuda: bool):
    """The table as the kernels read it: its first block row with unit
    column stride (a copy of those d rows where the table is a transposed
    view, as the builders' d x d table at G = 1 is)."""
    if tuple(toe.shape) != (G * d, G * d):
        raise ValueError(f"group_toeplitz {tuple(toe.shape)} != {(G*d, G*d)}")
    if not cuda:
        return toe
    if d not in DIMS:
        raise ValueError(f"the state kernels take d in {DIMS}, got {d}")
    return toe if toe.stride(1) == 1 else toe[:d].contiguous()


def group_states(inj: torch.Tensor, toe: torch.Tensor):
    """Step 2 on (..., K, G, d) injections -> (s_in (..., K, G, d), the
    zero-entry state entering each group, contiguous; end_states (..., K,
    d)).

    ``inj`` float32 with unit stride along d (any other strides: the frames
    route passes a column slice of its weight-concat product); ``toe`` the
    (G d, G d) block-Toeplitz table.  A CPU tensor runs the plain version;
    a CUDA tensor launches the kernel (d even in 2..16), raising if it
    cannot.
    """
    dev = _check("group_states", ("inj", inj), ("toe", toe))
    if inj.ndim < 3:
        raise ValueError(f"inj {tuple(inj.shape)} must be (..., K, G, d)")
    K, G, d = inj.shape[-3:]
    taps = _check_table(toe, G, d, dev.type == "cuda")
    if dev.type == "cpu":
        return group_states_plain(inj, toe)
    lead = inj.shape[:-3]
    s_in = torch.empty(lead + (K, G, d), dtype=torch.float32, device=dev)
    end = torch.empty(lead + (K, d), dtype=torch.float32, device=dev)
    if s_in.numel() == 0:
        return s_in, end
    inj4 = inj.reshape((-1, K, G, d))
    if inj4.stride(-1) != 1:
        inj4 = inj4.contiguous()
    _launch_states(inj4, taps, s_in, end)
    group_states.launches += 1
    return s_in, end


group_states.launches = 0


def group_entry_states(s_in: torch.Tensor, sigma: torch.Tensor,
                       toe: torch.Tensor) -> torch.Tensor:
    """s_true = s_in + A^{gU} sigma -> (..., K, G, d) contiguous: the true
    state entering each group, from the zero-entry states ``s_in`` (...,
    K, G, d) and the blocks' true initial states ``sigma`` (..., K, d),
    the taps read from ``toe``.  A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel's entry mode (d even in 2..16)."""
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
