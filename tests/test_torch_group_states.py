"""The state solve's kernel module (kernels/group_states.py) on the CPU,
where the wrappers run their plain versions.

* Every group Toeplitz table of the port is block-lower-triangular
  Toeplitz bit for bit: block (j, g) is the first block row's tap T_{g-j}
  for j <= g and zero above (the static tables of ``make_block_operators``
  at d = 10 and 12, the dynamic ones of ``dynamic_operators_plain``), and
  the taps are group_pows transposed; so is every carry triangle, its
  first block row the powers of A^block.  The kernels read only the taps.
* The mirrors of the kernels' arithmetic (``group_states_mirror``: the
  ends kernel, then the solve kernel with a zero seed or a seed;
  ``group_ends_mirror``; ``group_solve_mirror``: the carry route's two
  kernels) against the plain versions (> 120 dB and max abs err <= 1e-5 *
  max|ref|) and against the JAX package's ``_grouped_states``,
  ``_carry_states`` and entry einsum on the same seeded numpy input (>=
  110 dB), at chunks c in {1, 4, 8, 16, 32, G} (the kernels' is 4), G in
  {1, 8, 16, 100, 128, 200, 300} (ragged chunks and tiles), strided views
  and a nonzero incoming state.
* The wrappers' CPU route is the plain version, and the EQ's state solve
  on a CPU tensor is the chain it was before the kernels, bit for bit;
  the entry states' plain version equals the einsum against group_pows it
  replaced; the wrappers' argument checks raise; the CUDA source's kernel
  names keep the benchmark's name pattern.

The kernels themselves run only on the card: tests/test_torch_gpu.py holds
them against the plain versions there.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu_torch import EQConfig
from dsp_audio_project_tpu_torch.kernels.eq_design import (
    _lower_triangle, dynamic_operators_plain,
)
from dsp_audio_project_tpu_torch.ops import eq_dynamic as ted
from dsp_audio_project_tpu_torch.ops.eq import make_block_operators
from dsp_audio_project_tpu_torch.oracle import snr_db

gs = importlib.import_module("dsp_audio_project_tpu_torch.kernels.group_states")

torch.set_num_threads(2)

FS = 48000
U = 160
GAINS_D10 = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
             "Brilliance": 4}
GAINS_D12 = {"Sub-Bass": -9, "Bass": 5, "Low Mids": -2, "High Mids": 7,
             "Presence": 3, "Brilliance": -11}


def static_ops(gains: dict, G: int):
    cfg = EQConfig.from_gains(gains)
    return make_block_operators(cfg.active_bands(FS), FS, cfg.q, G * U, U)


def jax_ops(gains: dict, G: int):
    from dsp_audio_project_tpu.config import EQConfig as JEQConfig

    cfg = JEQConfig.from_gains(gains)
    return jeq.make_block_operators(cfg.active_bands(FS), FS, cfg.q, G * U, U)


def f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def dynamic_toe(gains, G: int) -> torch.Tensor:
    cfg = EQConfig()
    s, c = ted._band_trig(FS, cfg.band_centers, cfg.nyquist_safety)
    return dynamic_operators_plain(
        torch.tensor(gains, dtype=torch.float32), torch.as_tensor(s),
        torch.as_tensor(c), cfg.q, cfg.bypass_threshold_db, U, G)[3]


@pytest.mark.parametrize("table", ["static d10", "static d12",
                                   "dynamic complex", "dynamic real"])
def test_tables_are_block_toeplitz(table):
    G = 128
    if table.startswith("static"):
        ops = static_ops(GAINS_D10 if table.endswith("d10") else GAINS_D12, G)
        toe = f32(ops.group_toeplitz)
        pows = f32(ops.group_pows)
    else:
        gains = ((6.0, -3.0, 0.0, 12.0, -15.0, 4.0) if table.endswith("complex")
                 else (-15.0, -14.0, -13.0, -12.5, -3.0, 0.0))
        toe = dynamic_toe(gains, G)
        pows = None
    d = toe.shape[0] // G
    assert d == (10 if table == "static d10" else 12)
    taps = gs.toeplitz_taps(toe, d)
    assert torch.equal(taps[0], torch.eye(d))
    # Every block (j, g) of the table is T_{g-j} (j <= g) or zero.
    assert torch.equal(toe, _lower_triangle(taps.transpose(-1, -2), G, d))
    if pows is not None:
        assert torch.equal(taps, pows.transpose(-1, -2))


# (G, chunk, strided): the kernel's chunk of 4, one chunk (c = G), a
# chain of one-group chunks, ragged last chunks and tiles (G = 100, 300),
# a column slice.
SCAN_CASES = [(1, 1, False), (16, 1, False), (16, 8, False), (16, 16, False),
              (128, 1, False), (128, 4, False), (128, 8, False),
              (128, 16, False), (128, 128, False), (100, 4, False), (100, 16, False),
              (300, 1, False), (300, 4, False), (300, 32, False),
              (128, 4, True)]


@pytest.mark.parametrize("G,chunk,strided", SCAN_CASES)
def test_mirror_matches_plain_and_jax(G, chunk, strided):
    ops = static_ops(GAINS_D10, G)
    toe = f32(ops.group_toeplitz)
    d = toe.shape[0] // G
    rng = np.random.default_rng(G * 131 + chunk)
    x_g = rng.standard_normal((2, 3, G, U)).astype(np.float32)
    inj = torch.as_tensor(x_g) @ f32(ops.group_in)            # (2, 3, G, d)
    if strided:                 # the frames route's [y0 | inj | 0] slice
        wide = torch.zeros(2, 3, G, U + 12)
        wide[..., U:U + d] = inj
        inj = wide[..., U:U + d]
        assert not inj.is_contiguous()
    got_in, got_end = gs.group_states_mirror(inj, toe, chunk)
    ref_in, ref_end = gs.group_states_plain(inj, toe)
    for got, ref in ((got_in, ref_in), (got_end, ref_end)):
        assert got.shape == ref.shape
        top = float(ref.abs().max())
        if top == 0.0:                   # s_in at G = 1: all zeros
            assert torch.equal(got, ref)
            continue
        assert snr_db(ref.numpy().ravel(), got.numpy().ravel()) > 120
        assert float((got - ref).abs().max()) <= 1e-5 * top
    j_in, j_end = jeq._grouped_states(jnp.asarray(x_g), jax_ops(GAINS_D10, G))
    assert snr_db(np.asarray(j_end).ravel(), got_end.numpy().ravel()) >= 110
    if G > 1:
        assert snr_db(np.asarray(j_in).ravel(),
                      got_in.numpy().ravel()) >= 110


@pytest.mark.parametrize("L,M", [(1, 4), (2, 8)])
def test_mirror_where_the_float32_product_is_itself_inexact(L, M):
    """config_matrix's P = 1 plans at 11.025 kHz: poles close to 1 within a
    group, where the dense float32 product is itself ~104-119 dB accurate
    (cuBLAS, MKL), so that no other order of sums matches it at 120 dB.
    There the scan, summed in float64 as the kernel sums, holds against
    the float64 product at 100 dB (``states_agree``)."""
    from dsp_audio_project_tpu_torch.config import SRCConfig
    from dsp_audio_project_tpu_torch.ops.src import make_plan

    fs_out = SRCConfig(L=L, M=M).output_rate(44100)
    P = make_plan(L, M).P
    cfg = EQConfig.from_gains(GAINS_D10)
    ops = make_block_operators(cfg.active_bands(fs_out), fs_out, cfg.q,
                               128 * P, P)
    toe = f32(ops.group_toeplitz)
    rng = np.random.default_rng(L * 10 + M)
    x_g = rng.standard_normal((1, 8, 128, P)).astype(np.float32)
    inj = torch.as_tensor(x_g) @ f32(ops.group_in)
    got = gs.group_states_mirror(inj, toe)[0]
    plain = gs.group_states_plain(inj, toe)[0]
    ok, what = gs.states_agree(got, plain, inj, toe)
    assert P == 1 and ok and "float64" in what, what


def test_cpu_route_is_the_plain_version():
    G = 16
    ops = static_ops(GAINS_D12, G)
    toe, pows = f32(ops.group_toeplitz), f32(ops.group_pows)
    rng = np.random.default_rng(5)
    inj = torch.as_tensor(rng.standard_normal((3, 4, G, 12)).astype(np.float32))
    sigma = torch.as_tensor(rng.standard_normal((3, 4, 12)).astype(np.float32))
    before = (gs.group_states.launches, gs.group_entry_states.launches)
    s_in, end = gs.group_states(inj, toe)
    ref_in, ref_end = gs.group_states_plain(inj, toe)
    assert torch.equal(s_in, ref_in) and torch.equal(end, ref_end)
    s_true = gs.group_entry_states(s_in, sigma, toe)
    assert torch.equal(s_true, gs.group_entry_states_plain(s_in, sigma, toe))
    # The einsum against group_pows that the entry states replaced.
    assert torch.equal(s_true, s_in + torch.einsum("gef,...kf->...kge", pows,
                                                   sigma))
    assert (gs.group_states.launches,
            gs.group_entry_states.launches) == before


def test_chunk_multiply_adds_counts_the_scan():
    """The kernels' multiply-adds (the bounds' operations): the solve's
    states a product by T_1 a group (a ragged tile whole); the ends
    kernel's 3 taps a chunk and the scan's 31 + 30 + 28 + 24 + 16 chunk
    steps a tile, and each tile after the first its carry; the carry's
    tree at every 4th block (here K = 4: one tree, lane 31's chunk of one
    block and no scan step) and one product for each block between."""
    assert gs.chunk_multiply_adds(128, 10) == 128 * 100
    assert gs.chunk_multiply_adds(1, 12) == 128 * 144
    assert gs.ends_multiply_adds(128, 10) == (96 + 129) * 100
    assert gs.ends_multiply_adds(256, 2) == (2 * 225 + 1) * 4
    assert gs.solve_multiply_adds(128, 10, 4) == (4 * (128 + 32) + 3) * 100


def test_wrappers_check_their_arguments():
    G, d = 4, 2
    toe = torch.eye(G * d)
    inj = torch.zeros(2, G, d)
    with pytest.raises(TypeError, match="float32"):
        gs.group_states(inj.double(), toe)
    with pytest.raises(ValueError, match="group_toeplitz"):
        gs.group_states(inj, toe[:-2, :-2])
    with pytest.raises(ValueError, match=r"\(..., K, G, d\)"):
        gs.group_states(inj[0], toe)
    with pytest.raises(ValueError, match="unsupported device"):
        gs.group_states(inj.to("meta"), toe.to("meta"))
    with pytest.raises(ValueError, match="sigma"):
        gs.group_entry_states(inj, torch.zeros(3, d), toe)
    with pytest.raises(ValueError, match="is on"):
        gs.group_entry_states(inj, torch.zeros(2, d).to("meta"), toe)


# ---- the carry route: the ends kernel, the solve kernel, the carry ---------

K_BLOCKS = 6      # blocks a signal in the carry route's tests (n = 1 chunk a lane)


def injections(G: int, strided: bool, seed: int, d: int = 10, lead=(2, 3)):
    """Seeded normal injections (lead..., G, d), as the frames route's
    column slice of [y0 | inj | 0] where ``strided``."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal(lead + (G, d + 12)).astype(np.float32))
    inj = x[..., 5:5 + d] if strided else x[..., :d].contiguous()
    assert inj.is_contiguous() != strided
    return inj


def hold(got, ref):
    """> 120 dB and max abs err <= 1e-5 * max|ref|, or equal at all zeros."""
    assert got.shape == ref.shape
    top = float(ref.abs().max())
    if top == 0.0:
        assert torch.equal(got, ref)
        return
    assert snr_db(ref.numpy().ravel(), got.numpy().ravel()) > 120
    assert float((got - ref).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("G", [1, 8, 128, 200])
def test_solve_mirror_in_both_modes(G, seeded):
    """The solve kernel's arithmetic (its zero-seed form for the split
    callers, its seeded form for the carry route) against the dense
    product and the entry states' einsum, on a strided view, ragged tiles
    (G = 200) and one group a block."""
    toe = f32(static_ops(GAINS_D10, G).group_toeplitz)
    inj = injections(G, True, G + 7 * seeded)
    s_in, end = gs.group_states_plain(inj, toe)
    sigma = (torch.as_tensor(np.random.default_rng(G).standard_normal(
        inj.shape[:-2] + (10,)).astype(np.float32)) if seeded else None)
    got, got_end = gs.group_states_mirror(inj, toe, seed=sigma)
    hold(got_end, end)
    hold(got, s_in if sigma is None
         else gs.group_entry_states_plain(s_in, sigma, toe))


@pytest.mark.parametrize("G", [1, 8, 130, 200])
def test_ends_mirror_matches_plain(G):
    """The ends kernel's arithmetic: each block's zero-entry end, and the
    state after every chunk of 4 groups (the full chunks; a partial last
    chunk's entry is the solve kernel's scratch)."""
    toe = f32(static_ops(GAINS_D12, G).group_toeplitz)
    inj = injections(G, G % 2 == 0, 3 * G, d=12)
    end, pre = gs.group_ends_mirror(inj, toe)
    ref_end, ref_pre = gs.group_ends_plain(inj, toe)
    assert pre.shape == ref_pre.shape == inj.shape[:-2] + (-(-G // 4), 12)
    hold(end, ref_end)
    full = G // 4
    if full:
        hold(pre[..., :full, :], ref_pre[..., :full, :])


def jax_true_states(x_g: np.ndarray, gains: dict, G: int, sigma0):
    """The JAX package's chain on grouped samples x_g (..., K, G, U):
    ``_grouped_states``, ``_carry_states`` (its carry triangle, K <= 512)
    and the entry einsum against group_pows, at HIGHEST precision."""
    import jax

    jops = jax_ops(gains, G)
    with jax.default_matmul_precision("highest"):
        s_in, end = jeq._grouped_states(jnp.asarray(x_g), jops)
        sigma = jeq._carry_states(
            end, jops, None if sigma0 is None else jnp.asarray(sigma0))
        s_true = s_in + jnp.einsum(
            "gef,...kf->...kge", jnp.asarray(jops.group_pows, jnp.float32),
            sigma, precision=jax.lax.Precision.HIGHEST)
    return tuple(np.asarray(a) for a in (s_true, end, sigma))


@pytest.mark.parametrize("with_sigma0", [False, True], ids=["zero", "sigma0"])
def test_carry_route_matches_jax(with_sigma0):
    """``group_solve_plain`` (what the wrapper runs on the CPU) and the two
    kernels' mirror against the JAX package's chain on the same seeded
    numpy samples, with and without an incoming state: >= 110 dB (the
    injections are rounded to float32 in each package's own product)."""
    from dsp_audio_project_tpu_torch.ops.eq import _carry_weights

    G = 128
    ops = static_ops(GAINS_D10, G)
    toe, carry_w = f32(ops.group_toeplitz), f32(_carry_weights(ops, K_BLOCKS))
    rng = np.random.default_rng(41 + with_sigma0)
    x_g = rng.standard_normal((2, K_BLOCKS, G, U)).astype(np.float32)
    sigma0 = (rng.standard_normal((2, 10)).astype(np.float32)
              if with_sigma0 else None)
    want = jax_true_states(x_g, GAINS_D10, G, sigma0)
    inj = torch.as_tensor(x_g) @ f32(ops.group_in)
    s0 = None if sigma0 is None else torch.as_tensor(sigma0)
    for got in (gs.group_solve_plain(inj, toe, carry_w, s0),
                gs.group_solve_mirror(inj, toe, carry_w, s0)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert snr_db(w.ravel(), g.numpy().ravel()) >= 110


def test_solve_mirror_carries_many_blocks():
    """The carry's tree over chunks of n = 3 blocks a lane (K = 70) and a
    signal boundary inside a CUDA block's rows (K = 6 is not a multiple of
    the block's 4 rows), against the plain carry."""
    from dsp_audio_project_tpu_torch.ops.eq import _carry_weights

    G = 8
    ops = static_ops(GAINS_D10, G)
    toe = f32(ops.group_toeplitz)
    for K in (70, K_BLOCKS):
        carry_w = f32(_carry_weights(ops, K))
        rng = np.random.default_rng(K)
        inj = torch.as_tensor(rng.standard_normal((3, K, G, 10)).astype(np.float32))
        sigma0 = torch.as_tensor(rng.standard_normal((3, 10)).astype(np.float32))
        for got, ref in zip(gs.group_solve_mirror(inj, toe, carry_w, sigma0),
                            gs.group_solve_plain(inj, toe, carry_w, sigma0)):
            hold(got, ref)


@pytest.mark.parametrize("table", ["static", "dynamic"])
def test_carry_triangles_first_row_is_the_powers(table):
    """The solve kernel reads the carry from ``carry_w``'s first block row:
    C_0 = I, C_1 = A^block transposed, and the whole triangle is block
    lower-triangular Toeplitz in them, bit for bit (``_carry_weights``;
    the dynamic builder's plain ``_lower_triangle``)."""
    K, G = 9, 16
    if table == "static":
        from dsp_audio_project_tpu_torch.ops.eq import _carry_weights

        ops = static_ops(GAINS_D12, G)
        carry_w, a_blk = f32(_carry_weights(ops, K)), f32(ops.state_corr)
    else:
        cfg = EQConfig()
        s, c = ted._band_trig(FS, cfg.band_centers, cfg.nyquist_safety)
        outs = dynamic_operators_plain(
            torch.tensor((6.0, -3.0, 0.0, 12.0, -15.0, 4.0)), torch.as_tensor(s),
            torch.as_tensor(c), cfg.q, cfg.bypass_threshold_db, U, G, K)
        carry_w, a_blk = outs[6], outs[5]
    d = a_blk.shape[0]
    taps = gs.toeplitz_taps(carry_w, d)
    assert taps.shape == (K, d, d)
    assert torch.equal(taps[0], torch.eye(d))
    assert torch.equal(taps[1], a_blk.T)
    assert torch.equal(carry_w, _lower_triangle(taps.transpose(-1, -2), K, d))


def test_kernel_names_keep_the_benchmark_pattern():
    """Every kernel of csrc/group_states.cu carries "gemm" in its name (the
    benchmark files the state solve's device time under cuBLAS's pattern)
    and no float64 type among its template arguments or parameters (the
    slider's builder row, matched first, takes double / f64 names)."""
    import pathlib
    import re

    src = (pathlib.Path(gs.__file__).parent.parent / "csrc"
           / "group_states.cu").read_text()
    kernels = re.findall(r"template <([^>]*)>\s*__global__ void[^\n]*\n(\w+)\(([^)]*)\)",
                         src)
    names = {name for _, name, _ in kernels}
    assert names == {"group_ends_gemm_kernel", "group_solve_gemm_kernel",
                     "group_entry_gemm_kernel"}
    for params, name, args in kernels:
        assert "gemm" in name and "f64" not in name
        assert "double" not in params and "double" not in args


def test_cpu_state_solve_is_the_chain_it_was():
    """On a CPU tensor the EQ's state solve with the carry triangle (cat,
    frames and dynamic routes) is the dense product, the carry's product
    and the entry einsum, in that order, bit for bit; no kernel counted."""
    from dsp_audio_project_tpu_torch.ops.eq import (
        _carry_states, _true_states, block_tables,
    )

    G, K = 16, K_BLOCKS
    ops = static_ops(GAINS_D10, G)
    tables = block_tables(ops, "cpu", K)
    assert "carry_w" in tables
    inj = injections(G, False, 5, lead=(2, K))
    sigma0 = torch.ones(2, 10) * 0.25
    before = gs.group_ends.launches, gs.group_solve.launches
    got = _true_states(inj, tables, sigma0)
    s_in, end = gs.group_states_plain(inj, tables["group_toeplitz"])
    sigma = _carry_states(end, tables["state_corr"], tables["carry_w"], sigma0)
    want = (gs.group_entry_states_plain(s_in, sigma, tables["group_toeplitz"]),
            end, sigma)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (gs.group_ends.launches, gs.group_solve.launches) == before
    dyn = ted.DynOperators(*dynamic_operators_plain(
        torch.tensor((6.0, -3.0, 0.0, 12.0, -15.0, 4.0)),
        *map(torch.as_tensor, ted._band_trig(FS, EQConfig().band_centers,
                                             EQConfig().nyquist_safety)),
        EQConfig().q, EQConfig().bypass_threshold_db, U, G, K))
    inj12 = injections(G, True, 9, d=12, lead=(1, K))
    s_in, end = gs.group_states_plain(inj12, dyn.toe)
    assert torch.equal(ted._dyn_states(inj12, dyn), gs.group_entry_states_plain(
        s_in, _carry_states(end, dyn.A_blk, dyn.carry_w), dyn.toe))


def test_carry_route_wrappers_check_their_arguments():
    G, K, d = 4, 3, 2
    toe, carry_w = torch.eye(G * d), torch.eye(K * d)
    inj = torch.zeros(2, K, G, d)
    end, pre = gs.group_ends(inj, toe)
    assert end.shape == (2, K, d) and pre.shape == (2, K, 1, d)
    with pytest.raises(ValueError, match="end"):
        gs.group_solve(inj, toe, end[:, :2], pre, carry_w)
    with pytest.raises(ValueError, match="pre"):
        gs.group_solve(inj, toe, end, pre[..., :0, :], carry_w)
    with pytest.raises(ValueError, match="sigma0"):
        gs.group_solve(inj, toe, end, pre, carry_w, torch.zeros(3, d))
    with pytest.raises(ValueError, match="carry_w"):
        gs.group_solve(inj, toe, end, pre, carry_w[:-2, :-2])
    with pytest.raises(TypeError, match="float32"):
        gs.group_ends(inj.double(), toe)
    s_true, sigma = gs.group_solve(inj, toe, end, pre, carry_w)
    assert s_true.shape == inj.shape and sigma.shape == end.shape
