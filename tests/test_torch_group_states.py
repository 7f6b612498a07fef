"""The state solve's kernel module (kernels/group_states.py) on the CPU,
where the wrappers run their plain versions.

* Every group Toeplitz table of the port is block-lower-triangular
  Toeplitz bit for bit: block (j, g) is the first block row's tap T_{g-j}
  for j <= g and zero above (the static tables of ``make_block_operators``
  at d = 10 and 12, the dynamic ones of ``dynamic_operators_plain``), and
  the taps are group_pows transposed.  The kernel reads only the taps.
* ``group_states_mirror``, the kernel's scan step by step, against
  the plain dense product (> 120 dB and max abs err <= 1e-5 * max|ref|)
  and against the JAX package's ``_grouped_states`` on the same seeded
  numpy input (>= 110 dB), at chunks c in {1, 4, 8, 16, 32, G} (the
  kernel's is 4), G in {1, 16, 100, 128, 300} (ragged chunks and tiles)
  and on a strided view.
* The wrappers' CPU route is the plain version; the entry states' plain
  version equals the einsum against group_pows it replaced, bit for bit;
  the wrappers' argument checks raise.

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
    """One tile of 128 groups in 32 chunks of 4: the triangles' 6 taps a
    chunk, the scan's 31 + 30 + 28 + 24 + 16 chunk steps and the 124
    entering states past the first chunk; each tile after adds its carry
    and its first chunk's four."""
    assert gs.chunk_multiply_adds(128, 10) == (192 + 129 + 124) * 100
    assert gs.chunk_multiply_adds(256, 2) == (2 * 445 + 5) * 4
    assert gs.chunk_multiply_adds(1, 12) == 445 * 144


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
