"""The block-IIR kernels' group algebra (``kernels/experiments/iir_group.py``)
against the JAX kernels E2a, E2b, E7 and the port's plain versions.

The CUDA body (``csrc/iir_block.cu``) cannot run here; its torch mirror
repeats its arithmetic: its own tables at the kernel's group length
(U = 128, whatever ``ops.unroll`` is), the two-level Horner pass over the
groups, the
ragged last group (A^r and the injection table's last r rows; the product
and readout cut to r samples) and E7's fixed-window look-back.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do.
Tolerances: end states within atol 2e-5 (as tests/test_torch_iir.py holds
the port to the JAX kernel); outputs > 100 dB against the JAX kernels and
the plain versions (float32 sums of the same algebra in other orders);
the look-back's sigma within 1e-5 * max|sigma| of the sequential carry.
The kernel itself is held against the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.kernels.experiments.iir import (
    block_apply as jblock_apply,
    block_end_states as jblock_end_states,
)
from dsp_audio_project_tpu.kernels.experiments.iir_seq import (
    equalize_seq_flat as jequalize_seq_flat,
)
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu_torch.kernels.experiments import iir, iir_group
from dsp_audio_project_tpu_torch.kernels.experiments import iir_seq
from dsp_audio_project_tpu_torch.ops import eq as teq
from dsp_audio_project_tpu_torch.oracle import snr_db
from dsp_audio_project_tpu_torch.utils.device import device_tables

torch.set_num_threads(2)

FS = 48000
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}
ORDERS = {2: {"Bass": 5}, 10: GAINS, 12: {**GAINS, "Low Mids": 2}}


def operators(gains, block, unroll=16):
    cfg = pt.EQConfig.from_gains(gains)
    bands = cfg.active_bands(FS)
    return (jeq.make_block_operators(bands, FS, cfg.q, block, unroll),
            teq.make_block_operators(bands, FS, cfg.q, block, unroll))


def signal(shape, seed):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    t = np.arange(n) / FS
    x = 0.4 * np.sin(2 * np.pi * 60 * t) + 0.3 * rng.standard_normal(shape)
    return (x / np.abs(x).max()).astype(np.float32)


@pytest.mark.parametrize("d", sorted(ORDERS))
@pytest.mark.parametrize("block", [128, 130, 256])
def test_tables_are_the_group_identities(d, block):
    """h is group_fir's Toeplitz column, gin / gout / A^U the design's
    group tables at U = 128, A^r the ragged group's step; the flat table
    has the kernel's TabLayout length."""
    _, ops = operators(ORDERS[d], block)
    U = iir_group.GROUP
    tab = iir_group.group_tables(ops, block, U, 4)
    G, r = iir_group.groups(block)
    assert (G, r) == (-(-block // U), block - (G - 1) * U)
    A = np.asarray(ops.A)
    Apow = [np.linalg.matrix_power(A, j) for j in range(U + 1)]
    h = [ops.D] + [ops.C @ Apow[k - 1] @ ops.B for k in range(1, U)]
    np.testing.assert_allclose(tab["h"], np.float32(h), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(
        tab["gin"], np.stack([Apow[U - 1 - v] @ ops.B for v in range(U)]),
        rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        tab["gout"], np.stack([ops.C @ Apow[u] for u in range(U)], axis=1),
        rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(tab["au"], Apow[U], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(tab["ar"], Apow[r], rtol=1e-5, atol=1e-8)
    ablk = np.linalg.matrix_power(A, block)
    np.testing.assert_allclose(tab["pw"][1], ablk, rtol=1e-5, atol=1e-8)
    assert np.array_equal(tab["pw"][0], np.eye(d, dtype=np.float32))
    assert tab["pows"].shape == (G, d, d)
    gs = -(-d // 4) * 4
    want = U + U * gs + d * U + 2 * d * d + 5 * d * d + G * d * d
    assert iir_group.flat_table(tab).shape == (want,)


@pytest.mark.parametrize("d", sorted(ORDERS))
@pytest.mark.parametrize("block", [128, 130, 256])
def test_mirror_matches_jax_e2_and_plain(d, block):
    """E2a and E2b at unroll 16 (the kernel groups at 128: blocks 128 and
    256 whole, 130 with a ragged group of 2): the mirror against the JAX
    kernels (interpret mode) and the port's plain versions."""
    jops, ops = operators(ORDERS[d], block)
    K = 5
    xb = signal((2, K * block), seed=block + d).reshape(2, K, block)
    tab = iir_group.group_tables(ops, block)
    e_m = iir_group.mirror_end_states(torch.as_tensor(xb), tab)
    e_j = np.asarray(jblock_end_states(jnp.asarray(xb), jops, interpret=True))
    e_p = iir.block_end_states(torch.as_tensor(xb), ops)
    assert e_m.shape == e_j.shape == (2, K, d)
    np.testing.assert_allclose(e_m.numpy(), e_j, atol=2e-5)
    np.testing.assert_allclose(e_m.numpy(), e_p.numpy(), atol=2e-5)
    sigma = np.random.default_rng(d).standard_normal(e_j.shape).astype(
        np.float32)
    y_m = iir_group.mirror_apply(torch.as_tensor(xb), torch.as_tensor(sigma),
                                 tab)
    y_j = np.asarray(jblock_apply(jnp.asarray(xb), jnp.asarray(sigma), jops,
                                  interpret=True))
    y_p = iir.block_apply(torch.as_tensor(xb), torch.as_tensor(sigma), ops)
    assert y_m.shape == y_j.shape == xb.shape
    assert snr_db(y_j.ravel(), y_m.numpy().ravel()) > 100
    assert snr_db(y_p.numpy().ravel(), y_m.numpy().ravel()) > 100


@pytest.mark.parametrize("d", sorted(ORDERS))
@pytest.mark.parametrize("G,chunk,segs", [(150, 64, None), (150, 150, None),
                                          (7, 64, 16), (64, 64, 3), (5, 64, 4)])
def test_segmented_horner_is_horner(d, G, chunk, segs):
    """The kernel's two-level Horner pass (chunks of groups, 32 // d
    segments a chunk from a zero state each, their entry states chained
    through A^{LU}, each group's state corrected by A^{(g - jL)U} T_j)
    against the one-segment pass: the same entry and end states."""
    block = G * iir_group.GROUP - 5                    # a ragged last group
    _, ops = operators(ORDERS[d], 128)                 # the system only
    tab = iir_group.group_tables(ops, block)
    rng = np.random.default_rng(G + d)
    inj = torch.as_tensor(rng.standard_normal((2, G, d)).astype(np.float32))
    s0 = torch.as_tensor(rng.standard_normal((2, d)).astype(np.float32))
    st1, end1 = iir_group.mirror_horner(inj, s0, tab, chunk=G, segs=1)
    st, end = iir_group.mirror_horner(inj, s0, tab, chunk=chunk, segs=segs)
    top = float(st1.abs().max())
    assert float((st - st1).abs().max()) <= 1e-5 * top
    assert float((end - end1).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("window", [1, 4, 16])
@pytest.mark.parametrize("K", [3, 20])
def test_lookback_is_the_sequential_carry(window, K):
    """The fixed window's sigma_k equals the sequential carry sigma_{k+1}
    = A_blk sigma_k + agg_k of ``equalize_seq_plain`` (K < W included):
    the same identity, summed in another order."""
    block = 1024
    _, ops = operators(GAINS, block, 64)
    tab = iir_group.group_tables(ops, block, window=window)
    agg = torch.as_tensor(
        np.random.default_rng(K).standard_normal((3, K, 10)).astype(
            np.float32))
    got = iir_group.lookback(agg, torch.as_tensor(tab["pw"]), window)
    ablk = torch.as_tensor(np.asarray(ops.state_corr, np.float32))
    sig, want = agg.new_zeros((3, 10)), []
    for k in range(K):
        want.append(sig)
        sig = sig @ ablk.t() + agg[:, k]
    want = torch.stack(want, dim=1)
    assert torch.equal(got[:, 0], torch.zeros_like(got[:, 0]))
    top = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * top
    if window == 1:                        # the one-term window is the chain
        assert float((got - want).abs().max()) <= 1e-6 * top


@pytest.mark.parametrize("window", [1, 4, 16])
def test_mirror_matches_jax_e7_and_plain(window):
    """E7 at block 1024, unroll 64, super_blocks 2, two rows of four blocks:
    the mirror (its look-back at W) against the JAX kernel (fast=False,
    interpret mode) and the port's plain version."""
    block, unroll, sb = 1024, 64, 2
    jops, ops = operators(GAINS, block, unroll)
    x = signal((2, 2 * sb * block), seed=21)
    want = np.asarray(jequalize_seq_flat(jnp.asarray(x), jops, super_blocks=sb,
                                         fast=False, interpret=True))
    tab = iir_group.group_tables(ops, block, window=window)
    got = iir_group.mirror_seq(torch.as_tensor(x).reshape(2, -1, block), tab,
                               window).reshape(x.shape)
    assert snr_db(want.ravel(), got.numpy().ravel()) > 100
    plain = iir_seq.equalize_seq_flat(torch.as_tensor(x), ops,
                                      super_blocks=sb)
    assert snr_db(plain.numpy().ravel(), got.numpy().ravel()) > 100


def test_rows_launchers_on_the_cpu_are_the_padded_plain_path():
    """``end_states_rows`` / ``apply_rows`` (what ``equalize_pallas`` calls)
    on a CPU tensor: the plain versions on the zero-padded blocks, the
    output clipped and cropped to n; no launch is counted."""
    block = 256
    _, ops = operators(GAINS, block)
    x = torch.as_tensor(1.5 * signal((2, 1000), seed=4))
    before = (iir.block_end_states.launches, iir.block_apply.launches)
    e = iir.end_states_rows(x, block, ops)
    xb = torch.nn.functional.pad(x, (0, 24)).reshape(2, 4, block)
    assert torch.equal(e, iir.block_end_states(xb, ops))
    sigma = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 4, 10)).astype(np.float32))
    y = iir.apply_rows(x, sigma, block, ops)
    want = iir.block_apply(xb, sigma, ops).reshape(2, -1)[:, :1000]
    assert torch.equal(y, torch.clamp(want, -1.0, 1.0))
    assert (iir.block_end_states.launches, iir.block_apply.launches) == before
    a_t, b, _, _ = device_tables(iir._plain_consts, ops, device="cpu")
    assert a_t.shape == (10, 10) and b.shape == (10,)
