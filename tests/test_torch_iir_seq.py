"""E7, the one-sweep flat EQ (``equalize_seq_flat``): port vs the JAX kernel and the oracle.

CPU, the plain version; the JAX kernel runs in interpret mode with
``fast=False`` (its f32 form: the port is f32 throughout, and the JAX
bf16x3 FIR product alone sits near 100 dB from the f32 one).  Block 1024,
unroll 64 (G = 16 groups), ``super_blocks=2``, two rows of two super-blocks
each, so the carry crosses blocks and resets between rows.  Tolerances:
>= 100 dB against the JAX kernel (float32 sums of the same tables in other
orders; ~125 dB here) and >= 60 dB against the numpy oracle (the reference
contract; the JAX test measures ~105 dB).  The CUDA kernel is compared with
the plain version on the card in tests/test_torch_gpu.py and chip_smoke.py.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.kernels.experiments.iir_seq import (
    equalize_seq_flat as jequalize_seq_flat,
)
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu_torch import oracle
from dsp_audio_project_tpu_torch.kernels.experiments.iir_seq import (
    equalize_seq_flat,
)
from dsp_audio_project_tpu_torch.ops import eq as teq
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

FS = 48000
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15}
BLOCK, UNROLL, SB = 1024, 64, 2


def make_rows(rows, n):
    rng = np.random.default_rng(21)
    t = np.arange(n) / FS
    x = 0.4 * np.sin(2 * np.pi * 60 * t) + 0.3 * rng.standard_normal((rows, n))
    return (x / np.abs(x).max()).astype(np.float32)


def operators():
    cfg = pt.EQConfig.from_gains(GAINS)
    bands = cfg.active_bands(FS)
    return (jeq.make_block_operators(bands, FS, cfg.q, BLOCK, UNROLL),
            teq.make_block_operators(bands, FS, cfg.q, BLOCK, UNROLL), cfg)


def test_matches_jax_kernel_and_oracle():
    jops, tops, cfg = operators()
    x = make_rows(2, 2 * SB * BLOCK)
    want = np.asarray(jequalize_seq_flat(jnp.asarray(x), jops, super_blocks=SB,
                                         fast=False, interpret=True))
    got = equalize_seq_flat(torch.as_tensor(x), tops, super_blocks=SB)
    assert got.shape == want.shape == x.shape
    assert snr_db(want.ravel(), got.numpy().ravel()) > 100
    for i in range(2):        # the second row starts from a zero state
        assert snr_db(oracle.equalize_oracle(x[i], FS, cfg), got[i].numpy()) > 60
    # ``fast`` has no effect (f32 throughout), and a row alone gives the
    # same samples: the state resets for every row.
    assert torch.equal(got, equalize_seq_flat(torch.as_tensor(x), tops,
                                              super_blocks=SB, fast=False))
    one = equalize_seq_flat(torch.as_tensor(x[1:]), tops, super_blocks=SB)
    assert snr_db(got[1].numpy(), one[0].numpy()) > 140


def test_leading_axes_and_length_rule():
    _, tops, _ = operators()
    x = make_rows(4, SB * BLOCK)
    flat = equalize_seq_flat(torch.as_tensor(x), tops, super_blocks=SB)
    nested = equalize_seq_flat(torch.as_tensor(x.reshape(2, 2, -1)), tops,
                               super_blocks=SB)
    assert nested.shape == (2, 2, SB * BLOCK)
    assert torch.equal(nested.reshape(4, -1), flat)
    with pytest.raises(ValueError, match="multiple of 2\\*1024"):
        equalize_seq_flat(torch.zeros(2, 3 * BLOCK), tops, super_blocks=SB)
    with pytest.raises(ValueError, match="multiple of 10\\*1024"):
        equalize_seq_flat(torch.zeros(SB * BLOCK), tops)
    with pytest.raises(TypeError):
        equalize_seq_flat(torch.zeros(SB * BLOCK, dtype=torch.float64), tops,
                          super_blocks=SB)
