"""The port's dynamic-gain forwards (``AudioPipeline.forward_*_dynamic*``)
vs each other, the JAX package and the oracle, on the CPU (plain kernel
versions).

Tolerances: the cat path >= 110 dB against the frames path (the same
operators; K1's G2 folds the EQ's first product into the SRC operator, so
the sums run in another order); the port's frames forward >= 120 dB
against the JAX ``jit_forward_frames_dynamic_ops`` in interpret mode on
the same host-built operators (bit-equal float64 tables; float32 products
in other orders) and > 95 dB against the oracle (the JAX test's gate);
``forward_frames_dynamic`` >= 130 dB against ``forward_frames_dynamic_ops``
on the device builder (the same algebra, to accumulation order).  The JAX
traced builder is not called (minutes to compile on a CPU).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu_torch.kernels.fir_class import cat_operator
from dsp_audio_project_tpu_torch.oracle import pipeline_oracle, snr_db

from conftest import make_test_signal

torch.set_num_threads(2)

FS = 44100
N = 30000
GAINS = (5.0, 0.0, -7.0, 2.0, 0.0, 9.0)
NAMES = [n for n, _ in pt.EQConfig().band_centers]
SRC = pt.SRCConfig(L=160, M=147)


def port_pipe():
    return pt.AudioPipeline(pt.PipelineConfig(src=SRC, eq=pt.EQConfig()),
                            device="cpu")


def crop(frames, n_out):
    return frames.reshape(-1)[:n_out]


@pytest.fixture(scope="module")
def frames_case():
    """The port's and the JAX package's dynamic frames forward on the same
    host-built operators, at the JAX tests' size (n = 30000)."""
    x = make_test_signal(N, FS, seed=31)
    jp = jpkg.AudioPipeline(jpkg.PipelineConfig(
        src=jpkg.SRCConfig(L=160, M=147), eq=jpkg.EQConfig(),
        kernels=JKernelConfig(interpret=True)))
    jops = jp.dynamic_eq_operators(np.asarray(GAINS), FS, N)
    jz, _ = jp.jit_forward_frames_dynamic_ops()(jnp.asarray(x), jops, FS)
    pipe = port_pipe()
    ops = pipe.dynamic_eq_operators(np.asarray(GAINS), FS, N)
    z, y = pipe.forward_frames_dynamic_ops(torch.as_tensor(x), ops, FS)
    return x, np.asarray(jz), z, y, pipe, ops


def test_frames_dynamic_matches_jax(frames_case):
    _, jz, z, y, _, _ = frames_case
    assert z.shape == y.shape == jz.shape
    assert snr_db(jz.ravel(), z.numpy().ravel()) >= 120


def test_frames_dynamic_matches_oracle(frames_case):
    x, _, z, _, _, _ = frames_case
    want, _ = pipeline_oracle(x, FS, SRC,
                              pt.EQConfig.from_gains(dict(zip(NAMES, GAINS))),
                              engine="fast")
    q = snr_db(want, crop(z, SRC.output_length(N)).numpy())
    assert q > 95, f"{q:.1f} dB"


def test_cat_dynamic_matches_frames_dynamic(frames_case):
    x, _, zf, _, pipe, ops = frames_case
    zc = pipe.forward_cat_dynamic_ops(torch.as_tensor(x), ops,
                                      pipe.dynamic_cat_tables(ops), FS)
    assert zc.shape == zf.shape
    n_out = SRC.output_length(N)
    assert snr_db(crop(zf, n_out).numpy(), crop(zc, n_out).numpy()) >= 110


def test_cat_table_is_the_static_host_fold(frames_case):
    """G2 = G @ [fir_t | group_in] composed on the device in float64 equals
    the static path's host fold of the same float32 tables to one float32
    rounding."""
    _, _, _, _, pipe, ops = frames_case
    g2 = pipe.dynamic_cat_tables(ops).g2
    w_cat = torch.cat([ops.fir_t, ops.group_in], 1).double().numpy()
    want = cat_operator(pipe._plan().G, w_cat)
    assert g2.shape == want.shape == (pipe._plan().W, 172)
    np.testing.assert_allclose(g2.numpy(), want, rtol=2 ** -23,
                               atol=2 ** -23 * np.abs(want).max())


def test_frames_dynamic_inline_matches_ops():
    x = torch.as_tensor(make_test_signal(N, FS, seed=23))
    pipe = port_pipe()
    gains = torch.tensor(GAINS)
    z_inline, y_inline = pipe.forward_frames_dynamic(x, gains, FS)
    ops = pipe.dynamic_eq_operators(gains, FS, N, builder="traced")
    z_ops, y_ops = pipe.forward_frames_dynamic_ops(x, ops, FS)
    assert torch.equal(y_inline, y_ops)
    n_out = SRC.output_length(N)
    assert snr_db(crop(z_inline, n_out).numpy(),
                  crop(z_ops, n_out).numpy()) >= 130


def test_builder_auto_picks_host_for_arrays_and_traced_for_tensors():
    pipe = port_pipe()
    g = np.asarray(GAINS)
    ops = {b: pipe.dynamic_eq_operators(g, FS, N, builder=b)
           for b in ("host", "traced")}
    for gains, want in ((g, "host"), (list(GAINS), "host"),
                        (torch.tensor(GAINS), "traced")):
        got = pipe.dynamic_eq_operators(gains, FS, N)
        for name, t in got._asdict().items():
            assert torch.equal(t, getattr(ops[want], name)), (want, name)
    # The two builders are two realizations: their state tables differ.
    assert not torch.equal(ops["host"].group_in, ops["traced"].group_in)
    with pytest.raises(ValueError):
        pipe.dynamic_eq_operators(g, FS, N, builder="jit")


def test_geometry_matches_the_frames_grid():
    pipe = port_pipe()
    U, G, K = pipe.dynamic_eq_geometry(FS, N)
    assert (U, G) == (160, 128)
    assert K == 8          # ceil(32653 / 160) = 205 frames -> 1024 padded
    assert pipe.dynamic_eq_geometry(FS, int(60 * FS)) == (160, 128, 144)
