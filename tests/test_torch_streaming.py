"""The port's ``StreamProcessor``, ``equalize_stream`` and ``StreamState``
against the JAX package's, on the CPU (plain kernel versions), on the same
seeded inputs.

Tolerances: the port's stream vs the JAX stream atol=5e-5 on every chunking
(the JAX test's own tolerance against its one-shot chain); the EQ carry
state after ``equalize_stream`` rtol=1e-4, atol=1e-6 (the JAX package runs
a ragged tail as a per-sample float32 scan, the port as group algebra), its
output atol=5e-5; the short stream atol=1e-5 (the JAX test's); bypass
bit for bit.  A blob from either package resumes in the other (atol=5e-5
against the JAX package's uninterrupted run); the port's own resume is bit
for bit.
"""
from __future__ import annotations

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu.ops import eq as jeq
from dsp_audio_project_tpu.streaming import (
    StreamProcessor as JStreamProcessor,
    StreamState as JStreamState,
)
from dsp_audio_project_tpu_torch.ops import eq as teq

from conftest import make_test_signal

torch.set_num_threads(2)

FS = 44100


def configs(L, M, gains, iir_block=None):
    """The same PipelineConfig in both packages."""
    jk = {} if iir_block is None else {"iir_block": iir_block}
    return (
        jpkg.PipelineConfig(src=jpkg.SRCConfig(L=L, M=M),
                            eq=jpkg.EQConfig.from_gains(gains),
                            kernels=JKernelConfig(**jk)),
        pt.PipelineConfig(src=pt.SRCConfig(L=L, M=M),
                          eq=pt.EQConfig.from_gains(gains),
                          kernels=pt.KernelConfig(**jk)),
    )


def run_stream(sp, x, chunks):
    outs, pos = [], 0
    for c in chunks:
        outs.append(sp.process(x[pos : pos + c]))
        pos += c
    assert pos == len(x)
    outs.append(sp.flush())
    return np.concatenate([o for o in outs if len(o)])


def port_stream(cfg, state=None):
    return pt.StreamProcessor(cfg, FS, state=state, device="cpu")


@pytest.mark.parametrize("chunking", [
    [16384], [5000, 5000, 6384], [100, 16000, 284], [8192, 8192],
])
@pytest.mark.parametrize("L,M", [(3, 2), (1, 2), (2, 1), (160, 147)])
def test_stream_matches_jax(chunking, L, M):
    x = make_test_signal(16384, FS, seed=21)
    jcfg, cfg = configs(L, M, {"Bass": 6, "Presence": -4}, iir_block=256)
    want = run_stream(JStreamProcessor(jcfg, FS), x, chunking)
    got = run_stream(port_stream(cfg), x, chunking)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("n", [1, 127, 129, 1023, 1024, 2 * 1024 + 129])
def test_equalize_stream_matches_jax(n):
    """Output and state at ragged lengths 1, U-1, U+1 and block-1 (U = 128,
    block = 1024), a whole block and a ragged multi-block chunk, from a
    nonzero incoming state, two rows."""
    fs, block = 48000, 1024
    gains = {"Sub-Bass": 8, "Bass": 6, "Presence": -4}
    rng = np.random.default_rng(n)
    x = np.stack([make_test_signal(max(n, 2), fs, seed=n)[:n] * 0.9,
                  rng.uniform(-0.9, 0.9, n).astype(np.float32)])
    s0 = (0.1 * rng.standard_normal((2, 6))).astype(np.float32)
    jz, js = jeq.equalize_stream(jnp.asarray(x), fs,
                                 jpkg.EQConfig.from_gains(gains),
                                 jnp.asarray(s0), block=block)
    z, s = teq.equalize_stream(torch.as_tensor(x), fs,
                               pt.EQConfig.from_gains(gains), s0,
                               block=block, device="cpu")
    assert z.shape == x.shape and s.shape == (2, 6)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), atol=5e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-6)


def test_equalize_stream_chunks_equal_one_pass():
    """Chunks of any sizes through equalize_stream == one equalize call
    (the port's own one-shot EQ at the same block); final_state is the
    chunked stream's end state."""
    fs, block = 48000, 1024
    cfg = pt.EQConfig.from_gains({"Bass": 6, "High Mids": -4})
    x = torch.as_tensor(make_test_signal(9000, fs, seed=4))
    want = pt.equalize(x, fs, cfg, block=block, device="cpu")
    state, parts, pos = None, [], 0
    for c in (1, 127, 1024, 3000, 4848):
        z, state = teq.equalize_stream(x[pos : pos + c], fs, cfg, state,
                                       block=block)
        parts.append(z)
        pos += c
    np.testing.assert_allclose(torch.cat(parts).numpy(), want.numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(
        teq.final_state(x, fs, cfg, block=block).numpy(), state.numpy(),
        rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError):
        teq._equalize_blocks(x[:1000], teq.block_tables(
            teq.make_block_operators(cfg.active_bands(fs), fs, cfg.q,
                                     block, 128), "cpu", 1),
            block, with_state=True)


def test_equalize_stream_bypass_and_no_band():
    fs = 48000
    x = torch.as_tensor(3.0 * make_test_signal(500, fs, seed=2))
    z, s = teq.equalize_stream(x, fs, pt.EQConfig())
    assert z is x and s.shape == (0,)
    # An active request whose only band clamps away (centre below the
    # 10 Hz floor) still clips, with an empty state, as in the JAX package.
    bands = {"gains_db": (("Sub-Bass", 6.0),),
             "band_centers": (("Sub-Bass", 5.0),)}
    z, s = teq.equalize_stream(x, fs, pt.EQConfig(**bands))
    jz, js = jeq.equalize_stream(jnp.asarray(x.numpy()), fs,
                                 jpkg.EQConfig(**bands))
    assert s.shape == js.shape == (0,)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    assert float(z.abs().max()) == 1.0


def test_stream_state_bytes_match_jax():
    fields = dict(samples_in=123, frames_done=7,
                  src_carry=np.arange(5, dtype=np.float32),
                  eq_state=np.ones((2, 4), dtype=np.float32), fs=48000,
                  d=4, gains_db=[1.0, -2.5])
    blob = pt.StreamState(**fields).to_bytes()
    assert blob == JStreamState(**fields).to_bytes()
    back = pt.StreamState.from_bytes(blob)
    assert (back.samples_in, back.frames_done, back.fs, back.d,
            back.gains_db) == (123, 7, 48000, 4, [1.0, -2.5])
    np.testing.assert_array_equal(back.src_carry, fields["src_carry"])
    np.testing.assert_array_equal(back.eq_state, fields["eq_state"])
    # A payload from before the d / gains_db fields still loads.
    old = dict(samples_in=1, frames_done=0, fs=44100)
    head = json.dumps(old).encode()
    buf = io.BytesIO()
    buf.write(len(head).to_bytes(4, "little"))
    buf.write(head)
    np.save(buf, np.zeros(3, np.float32), allow_pickle=False)
    np.save(buf, np.zeros(0, np.float32), allow_pickle=False)
    st = pt.StreamState.from_bytes(buf.getvalue())
    assert st.d is None and st.gains_db is None and st.samples_in == 1


@pytest.fixture(scope="module")
def resume_case():
    """The JAX test's checkpoint config (2/3, Sub-Bass +8), 20000 samples
    split at 11000, and the JAX package's uninterrupted run."""
    x = make_test_signal(20000, FS, seed=9)
    jcfg, cfg = configs(2, 3, {"Sub-Bass": 8})
    want = run_stream(JStreamProcessor(jcfg, FS), x, [11000, 9000])
    return x, jcfg, cfg, want


def test_jax_blob_resumes_in_port(resume_case):
    x, jcfg, cfg, want = resume_case
    sj = JStreamProcessor(jcfg, FS)
    part1 = sj.process(x[:11000])
    sp = pt.StreamProcessor.resume(cfg, sj.state_bytes(), device="cpu")
    got = np.concatenate([part1, sp.process(x[11000:]), sp.flush()])
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_port_blob_resumes_in_jax(resume_case):
    x, jcfg, cfg, want = resume_case
    sp = port_stream(cfg)
    part1 = sp.process(x[:11000])
    blob = sp.state_bytes()
    assert isinstance(blob, bytes) and len(blob) < 100_000
    sj = JStreamProcessor.resume(jcfg, blob)
    got = np.concatenate([part1, sj.process(x[11000:]), sj.flush()])
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_port_resume_is_bit_for_bit(resume_case):
    x, _, cfg, _ = resume_case
    full = run_stream(port_stream(cfg), x, [11000, 9000])
    sp1 = port_stream(cfg)
    part1 = sp1.process(torch.as_tensor(x[:11000]))     # a tensor chunk
    sp2 = pt.StreamProcessor.resume(cfg, sp1.state_bytes(), device="cpu")
    got = np.concatenate([part1, sp2.process(x[11000:]), sp2.flush()])
    np.testing.assert_array_equal(got, full)
    with pytest.raises(ValueError):
        pt.StreamProcessor(cfg, 48000, state=sp1.state, device="cpu")


def test_short_stream_matches_jax():
    """A stream shorter than the SRC filter: the one-shot geometry at
    flush."""
    x = make_test_signal(40, FS, seed=2)
    jcfg, cfg = configs(3, 4, {})
    want, _ = jpkg.process(x, FS, jcfg)
    got = run_stream(port_stream(cfg), x, [25, 15])
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got, run_stream(JStreamProcessor(jcfg, FS), x, [25, 15]), atol=1e-5)


def test_bypass_streams():
    """Whole bypass returns the input; SRC bypass runs the EQ alone; EQ
    bypass returns the SRC output unclipped."""
    x = make_test_signal(5000, FS, seed=1)
    got = run_stream(port_stream(pt.PipelineConfig()), x, [2500, 2500])
    np.testing.assert_array_equal(got, x)

    jcfg, cfg = configs(1, 1, {"Bass": 6, "Presence": -9}, iir_block=1024)
    np.testing.assert_allclose(
        run_stream(port_stream(cfg), x, [1, 3000, 1999]),
        run_stream(JStreamProcessor(jcfg, FS), x, [1, 3000, 1999]),
        atol=5e-5)

    loud = 3.0 * x
    jcfg, cfg = configs(3, 2, {})
    got = run_stream(port_stream(cfg), loud, [2000, 3000])
    want = run_stream(JStreamProcessor(jcfg, FS), loud, [2000, 3000])
    assert np.abs(got).max() > 1.5
    np.testing.assert_allclose(got, want, atol=5e-5)
