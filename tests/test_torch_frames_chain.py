"""The port's frames and flat forwards and pipe(x, fs) vs the JAX package and the oracle.

CPU, plain kernel versions, 1 s signals, batch 2 (0.5 s at the other
rates).  The JAX side runs its Pallas kernels in interpret mode at full
precision.  Tolerances: > 90 dB against the JAX forwards and against the
numpy oracle (z, y and the spectra), as slice 1 states for the cat chain —
both sides are float32 here and these inputs give well above that.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu_torch import oracle
from dsp_audio_project_tpu_torch.kernels import (
    launch_counts, reset_launch_counts,
)
from dsp_audio_project_tpu_torch.ops.spectrum import (
    spectrum_mag, spectrum_mag_frames,
)
from dsp_audio_project_tpu_torch.oracle import snr_db

torch.set_num_threads(2)

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


def make_x(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal((batch, n))
    return (x / np.abs(x).max()).astype(np.float32)


def port_pipe(L=160, M=147, gains=GAINS, **kernels):
    return pt.AudioPipeline(pt.PipelineConfig(
        src=pt.SRCConfig(L=L, M=M), eq=pt.EQConfig.from_gains(gains),
        kernels=pt.KernelConfig(**kernels)), device="cpu")


def jax_pipe(L=160, M=147, gains=GAINS, **kernels):
    return jpkg.AudioPipeline(jpkg.PipelineConfig(
        src=jpkg.SRCConfig(L=L, M=M), eq=jpkg.EQConfig.from_gains(gains),
        kernels=JKernelConfig(interpret=True, **kernels)))


def snr(a, b):
    return snr_db(np.asarray(a).ravel(), b.numpy().ravel())


def check_oracle(pipe, x, z, y, spectra=None):
    """z and y (flat) and the three spectra vs the numpy oracle: > 90 dB."""
    cfg = pipe.config
    for i in range(x.shape[0]):
        y_want, fs_out = oracle.resample_oracle(x[i], FS, cfg.src, "fast")
        z_want = oracle.equalize_oracle(y_want, fs_out, cfg.eq)
        assert snr_db(y_want, y[i].numpy()) > 90
        assert snr_db(z_want, z[i].numpy()) > 90
        if spectra is None:
            continue
        for sig, rate, mag in ((x[i], FS, spectra[0][i]),
                               (y_want, fs_out, spectra[1][i]),
                               (z_want, fs_out, spectra[2][i])):
            want = oracle.spectrum_oracle(sig, rate, cfg.spectrum)[1]
            assert snr_db(want, mag.numpy()) > 90


def test_forward_frames_spectra_matches_jax_and_oracle():
    x = make_x(2, FS, seed=1)
    jz, jy, jm = jax_pipe()._forward_frames_spectra(jnp.asarray(x), FS)
    pipe = port_pipe()
    reset_launch_counts()
    zf, yf, mags = pipe.forward_frames_spectra(torch.as_tensor(x), FS)
    assert launch_counts() == dict.fromkeys(launch_counts(), 0)  # CPU: plain
    assert zf.shape == jz.shape == yf.shape == (2, 1024, 160)
    assert snr(jz, zf) > 90 and snr(jy, yf) > 90
    for a, b in zip(jm, mags):
        assert b.shape == a.shape == (2, 1025)
        assert snr(a, b) > 90
    n_out = pipe.config.src.output_length(FS)
    check_oracle(pipe, x, zf.reshape(2, -1)[:, :n_out],
                 yf.reshape(2, -1)[:, :n_out], mags)
    zf2, yf2 = pipe.forward_frames(torch.as_tensor(x), FS)
    assert torch.equal(zf2, zf) and torch.equal(yf2, yf)
    # The one-signal spectrum ops give the stacked spectra.
    assert snr(mags[0].numpy(), spectrum_mag(torch.as_tensor(x))) > 120
    assert snr(mags[2].numpy(), spectrum_mag_frames(zf, n_out)) > 120


def test_call_matches_jax_frames_flat_and_oracle():
    """pipe(x, fs) takes the frames path on the CPU too (the JAX __call__
    does on its device): against _forward_frames_flat and the oracle."""
    x = make_x(2, FS, seed=2)
    jz, jy = jax_pipe()._forward_frames_flat(jnp.asarray(x), FS)
    pipe = port_pipe()
    out = pipe(x, FS, with_spectra=True)
    assert isinstance(out, pt.PipelineOutputs) and out.fs_out == 48000
    assert out.output.shape == jz.shape == (2, 48000)
    assert snr(jz, out.output) > 90 and snr(jy, out.resampled) > 90
    sp = out.spectra
    assert np.array_equal(sp["input"][0], np.fft.rfftfreq(2048, 1 / FS))
    assert np.array_equal(sp["output"][0], np.fft.rfftfreq(2048, 1 / 48000))
    check_oracle(pipe, x, out.output, out.resampled,
                 [sp[k][1] for k in ("input", "resampled", "output")])
    z, y = pipe.forward_frames_flat(x, FS)
    assert torch.equal(z, out.output) and torch.equal(y, out.resampled)


@pytest.mark.parametrize("fir_path", ["auto", "pallas"])
def test_flat_forwards_match_jax(fir_path):
    """forward_flat (K6) and _forward/forward_spectra (resample, or E1 with
    fir_path='pallas') against the JAX flat forwards."""
    x = make_x(2, FS, seed=3)
    jp, tp = jax_pipe(fir_path=fir_path), port_pipe(fir_path=fir_path)
    jz, jy = jp._forward(jnp.asarray(x), FS)
    z, y, mags = tp.forward_spectra(torch.as_tensor(x), FS)
    assert z.shape == jz.shape == (2, 48000)
    assert snr(jz, z) > 90 and snr(jy, y) > 90
    check_oracle(tp, x, z, y, mags)
    if fir_path == "auto":
        jz, jy, jm = jp._forward_flat_spectra(jnp.asarray(x), FS)
        zf, yf, mf = tp.forward_flat_spectra(torch.as_tensor(x), FS)
        assert snr(jz, zf) > 90 and snr(jy, yf) > 90
        for a, b in zip(jm, mf):
            assert snr(a, b) > 90
        assert snr(z.numpy(), zf) > 120     # flat path == resample path
    else:
        out = tp(x, FS)                     # an explicit path: no frames
        assert torch.equal(out.output, z)


@pytest.mark.parametrize("L,M", [(441, 480), (147, 160)])
def test_other_rates_call_matches_oracle(L, M):
    x = make_x(1, FS // 2, seed=L)
    pipe = port_pipe(L, M)
    out = pipe(x, FS)
    check_oracle(pipe, x, out.output, out.resampled)


def test_supported_predicates_agree_with_jax():
    for L, M in [(160, 147), (441, 480), (320, 441), (147, 160), (3, 2),
                 (1, 1)]:
        for n in (FS, 20):
            jp, tp = jax_pipe(L, M), port_pipe(L, M)
            assert tp.frames_supported(n) == jp.frames_supported(n), (L, M, n)
            assert tp.flat_supported(n) == jp.flat_supported(n), (L, M, n)


def test_short_narrow_and_bypass_calls_match_jax():
    """Inputs the frames path does not cover go through _forward, as in
    the JAX __call__: a short signal, an s < 8 plan and SRC bypass; an EQ
    bypass on the frames path returns y unclipped."""
    for (L, M), n, gains in (((160, 147), 30, GAINS), ((3, 2), 4000, GAINS),
                             ((1, 1), 3000, GAINS), ((160, 147), 3000, {})):
        x = 1.5 * make_x(1, n, seed=n)
        jz, jy = jax_pipe(L, M, gains)._forward(jnp.asarray(x), FS)
        out = port_pipe(L, M, gains)(x, FS)
        assert out.output.shape == jz.shape
        assert np.max(np.abs(np.asarray(jz) - out.output.numpy())) < 1e-5
        assert np.max(np.abs(np.asarray(jy) - out.resampled.numpy())) < 1e-5
    assert torch.equal(out.output, out.resampled)     # EQ bypass: unclipped
    assert out.output.abs().max() > 1


def test_process_matches_jax():
    x = make_x(1, FS // 2, seed=5)[0]
    cfg = port_pipe().config
    z, fs_out = pt.process(x, FS, cfg, device="cpu")
    jz, jfs = jpkg.process(jnp.asarray(x), FS, jax_pipe().config)
    assert fs_out == jfs == 48000
    assert z.shape == jz.shape
    assert snr(jz, z) > 90


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.AudioPipeline(pt.PipelineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.process(np.zeros(100, np.float32), FS)


def test_iir_pallas_raises():
    """iir_path='pallas' (E2, once unported and raising) now runs the
    block-IIR route: against the JAX flat forward and the oracle (> 90 dB),
    and an unknown path name still raises."""
    x = make_x(1, 4000, seed=6)
    jz, jy = jax_pipe(iir_path="pallas", iir_block=1024)._forward(
        jnp.asarray(x), FS)
    pipe = port_pipe(iir_path="pallas", iir_block=1024)
    out = pipe(x, FS)
    assert out.output.shape == jz.shape
    assert snr(jz, out.output) > 90 and snr(jy, out.resampled) > 90
    check_oracle(pipe, x, out.output, out.resampled)
    with pytest.raises(ValueError, match="iir_path"):
        port_pipe(iir_path="triton")(x, FS)
