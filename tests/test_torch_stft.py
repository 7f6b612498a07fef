"""The analysis entry points vs the JAX package and the oracle, and the device rule.

CPU, plain kernel versions, 2 signals of 1 s (1.6 s for the nfft = 32768
spectra, so that the centre window fits and the reference's segment rule
holds).  The JAX side runs its XLA butterfly (its kernels are TPU-only on
that route).  Tolerances: max abs error < 1e-5 * max|X| against the JAX
ops and against float64 numpy (fp32 FFTs of at most 32768 points on both
sides); > 90 dB against the numpy oracle, as the chain tests state.  The
device rule: each entry point sends a numpy input to the card and raises
without one, keeps a tensor on its device, and runs on the CPU when asked.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu.ops import spectrum as jspectrum
from dsp_audio_project_tpu_torch import oracle
from dsp_audio_project_tpu_torch.ops.fft import _rfft_kernel_plan
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


def rel_err(want, got) -> float:
    want = np.asarray(want)
    return float(np.abs(want - np.asarray(got)).max() / np.abs(want).max())


def numpy_stft(x, nfft, hop, pad_end):
    """float64 reference: Hann-windowed hop-strided frames, np.fft.rfft."""
    n = x.shape[-1]
    frames = -(-n // hop) if pad_end else max(0, (n - nfft) // hop + 1)
    xp = np.pad(x.astype(np.float64), ((0, 0), (0, frames * hop + nfft)))
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / (nfft - 1))
    return np.fft.rfft(xp[:, idx] * win, axis=-1)


@pytest.mark.parametrize("pad_end", [True, False])
@pytest.mark.parametrize("nfft,hop", [(2048, 512), (16384, 4096)])
def test_stft_matches_jax_and_numpy(nfft, hop, pad_end):
    x = make_x(2, FS, seed=nfft + pad_end)
    kind = "four_step" if nfft == 2048 else "tall"     # K2 complex / K7
    assert _rfft_kernel_plan(nfft)[0] == kind
    want = np.asarray(jspectrum.stft(jnp.asarray(x), nfft=nfft, hop=hop,
                                     pad_end=pad_end))
    got = pt.stft(x, nfft=nfft, hop=hop, pad_end=pad_end, device="cpu")
    assert got.dtype == torch.complex64 and got.shape == want.shape
    assert rel_err(want, got.numpy()) < 1e-5
    assert rel_err(numpy_stft(x, nfft, hop, pad_end), got.numpy()) < 1e-5
    planes = pt.stft_planes(x, nfft=nfft, hop=hop, pad_end=pad_end,
                            device="cpu")
    jplanes = np.asarray(jspectrum.stft_planes(jnp.asarray(x), nfft=nfft,
                                               hop=hop, pad_end=pad_end))
    assert planes.dtype == torch.float32 and planes.shape == jplanes.shape
    assert torch.equal(planes[:, 0], got.real)
    assert torch.equal(planes[:, 1], got.imag)
    assert rel_err(jplanes, planes.numpy()) < 1e-5
    if pad_end:
        power = pt.spectrogram(x, nfft=nfft, hop=hop, device="cpu")
        jpower = np.asarray(jspectrum.spectrogram(jnp.asarray(x), nfft=nfft,
                                                  hop=hop))
        assert power.dtype == torch.float32 and power.shape == jpower.shape
        assert rel_err(jpower, power.numpy()) < 2e-5


def test_stft_rejects_hop_not_dividing_nfft():
    x = make_x(1, 4096)
    with pytest.raises(ValueError, match="must divide"):
        jspectrum.stft(jnp.asarray(x), nfft=2048, hop=300)
    with pytest.raises(ValueError, match="must divide"):
        pt.stft(x, nfft=2048, hop=300, device="cpu")
    short = pt.stft(x[:, :100], nfft=2048, hop=512, pad_end=False,
                    device="cpu")
    assert short.shape == (1, 0, 1025)


def test_angular_spectrum_and_db_match_jax():
    seg = make_x(2, 1024, seed=4)
    jw, jmag = jspectrum.angular_spectrum(jnp.asarray(seg))
    w, mag = pt.angular_spectrum(seg, device="cpu")
    assert np.array_equal(np.asarray(jw), w)
    assert mag.shape == jmag.shape and rel_err(jmag, mag.numpy()) < 1e-5
    want = np.abs(np.fft.fftshift(np.fft.fft(seg.astype(np.float64)), -1))
    assert rel_err(want, mag.numpy()) < 1e-5
    db = pt.spectrum_db(mag)
    jdb = np.asarray(jspectrum.spectrum_db(jmag))
    assert np.abs(jdb - db.numpy()).max() < 1e-3      # dB of 1e-5 relative


def test_long_window_spectra_match_jax_and_oracle():
    """nfft = 32768 (K7): magnitude_spectrum and pipe(x, fs,
    with_spectra=True) against the JAX package and the oracle."""
    assert _rfft_kernel_plan(32768)[0] == "tall"
    x = make_x(2, 70560, seed=6)                 # 1.6 s at 44.1 kHz
    scfg = pt.SpectrumConfig(nfft=32768)
    jscfg = jpkg.SpectrumConfig(nfft=32768)
    freqs, mag = pt.magnitude_spectrum(x, FS, scfg, device="cpu")
    jfreqs, jmag = jspectrum.magnitude_spectrum(jnp.asarray(x), FS, jscfg)
    assert np.array_equal(np.asarray(jfreqs), freqs)
    assert mag.shape == jmag.shape == (2, 16385)
    assert rel_err(jmag, mag.numpy()) < 1e-5
    cfg = pt.PipelineConfig(src=pt.SRCConfig(L=160, M=147),
                            eq=pt.EQConfig.from_gains(GAINS), spectrum=scfg)
    out = pt.AudioPipeline(cfg, device="cpu")(x, FS, with_spectra=True)
    jout = jpkg.AudioPipeline(jpkg.PipelineConfig(
        src=jpkg.SRCConfig(L=160, M=147),
        eq=jpkg.EQConfig.from_gains(GAINS), spectrum=jscfg,
        kernels=JKernelConfig(interpret=True)))(jnp.asarray(x), FS,
                                                 with_spectra=True)
    for key in ("input", "resampled", "output"):
        f, m = out.spectra[key]
        jf, jm = jout.spectra[key]
        assert np.array_equal(np.asarray(jf), f) and m.shape == (2, 16385)
        assert rel_err(jm, m.numpy()) < 1e-5, key
    assert torch.equal(out.spectra["input"][1], mag)
    for i in range(2):
        y_want, fs_out = oracle.resample_oracle(x[i], FS, cfg.src, "fast")
        z_want = oracle.equalize_oracle(y_want, fs_out, cfg.eq)
        for sig, rate, key in ((x[i], FS, "input"),
                               (y_want, fs_out, "resampled"),
                               (z_want, fs_out, "output")):
            cap = sig[:scfg.analysis_limit]
            want = oracle.spectrum_oracle(cap, rate, scfg)[1]
            assert snr_db(want, out.spectra[key][1][i].numpy()) > 90, key


ENTRY_POINTS = {
    "resample": lambda x, **kw: pt.resample(x, FS, pt.SRCConfig(L=160, M=147),
                                            **kw)[0],
    "equalize": lambda x, **kw: pt.equalize(
        x, FS, pt.EQConfig.from_gains(GAINS), **kw),
    "stft": lambda x, **kw: pt.stft(x, nfft=256, hop=64, **kw),
    "spectrogram": lambda x, **kw: pt.spectrogram(x, nfft=256, hop=64, **kw),
    "stft_planes": lambda x, **kw: pt.stft_planes(x, nfft=256, hop=64, **kw),
    "magnitude_spectrum": lambda x, **kw: pt.magnitude_spectrum(
        x, FS, pt.SpectrumConfig(nfft=256), **kw)[1],
    "angular_spectrum": lambda x, **kw: pt.angular_spectrum(x, **kw)[1],
    "spectrum_db": lambda x, **kw: pt.spectrum_db(x, floor=2.0, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_device_rule(name, monkeypatch):
    fn = ENTRY_POINTS[name]
    x = make_x(2, 4096, seed=8)
    on_cpu = fn(x, device="cpu")
    assert isinstance(on_cpu, torch.Tensor) and on_cpu.device.type == "cpu"
    kept = fn(torch.as_tensor(x))             # a tensor stays where it is
    assert kept.device.type == "cpu" and torch.equal(kept, on_cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn(x.tolist())
