"""Spectrum analysis ops: the reference's views and the STFT.

Counterpart of ``dsp_audio_project_tpu/ops/spectrum.py``:
  * ``magnitude_spectrum`` — the primary view (dsp_core.py:68-98): center
    segment (or zero-pad to the next power of two), symmetric Hann window,
    |FFT| over the first N//2+1 bins, after the app's analysis cap
    (app.py:202); the chains' window helpers;
  * ``angular_spectrum`` — the two-sided fftshifted view (app.py:308-327);
  * ``stft`` / ``spectrogram`` / ``stft_planes`` — Hann-windowed hop-strided
    frames through the batched rfft kernels (K2 complex up to nfft = 8192,
    K7 / K8 above).
The segment geometry is host arithmetic; the window and the FFTs run on
the tensor's device.  The public entry points take ``device=None``
(``utils/device.as_input``): a tensor stays where it is, anything else
goes to the card unless ``device="cpu"`` is asked.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SpectrumConfig
from ..utils.device import as_input, device_tables
from .fft import (
    _rfft_kernel_dispatch, _rfft_kernel_plan, fft, rfft, rfft_magnitude,
)


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    # Symmetric Hann, exactly the reference's inline form (dsp_core.py:86-87).
    idx = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * idx / (n - 1))).astype(np.float32)


def _hann_tensor(n: int, device: torch.device) -> torch.Tensor:
    return device_tables(_hann, n, device=device)


def _segment_bounds(n: int, nfft: int) -> Tuple[int, int]:
    """Static segment selection (dsp_core.py:74-82).

    Note the nfft < n < mid + nfft corner: the reference slices
    x[mid : mid + nfft], gets a short non-power-of-two segment, and its
    recursive FFT crashes on it.  The build defines clean semantics instead
    (SURVEY.md §4 property tier): window whatever the tail holds and zero-pad
    to the next power of two.
    """
    if n > nfft:
        mid = n // 2
        avail = n - mid
        if avail >= nfft:
            return mid, nfft
        return mid, 1 << (avail - 1).bit_length()
    return 0, 1 << (n - 1).bit_length()


def spectrum_segment(n: int, cfg: SpectrumConfig) -> Tuple[int, int, int]:
    """Static (start, m, n_capped) a spectrum of an n-sample signal uses.

    Applies the analysis cap (first ``analysis_limit`` samples, app.py:202)
    then the reference's center-segment rule (dsp_core.py:74-82).
    """
    if cfg.analysis_limit and n > cfg.analysis_limit:
        n = cfg.analysis_limit
    start, m = _segment_bounds(n, cfg.nfft)
    return start, m, n


def spectrum_freqs(
    n: int, fs: int, cfg: SpectrumConfig = SpectrumConfig()
) -> np.ndarray:
    """Host frequency axis matching the spectra of an n-sample signal."""
    _, m, _ = spectrum_segment(n, cfg)
    return np.fft.rfftfreq(m, d=1.0 / fs)


def _window(seg: torch.Tensor, avail: int, m: int) -> torch.Tensor:
    if avail < m:
        seg = F.pad(seg, (0, m - avail))
    return seg.to(torch.float32) * _hann_tensor(m, seg.device)


def _windowed_rfft_mag(x: torch.Tensor, start: int, m: int) -> torch.Tensor:
    """|rfft| of the Hann-windowed m-sample segment of (..., N) at
    ``start`` (zero-padded past the end)."""
    avail = min(m, x.shape[-1] - start)
    return rfft_magnitude(_window(x[..., start: start + avail], avail, m))


def spectrum_window(
    x: torch.Tensor, cfg: SpectrumConfig = SpectrumConfig()
) -> torch.Tensor:
    """The windowed (..., m) analysis segment of (..., N) — the spectrum
    minus the FFT, so several signals' segments can share one batched rfft
    (spectra_mag_stacked)."""
    start, m, n = spectrum_segment(x.shape[-1], cfg)
    avail = min(m, n - start)
    return _window(x[..., start: start + avail], avail, m)


def spectrum_mag(
    x: torch.Tensor, cfg: SpectrumConfig = SpectrumConfig()
) -> torch.Tensor:
    """Magnitude spectrum of (..., N): the device half of
    ``magnitude_spectrum``."""
    start, m, n = spectrum_segment(x.shape[-1], cfg)
    return _windowed_rfft_mag(x[..., :n], start, m)


def spectrum_window_frames(
    frames: torch.Tensor, n_flat: int, cfg: SpectrumConfig = SpectrumConfig()
) -> torch.Tensor:
    """spectrum_window of the flat view of (..., F, P) frames, from just the
    ~m/P frame rows the window touches.  ``n_flat`` is the true sample count
    the frames hold (trailing pad excluded)."""
    r0, r1 = spectrum_rows_needed(n_flat, frames.shape[-1], cfg)
    return spectrum_window_rows(frames[..., r0:r1, :], r0, n_flat, cfg)


def spectrum_mag_frames(
    frames: torch.Tensor, n_flat: int, cfg: SpectrumConfig = SpectrumConfig()
) -> torch.Tensor:
    """Magnitude spectrum of the flat view of (..., F, P) frames; equals
    ``spectrum_mag`` on the flattened signal."""
    return rfft_magnitude(spectrum_window_frames(frames, n_flat, cfg))


def spectrum_rows_needed(
    n_flat: int, P: int, cfg: SpectrumConfig = SpectrumConfig()
) -> Tuple[int, int]:
    """Frame-row range [r0, r1) of P-wide frames that the analysis window
    of an n_flat-sample signal touches (static host arithmetic)."""
    start, m, n = spectrum_segment(n_flat, cfg)
    avail = min(m, n - start)
    return start // P, -(-(start + avail) // P)


def spectrum_window_rows(
    rows: torch.Tensor, r0: int, n_flat: int,
    cfg: SpectrumConfig = SpectrumConfig(),
) -> torch.Tensor:
    """spectrum_window of the flat signal when the caller holds JUST the
    touched frame rows [r0, r1) (see spectrum_rows_needed) — the cat chain
    emits the y/z analysis rows as small side tensors."""
    P = rows.shape[-1]
    start, m, n = spectrum_segment(n_flat, cfg)
    avail = min(m, n - start)
    flat = rows.reshape(rows.shape[:-2] + (rows.shape[-2] * P,))
    off = start - r0 * P
    return _window(flat[..., off: off + avail], avail, m)


def spectra_mag_stacked(segs: Sequence[torch.Tensor]):
    """|rfft| of several same-width windowed segments in ONE kernel launch.

    The full chain computes three 2048-point spectra per render (x, y, z —
    app.py:202-205); stacking them on a new leading axis makes one batch.
    Segments of different widths (mixed-length corner configs) run one
    call each.
    """
    if any(s.shape != segs[0].shape for s in segs[1:]):
        return [rfft_magnitude(s) for s in segs]
    mags = rfft_magnitude(torch.stack(list(segs), dim=0))
    return [mags[i] for i in range(len(segs))]


def magnitude_spectrum(
    x, fs: int, cfg: SpectrumConfig = SpectrumConfig(), device=None
) -> Tuple[np.ndarray, torch.Tensor]:
    """(freqs, |X[k]|) for (..., N) signals; freqs is a host array.

    The analysis cap (first ``analysis_limit`` samples) is applied before
    segmentation, as the app does.  A segment of 256..1048576 points runs
    its rfft kernel (K2, K7 or K8).
    """
    x = as_input(x, device, "magnitude_spectrum")
    n = x.shape[-1]
    start, m, n_cap = spectrum_segment(n, cfg)
    mag = _windowed_rfft_mag(x[..., :n_cap], start, m)
    return np.fft.rfftfreq(m, d=1.0 / fs), mag


def angular_spectrum(segment, device=None) -> Tuple[np.ndarray, torch.Tensor]:
    """Two-sided fftshifted magnitude over [-pi, pi) (app.py:322-327).

    ``segment`` is (..., nfft) with nfft a power of two; returns the
    normalized-frequency axis (host array) and |fftshift(FFT(segment))|
    (the torch butterfly).
    """
    seg = as_input(segment, device, "angular_spectrum")
    m = seg.shape[-1]
    w_axis = np.linspace(-np.pi, np.pi, m)
    return w_axis, torch.roll(fft(seg).abs(), m // 2, dims=-1)


def spectrum_db(mag, floor: float = 1e-12, device=None) -> torch.Tensor:
    """dB conversion used by the app's frequency view (app.py:208-210)."""
    return 20.0 * torch.log10(as_input(mag, device, "spectrum_db") + floor)


def stft(x, nfft: int = 2048, hop: int = 512, pad_end: bool = True,
         fast: bool = True, device=None) -> torch.Tensor:
    """Short-time Fourier transform: (..., N) -> (..., frames, nfft//2+1)
    complex64.

    Hann-windowed (the reference's analysis window), hop-strided frames
    through the batched rfft: a planned nfft (256..1048576) runs its kernel
    in complex form (K2 up to 8192, K7, K8), other sizes the torch
    butterfly.  Requires hop | nfft.  ``pad_end`` zero-pads so every
    sample is covered; otherwise trailing samples short of a full window
    are dropped.  ``fast`` is accepted and ignored (fp32 throughout).
    """
    if nfft % hop:
        raise ValueError(f"hop {hop} must divide nfft {nfft}")
    x = as_input(x, device, "stft")
    n = x.shape[-1]
    if pad_end:
        frames = -(-n // hop)
    else:
        frames = max(0, (n - nfft) // hop + 1)
    total = (frames + nfft // hop - 1) * hop
    xp = F.pad(x, (0, total - n)) if total > n else x[..., :total]
    if frames:
        win = xp.unfold(-1, nfft, hop)             # (..., frames, nfft)
    else:
        win = xp.new_zeros(x.shape[:-1] + (0, nfft))
    win = win * _hann_tensor(nfft, x.device)
    plan = _rfft_kernel_plan(nfft)
    if plan is not None:
        return _rfft_kernel_dispatch(win, plan, False)
    return rfft(win)


def spectrogram(x, nfft: int = 2048, hop: int = 512,
                device=None) -> torch.Tensor:
    """Power spectrogram |STFT|^2: (..., frames, nfft//2+1) float32."""
    s = stft(x, nfft=nfft, hop=hop, device=device)
    return s.real ** 2 + s.imag ** 2


def stft_planes(x, nfft: int = 2048, hop: int = 512, pad_end: bool = True,
                fast: bool = True, device=None) -> torch.Tensor:
    """STFT as stacked real planes: (..., 2, frames, nfft//2+1) float32,
    [0] the real part and [1] the imaginary part (the JAX package's
    host-fetch-safe form)."""
    s = stft(x, nfft=nfft, hop=hop, pad_end=pad_end, fast=fast,
             device=device)
    return torch.stack([s.real, s.imag], dim=-3)
