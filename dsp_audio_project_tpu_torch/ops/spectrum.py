"""Windowed magnitude-spectrum ops (the reference's primary analysis view).

Counterpart of the parts of ``dsp_audio_project_tpu/ops/spectrum.py`` that the
cat, frames and flat chains use: center segment (or zero-pad to the next power of two),
symmetric Hann window, |FFT| over the first N//2+1 bins (dsp_core.py:68-98),
after the app's analysis cap (app.py:202).  The segment geometry is host
arithmetic; the window and the rfft run on the tensor's device.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SpectrumConfig
from .fft import rfft_magnitude


@functools.lru_cache(maxsize=None)
def _hann(n: int) -> np.ndarray:
    # Symmetric Hann, exactly the reference's inline form (dsp_core.py:86-87).
    idx = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * idx / (n - 1))).astype(np.float32)


_hann_cache: dict = {}


def _hann_tensor(n: int, device: torch.device) -> torch.Tensor:
    key = (n, str(device))
    w = _hann_cache.get(key)
    if w is None:
        w = torch.as_tensor(_hann(n), device=device)
        _hann_cache[key] = w
    return w


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
    return rfft_magnitude(spectrum_window(x, cfg))


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
    x: torch.Tensor, fs: int, cfg: SpectrumConfig = SpectrumConfig()
) -> Tuple[np.ndarray, torch.Tensor]:
    """(freqs, |X[k]|) for (..., N) signals; freqs is a host array."""
    mag = rfft_magnitude(spectrum_window(x, cfg))
    return spectrum_freqs(x.shape[-1], fs, cfg), mag
