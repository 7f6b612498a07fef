"""Host-side signal conditioning: the framework's L1 (I/O) layer.

Reproduces the reference's load contract (dsp_core.py:10-35) and output stage
(app.py:346-358).  The port's copy of the JAX package's ``io/signal_io.py``:
it takes and returns numpy and does no device work (the caller moves the
signal to the card); held bit for bit against the JAX functions by
tests/test_torch_io.py.  ``engine='auto'`` decodes WAV through the port's
own native library (io/native.py), never the JAX package's.
"""
from __future__ import annotations

import io as _io
from typing import BinaryIO, Optional, Tuple, Union

import numpy as np

from .wavio import read_wav, write_wav

_FALLBACK_LEN = 100
_FALLBACK_FS = 44100
_PEAK_GUARD = 1e-6


def _read_auto(src) -> Tuple[np.ndarray, int]:
    """Container dispatch by magic: RIFF/WAVE, FORM/AIFF, or fLaC."""
    if isinstance(src, str):
        with open(src, "rb") as fh:
            magic = fh.read(4)
    elif hasattr(src, "read"):
        src = src.read()
        magic = bytes(src[:4])
    else:
        magic = bytes(src[:4])
    if magic == b"FORM":
        from .aiffio import read_aiff

        return read_aiff(src)
    if magic == b"fLaC":
        from .flacio import read_flac

        return read_flac(src)
    return read_wav(src)


def load_signal(
    src: Union[str, bytes, BinaryIO],
    *,
    mono: bool = True,
    engine: str = "auto",
) -> Tuple[np.ndarray, int]:
    """Decode audio into a conditioned discrete-time signal.

    Contract (reference dsp_core.py:10-35):
      1. decode to float samples,
      2. stereo -> mono by channel mean (before the float32 cast),
      3. cast float32,
      4. peak-normalize to |x| <= 1 when the peak exceeds 1e-6,
      5. on ANY decode failure return 100 zero samples at 44.1 kHz.

    With ``mono=False`` the same conditioning is applied per-file with the
    channel axis preserved, shape ``(C, N)`` — the layout the sharded pipeline
    expects (channels leading so the mesh 'channel' axis shards dim 0).

    ``engine``: 'auto' decodes through the native C++ codec when its library
    is available (bit-matching the numpy path; tests/test_torch_native.py),
    'numpy' forces the pure-Python codec.  Containers: RIFF/WAVE, FORM/AIFF,
    and FLAC, sniffed by magic (the reference's libsndfile loader accepts
    all three — dsp_core.py:20).
    """
    try:
        if engine == "auto":
            from . import native as _native

            if _native.available():
                data = src
                if isinstance(src, str):
                    with open(src, "rb") as fh:
                        data = fh.read()
                elif hasattr(src, "read"):
                    data = src.read()
                data = bytes(data)
                if data[:4] == b"RIFF":
                    try:
                        x, fs = _native.decode(data, mono=mono)
                        return x, int(fs)
                    except ValueError:
                        # Unsupported layout for the native parser.
                        pass
                src = data
        x, fs = _read_auto(src)
        if mono:
            if x.ndim > 1:
                x = x.mean(axis=1)
            x = x.astype(np.float32)
        else:
            if x.ndim == 1:
                x = x[:, None]
            x = np.ascontiguousarray(x.T).astype(np.float32)  # (C, N)
        peak = np.max(np.abs(x)) if x.size else 0.0
        if peak > _PEAK_GUARD:
            x = x / peak
        return x, int(fs)
    except Exception:
        shape = (_FALLBACK_LEN,) if mono else (1, _FALLBACK_LEN)
        return np.zeros(shape, dtype=np.float32), _FALLBACK_FS


def example_signal(
    kind: str, seconds: float = 10.0, fs: int = 44100
) -> Tuple[np.ndarray, int]:
    """Built-in example signals — the analog of the reference's
    ``examples/*.wav`` browsing (app.py:123-126; the WAV fixtures were
    stripped from the mount, so deterministic synthesis substitutes).

    Kinds: 'tones' (40/440/9800 Hz mix), 'sweep' (log 20 Hz - 16 kHz),
    'noise' (seeded white noise).  Returns (float32 signal peaked at 1, fs).
    """
    t = np.arange(int(seconds * fs)) / fs
    if kind == "tones":
        x = (0.5 * np.sin(2 * np.pi * 440 * t)
             + 0.25 * np.sin(2 * np.pi * 40 * t)
             + 0.25 * np.sin(2 * np.pi * 9800 * t))
    elif kind == "sweep":
        f0, f1 = 20.0, 16000.0
        phase = 2 * np.pi * f0 * seconds / np.log(f1 / f0) * (
            np.exp(t / seconds * np.log(f1 / f0)) - 1.0
        )
        x = 0.8 * np.sin(phase)
    elif kind == "noise":
        x = 0.6 * np.random.default_rng(7).standard_normal(len(t))
    else:
        raise ValueError(
            f"unknown example kind {kind!r}; expected tones|sweep|noise"
        )
    return (x / np.max(np.abs(x))).astype(np.float32), fs


EXAMPLE_KINDS = ("tones", "sweep", "noise")
_EXAMPLE_EXTS = (".wav", ".aif", ".aiff")


def list_example_files(directory: Optional[str] = None) -> list:
    """Enumerate on-disk example audio files, sorted by name.

    The reference browses ``examples/*.wav`` from disk (app.py:123-126).
    Search order for the directory: the ``directory`` argument, the
    ``DSP_EXAMPLES_DIR`` environment variable, then ``./examples`` relative
    to the current working directory.  Returns ``[]`` when no directory
    exists — callers fall back to the synthesized ``example_signal`` kinds.
    """
    import os

    cand = directory or os.environ.get("DSP_EXAMPLES_DIR") or "examples"
    if not os.path.isdir(cand):
        return []
    return sorted(
        os.path.join(cand, f)
        for f in os.listdir(cand)
        if f.lower().endswith(_EXAMPLE_EXTS)
    )


def resolve_example(
    name: str, directory: Optional[str] = None
) -> Tuple[np.ndarray, int]:
    """Load the example source ``name``: a synthesized kind ('tones' |
    'sweep' | 'noise') or an on-disk file from the examples directory
    matched by filename or stem (case-insensitive).

    Raises ValueError when ``name`` matches neither, listing what exists.
    """
    import os

    if name in EXAMPLE_KINDS:
        return example_signal(name)
    low = name.lower()
    files = list_example_files(directory)
    for path in files:
        base = os.path.basename(path)
        if low in (base.lower(), os.path.splitext(base)[0].lower()):
            return load_signal(path)
    have = list(EXAMPLE_KINDS) + [os.path.basename(p) for p in files]
    raise ValueError(
        f"unknown example {name!r}; available: {', '.join(have)}"
    )


def export_wav(
    samples: np.ndarray,
    fs: int,
    dst: Optional[Union[str, BinaryIO]] = None,
) -> Optional[bytes]:
    """Finalize a processed signal into an int16 WAV.

    Contract (reference app.py:349-354): NaN-scrub, peak-normalize when the
    peak is positive, scale by 32767 and truncate to int16.

    If ``dst`` is None the encoded bytes are returned.
    """
    y = np.nan_to_num(np.asarray(samples, dtype=np.float64))
    if y.ndim == 2:  # (C, N) -> (N, C) interleaved
        y = y.T
    peak = np.max(np.abs(y)) if y.size else 0.0
    if peak > 0:
        y = y / peak
    pcm = (y * 32767).astype(np.int16)
    if dst is None:
        buf = _io.BytesIO()
        write_wav(buf, fs, pcm)
        return buf.getvalue()
    write_wav(dst, fs, pcm)
    return None
