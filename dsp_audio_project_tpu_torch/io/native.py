"""ctypes bindings for the native (C++) audio codec engine.

The port's own copy of the JAX package's codec (``native/wavcodec.cc`` and
``native/Makefile`` in this package) builds at first use into the
git-ignored ``_build/libwavcodec-<hash>.so``, the hash over the source and
the Makefile (which holds the flags), so a stale library is never loaded.
The build writes a temporary name and renames it into place: several
processes may build at once, and each loads a whole library.  The flags
carry no ``-march=native``.  Every entry point returns None when no
library loads (no ``make`` or no compiler); ``load_signal`` then uses the
pure-numpy codec (wavio.py), which stays the behavioural oracle
(tests/test_torch_native.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG / "_build"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> pathlib.Path:
    """Where the codec builds to: ``BUILD_DIR`` and a hash of the source
    and the Makefile."""
    h = hashlib.sha256()
    for name in ("wavcodec.cc", "Makefile"):
        h.update(name.encode() + b"\0" + (NATIVE_DIR / name).read_bytes())
    return BUILD_DIR / f"libwavcodec-{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> bool:
    """Build the library to a temporary name beside ``path``, then rename
    it into place; False when the build fails."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["make", "-s", "-C", str(NATIVE_DIR), f"OUT={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def load_library() -> Optional[ctypes.CDLL]:
    """The codec library, building lazily; None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.wav_probe.restype = ctypes.c_int
        lib.wav_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.wav_decode_f32.restype = ctypes.c_int
        lib.wav_decode_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.encode_pcm16.restype = None
        lib.encode_pcm16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int16),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def decode(
    data: bytes, *, mono: bool = True, normalize: bool = True
) -> Optional[Tuple[np.ndarray, int]]:
    """Decode WAV bytes natively -> (float32 signal, fs); None if no lib.

    mono=True: (N,) channel-mean signal; else channel-major (C, N).
    """
    lib = load_library()
    if lib is None:
        return None
    channels = ctypes.c_int32()
    frames = ctypes.c_int64()
    fs = ctypes.c_int32()
    rc = lib.wav_probe(data, len(data), ctypes.byref(channels),
                       ctypes.byref(frames), ctypes.byref(fs))
    if rc != 0:
        raise ValueError(f"native WAV probe failed (code {rc})")
    c, n = channels.value, frames.value
    if mono:
        out = np.empty(n, dtype=np.float32)
    else:
        out = np.empty((c, n), dtype=np.float32)
    rc = lib.wav_decode_f32(
        data, len(data), 1 if mono else 0, 1 if normalize else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError(f"native WAV decode failed (code {rc})")
    return out, fs.value


def encode_pcm16(x: np.ndarray) -> Optional[np.ndarray]:
    """Output-stage conversion: channel-major float32 -> interleaved int16.

    Applies the reference's NaN-scrub + peak-normalize + 32767 truncation
    contract in native code.  None if no lib.
    """
    lib = load_library()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.ndim == 1:
        x = x[None, :]
    c, n = x.shape
    out = np.empty((n, c), dtype=np.int16)
    lib.encode_pcm16(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n, c, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
    )
    return out
