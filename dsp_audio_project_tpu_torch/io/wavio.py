"""Pure-numpy RIFF/WAVE codec: the port's copy of the JAX package's
``io/wavio.py`` (importing that module would import jax), held byte for
byte and bit for bit against it by tests/test_torch_io.py.

The reference decodes via ``soundfile`` (libsndfile, dsp_core.py:20) and
encodes via ``scipy.io.wavfile.write`` (app.py:354); the framework carries
its own small codec instead:

* ``read_wav``  — PCM 8/16/24/32-bit and IEEE float32/64, any channel count,
  returned as float64 in [-1, 1) with libsndfile's scaling conventions
  (int16 -> /2**15, int24 -> /2**23, int32 -> /2**31, uint8 -> (x-128)/2**7),
  so downstream conditioning matches the reference bit-for-bit.
* ``write_wav`` — int16 PCM or float32, streaming-friendly (bytes or file).

Both handle WAVE_FORMAT_EXTENSIBLE and skip unknown chunks.
"""
from __future__ import annotations

import io
import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3
_EXTENSIBLE = 0xFFFE


def _as_stream(src: Union[str, bytes, bytearray, BinaryIO]) -> BinaryIO:
    if isinstance(src, (bytes, bytearray)):
        return io.BytesIO(src)
    if isinstance(src, str):
        return open(src, "rb")
    return src


def read_wav(src: Union[str, bytes, bytearray, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Decode a WAV file.

    Returns ``(samples, fs)`` where ``samples`` is float64 with shape ``(N,)``
    for mono or ``(N, C)`` for multichannel, scaled to [-1, 1).
    """
    f = _as_stream(src)
    close = isinstance(src, str)
    try:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")

        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), io.SEEK_CUR)
                continue
            if csize & 1:
                f.seek(1, io.SEEK_CUR)
            if fmt is not None and data is not None:
                break
        if fmt is None or data is None:
            raise ValueError("missing fmt/data chunk")

        if len(fmt) < 16:
            raise ValueError(f"malformed fmt chunk: {len(fmt)} bytes")
        (tag, channels, fs, _byte_rate, block_align, bits) = struct.unpack(
            "<HHIIHH", fmt[:16]
        )
        if tag == _EXTENSIBLE:
            # Sub-format GUID: first 2 bytes are the real format tag.
            if len(fmt) >= 40:
                tag = struct.unpack("<H", fmt[24:26])[0]
            else:
                raise ValueError("malformed WAVE_FORMAT_EXTENSIBLE fmt chunk")

        # Validate the frame geometry before any buffer arithmetic: a bogus
        # block_align smaller than a frame silently misreads samples (and in
        # a native decoder would read out of bounds).
        if channels < 1:
            raise ValueError("fmt chunk declares zero channels")
        if bits % 8 or bits == 0:
            raise ValueError(f"unsupported bit depth: {bits}")
        if block_align != channels * (bits // 8):
            raise ValueError(
                f"block_align {block_align} inconsistent with "
                f"{channels} ch x {bits} bits"
            )

        n_frames = len(data) // block_align
        data = data[: n_frames * block_align]

        if tag == _PCM:
            if bits == 8:
                x = np.frombuffer(data, dtype=np.uint8).astype(np.float64)
                x = (x - 128.0) / 128.0
            elif bits == 16:
                x = np.frombuffer(data, dtype="<i2").astype(np.float64) / 32768.0
            elif bits == 24:
                raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
                as32 = (
                    raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16)
                )
                as32 = (as32 << 8) >> 8  # sign-extend 24 -> 32
                x = as32.astype(np.float64) / float(1 << 23)
            elif bits == 32:
                x = np.frombuffer(data, dtype="<i4").astype(np.float64) / float(1 << 31)
            else:
                raise ValueError(f"unsupported PCM bit depth: {bits}")
        elif tag == _IEEE_FLOAT:
            if bits == 32:
                x = np.frombuffer(data, dtype="<f4").astype(np.float64)
            elif bits == 64:
                x = np.frombuffer(data, dtype="<f8").astype(np.float64)
            else:
                raise ValueError(f"unsupported float bit depth: {bits}")
        else:
            raise ValueError(f"unsupported WAVE format tag: {tag}")

        if channels > 1:
            x = x.reshape(-1, channels)
        return x, int(fs)
    finally:
        if close:
            f.close()


def write_wav(
    dst: Union[str, BinaryIO],
    fs: int,
    samples: np.ndarray,
) -> None:
    """Encode ``samples`` to WAV.

    int16 arrays are written as PCM16 (the reference's output format,
    app.py:354); float64 arrays as IEEE float64 (lossless archival), any
    other dtype as IEEE float32.  Shape ``(N,)`` or ``(N, C)``.
    """
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[:, None]
    channels = x.shape[1]

    if x.dtype == np.int16:
        tag, bits = _PCM, 16
        payload = x.astype("<i2").tobytes()
    elif x.dtype == np.float64:
        tag, bits = _IEEE_FLOAT, 64
        payload = x.astype("<f8").tobytes()
    else:
        tag, bits = _IEEE_FLOAT, 32
        payload = x.astype("<f4").tobytes()

    block_align = channels * bits // 8
    byte_rate = fs * block_align
    fmt = struct.pack("<HHIIHH", tag, channels, fs, byte_rate, block_align, bits)

    out = _as_stream_w(dst)
    close = isinstance(dst, str)
    try:
        out.write(b"RIFF")
        out.write(struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload)))
        out.write(b"WAVE")
        out.write(b"fmt ")
        out.write(struct.pack("<I", len(fmt)))
        out.write(fmt)
        out.write(b"data")
        out.write(struct.pack("<I", len(payload)))
        out.write(payload)
    finally:
        if close:
            out.close()


def _as_stream_w(dst: Union[str, BinaryIO]) -> BinaryIO:
    if isinstance(dst, str):
        return open(dst, "wb")
    return dst
