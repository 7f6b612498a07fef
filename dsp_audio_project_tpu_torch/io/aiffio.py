"""Pure-numpy AIFF codec (big-endian PCM): the port's copy of the JAX
package's ``io/aiffio.py``, held byte for byte against it by
tests/test_torch_io.py.

The reference's loader delegates to libsndfile (dsp_core.py:20), whose
contract is wider than WAV — AIFF being the most common second container.
This module covers plain AIFF PCM 8/16/24/32 (AIFF 8-bit is SIGNED, unlike
WAV's unsigned 8-bit) with libsndfile's /2^(bits-1) scaling, plus a PCM16
writer, so ``load_signal`` accepts both containers transparently.

The 90-bit COMM sample rate is IEEE 754 80-bit extended precision —
encoded/decoded exactly here (every integer rate is representable).
"""
from __future__ import annotations

import io
import math
import struct
from typing import BinaryIO, Tuple, Union

import numpy as np


def _ext80_decode(b: bytes) -> float:
    """IEEE 754 80-bit extended (big-endian) -> float."""
    if len(b) != 10:
        raise ValueError("extended float must be 10 bytes")
    exp, mant = struct.unpack(">HQ", b)
    sign = -1.0 if exp & 0x8000 else 1.0
    exp &= 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * (mant / float(1 << 63)) * 2.0 ** (exp - 16383)


def _ext80_encode(x: float) -> bytes:
    """float -> IEEE 754 80-bit extended (big-endian), exact for rates."""
    if x == 0.0:
        return b"\x00" * 10
    sign = 0x8000 if x < 0 else 0
    m, e = math.frexp(abs(x))  # x = m * 2^e with m in [0.5, 1)
    mant = int(m * (1 << 64))  # top bit set: the explicit integer bit
    return struct.pack(">HQ", sign | (e + 16382), mant)


def read_aiff(src: Union[str, bytes, bytearray, BinaryIO]) -> Tuple[np.ndarray, int]:
    """Decode an AIFF file -> (samples float64 in [-1, 1), fs).

    Shape (N,) mono or (N, C) multichannel — same contract as read_wav.
    """
    if isinstance(src, (bytes, bytearray)):
        f: BinaryIO = io.BytesIO(src)
        close = False
    elif isinstance(src, str):
        f = open(src, "rb")
        close = True
    else:
        f, close = src, False
    try:
        form, _size, aiff = struct.unpack(">4sI4s", f.read(12))
        if form != b"FORM" or aiff not in (b"AIFF",):
            raise ValueError("not a FORM/AIFF file")
        comm = None
        ssnd = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack(">4sI", hdr)
            if cid == b"COMM":
                comm = f.read(csize)
            elif cid == b"SSND":
                ssnd = f.read(csize)
            else:
                f.seek(csize + (csize & 1), io.SEEK_CUR)
                continue
            if csize & 1:
                f.seek(1, io.SEEK_CUR)
            if comm is not None and ssnd is not None:
                break
        if comm is None or ssnd is None:
            raise ValueError("missing COMM/SSND chunk")
        if len(comm) < 18:
            raise ValueError(f"malformed COMM chunk: {len(comm)} bytes")
        channels, n_frames, bits = struct.unpack(">hIh", comm[:8])
        fs = _ext80_decode(comm[8:18])
        if channels < 1:
            raise ValueError("COMM chunk declares zero channels")
        if bits not in (8, 16, 24, 32):
            raise ValueError(f"unsupported AIFF bit depth: {bits}")
        if not (0 < fs < 2**31):
            raise ValueError(f"implausible AIFF sample rate: {fs}")
        if len(ssnd) < 8:
            raise ValueError("malformed SSND chunk")
        offset, _blk = struct.unpack(">II", ssnd[:8])
        data = ssnd[8 + offset :]
        frame_bytes = channels * (bits // 8)
        avail = min(n_frames, len(data) // frame_bytes)
        data = data[: avail * frame_bytes]

        if bits == 8:
            x = np.frombuffer(data, dtype=np.int8).astype(np.float64) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, dtype=">i2").astype(np.float64) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            as32 = (
                (raw[:, 0].astype(np.int32) << 16)
                | (raw[:, 1].astype(np.int32) << 8)
                | raw[:, 2].astype(np.int32)
            )
            as32 = (as32 << 8) >> 8  # sign-extend 24 -> 32
            x = as32.astype(np.float64) / float(1 << 23)
        else:
            x = np.frombuffer(data, dtype=">i4").astype(np.float64) / float(1 << 31)

        if channels > 1:
            x = x.reshape(-1, channels)
        return x, int(round(fs))
    finally:
        if close:
            f.close()


def write_aiff(
    dst: Union[str, BinaryIO], fs: int, samples: np.ndarray
) -> None:
    """Encode int16 samples as AIFF PCM16 (big-endian).

    Shape (N,) or (N, C); non-int16 input is scaled/truncated like the
    output stage (x * 32767 for floats already in [-1, 1]).
    """
    x = np.asarray(samples)
    if x.dtype != np.int16:
        x = (np.clip(x.astype(np.float64), -1.0, 1.0) * 32767).astype(np.int16)
    if x.ndim == 1:
        x = x[:, None]
    n, channels = x.shape
    payload = x.astype(">i2").tobytes()
    comm = struct.pack(">hIh", channels, n, 16) + _ext80_encode(float(fs))
    ssnd = struct.pack(">II", 0, 0) + payload
    body = (
        b"AIFF"
        + b"COMM" + struct.pack(">I", len(comm)) + comm
        + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    )
    if isinstance(dst, str):
        with open(dst, "wb") as fh:
            fh.write(b"FORM" + struct.pack(">I", len(body)) + body)
    else:
        dst.write(b"FORM" + struct.pack(">I", len(body)) + body)
