"""Pure-Python FLAC codec (decode-complete subset + fixture encoder): the
port's copy of the JAX package's ``io/flacio.py``, held byte for byte and
bit for bit against it by tests/test_torch_io.py.

The reference's loader delegates to libsndfile (dsp_core.py:20), which
accepts FLAC in addition to WAV/AIFF — the last realistic loader-contract
gap.  ``read_flac`` decodes the full frame layer of the format:

  * STREAMINFO metadata (other blocks skipped),
  * fixed- and variable-blocksize frames, UTF-8-coded frame numbers,
  * CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, wasted bits,
  * Rice / Rice2 partitioned residuals incl. the raw-escape code,
  * independent, left/side, right/side and mid/side channel assignments,
  * CRC-8 header and CRC-16 frame checks (corruption raises ValueError).

``write_flac`` is the test-fixture encoder: bit-exact lossless output with
selectable subframe strategy (verbatim / constant / fixed+Rice) and stereo
decorrelation mode, so every decoder path has an in-repo generator.  Like
the WAV/AIFF codecs, all failure modes raise ValueError (fuzz-gated in
tests/test_flac.py and tests/test_torch_io.py) and samples scale by
1 / 2^(bits-1), libsndfile-style.
"""
from __future__ import annotations

import io
import struct
from typing import BinaryIO, Tuple, Union

import numpy as np

_SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
    7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_FIXED_COEFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = (
                ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000
                else (crc << 1) & 0xFFFF
            )
    return crc


class _Bits:
    """MSB-first bit reader with hard bounds checks (fuzz safety)."""

    __slots__ = ("data", "pos", "n")

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits
        self.n = len(data) * 8

    def read(self, bits: int) -> int:
        if bits == 0:
            return 0
        if self.pos + bits > self.n:
            raise ValueError("flac: truncated stream")
        start = self.pos
        self.pos += bits
        first = start >> 3
        last = (start + bits - 1) >> 3
        chunk = int.from_bytes(self.data[first : last + 1], "big")
        shift = ((last + 1) << 3) - (start + bits)
        return (chunk >> shift) & ((1 << bits) - 1)

    def read_signed(self, bits: int) -> int:
        v = self.read(bits)
        return v - (1 << bits) if bits and v >> (bits - 1) else v

    def read_unary(self) -> int:
        # Zeros terminated by a one; byte-scan the zero run.
        q = 0
        while True:
            if self.pos >= self.n:
                raise ValueError("flac: truncated unary code")
            rem = 8 - (self.pos & 7)
            window = self.read(rem)
            if window:
                lead = rem - window.bit_length()
                self.pos -= rem - lead - 1
                return q + lead
            q += rem
            if q > (1 << 24):
                raise ValueError("flac: unary code runaway")

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _read_utf8_number(b: _Bits, max_bytes: int = 7) -> int:
    x = b.read(8)
    if x < 0x80:
        return x
    ones = 0
    while ones < 8 and (x << ones) & 0x80:
        ones += 1
    if ones < 2 or ones > max_bytes:
        raise ValueError("flac: bad UTF-8 coded number")
    v = x & (0xFF >> (ones + 1))
    for _ in range(ones - 1):
        c = b.read(8)
        if c & 0xC0 != 0x80:
            raise ValueError("flac: bad UTF-8 continuation")
        v = (v << 6) | (c & 0x3F)
    return v


def _read_residual(b: _Bits, blocksize: int, order: int) -> list:
    method = b.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    pbits = 4 + method
    escape = (1 << pbits) - 1
    porder = b.read(4)
    parts = 1 << porder
    if blocksize % parts:
        raise ValueError("flac: bad partition order")
    out = []
    for p in range(parts):
        cnt = (blocksize >> porder) - (order if p == 0 else 0)
        if cnt < 0:
            raise ValueError("flac: bad partition geometry")
        param = b.read(pbits)
        if param == escape:
            raw = b.read(5)
            for _ in range(cnt):
                out.append(b.read_signed(raw))
        else:
            for _ in range(cnt):
                q = b.read_unary()
                u = (q << param) | b.read(param)
                out.append((u >> 1) ^ -(u & 1))
    return out


def _decode_subframe(b: _Bits, blocksize: int, bps: int) -> list:
    if b.read(1):
        raise ValueError("flac: bad subframe padding bit")
    stype = b.read(6)
    wasted = 0
    if b.read(1):
        wasted = b.read_unary() + 1
    eff = bps - wasted
    if eff <= 0 or eff > 33:
        raise ValueError("flac: bad effective sample size")

    if stype == 0:  # CONSTANT
        v = b.read_signed(eff)
        samples = [v] * blocksize
    elif stype == 1:  # VERBATIM
        samples = [b.read_signed(eff) for _ in range(blocksize)]
    elif 8 <= stype <= 12:  # FIXED, order = stype - 8
        order = stype - 8
        if order > blocksize:
            raise ValueError("flac: fixed order exceeds block")
        samples = [b.read_signed(eff) for _ in range(order)]
        resid = _read_residual(b, blocksize, order)
        coefs = _FIXED_COEFS[order]
        for r in resid:
            acc = r
            for j, c in enumerate(coefs):
                acc += c * samples[-1 - j]
            samples.append(acc)
    elif stype >= 32:  # LPC, order = stype - 31
        order = stype - 31
        if order > blocksize:
            raise ValueError("flac: lpc order exceeds block")
        samples = [b.read_signed(eff) for _ in range(order)]
        prec = b.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid lpc precision")
        shift = b.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative lpc shift")
        coefs = [b.read_signed(prec) for _ in range(order)]
        resid = _read_residual(b, blocksize, order)
        for r in resid:
            acc = 0
            for j, c in enumerate(coefs):
                acc += c * samples[-1 - j]
            samples.append(r + (acc >> shift))
    else:
        raise ValueError(f"flac: reserved subframe type {stype}")
    if wasted:
        samples = [s << wasted for s in samples]
    if len(samples) != blocksize:
        raise ValueError("flac: subframe sample count mismatch")
    return samples


def read_flac(src: Union[str, bytes, bytearray, BinaryIO]):
    """Decode FLAC -> (samples, fs); samples (N,) mono or (N, C) float64
    scaled by 1/2^(bits-1) (libsndfile's convention, matching the WAV/AIFF
    codecs).  Raises ValueError on any malformed input."""
    if isinstance(src, str):
        with open(src, "rb") as fh:
            data = fh.read()
    elif hasattr(src, "read"):
        data = src.read()
    else:
        data = bytes(src)
    if len(data) < 42 or data[:4] != b"fLaC":
        raise ValueError("flac: bad stream marker")

    # Metadata blocks; STREAMINFO is mandatory and first.
    pos = 4
    streaminfo = None
    last = False
    while not last:
        if pos + 4 > len(data):
            raise ValueError("flac: truncated metadata")
        head = data[pos]
        last = bool(head & 0x80)
        btype = head & 0x7F
        blen = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + blen]
        if len(body) != blen:
            raise ValueError("flac: truncated metadata block")
        if streaminfo is None:
            if btype != 0 or blen != 34:
                raise ValueError("flac: missing STREAMINFO")
            streaminfo = body
        pos += 4 + blen

    bits_si = _Bits(streaminfo)
    bits_si.read(16)  # min blocksize
    bits_si.read(16)  # max blocksize
    bits_si.read(24)  # min frame size
    bits_si.read(24)  # max frame size
    fs_si = bits_si.read(20)
    channels_si = bits_si.read(3) + 1
    bps_si = bits_si.read(5) + 1
    total = bits_si.read(36)
    if fs_si == 0:
        raise ValueError("flac: zero sample rate")

    chans = [[] for _ in range(channels_si)]
    b = _Bits(data, pos * 8)
    decoded = 0
    while b.pos < b.n and (total == 0 or decoded < total):
        b.align()
        if b.n - b.pos < 32:
            break
        frame_start_byte = b.pos >> 3
        sync = b.read(14)
        if sync != 0x3FFE:
            raise ValueError("flac: lost frame sync")
        if b.read(1):
            raise ValueError("flac: reserved frame bit")
        b.read(1)  # blocking strategy
        bs_code = b.read(4)
        sr_code = b.read(4)
        ch_code = b.read(4)
        ss_code = b.read(3)
        if b.read(1):
            raise ValueError("flac: reserved frame bit 2")
        _read_utf8_number(b)
        if bs_code == 0:
            raise ValueError("flac: reserved block size code")
        elif bs_code == 1:
            blocksize = 192
        elif bs_code <= 5:
            blocksize = 576 << (bs_code - 2)
        elif bs_code == 6:
            blocksize = b.read(8) + 1
        elif bs_code == 7:
            blocksize = b.read(16) + 1
        else:
            blocksize = 256 << (bs_code - 8)
        if sr_code == 0:
            fs = fs_si
        elif sr_code in _SAMPLE_RATES:
            fs = _SAMPLE_RATES[sr_code]
        elif sr_code == 12:
            fs = b.read(8) * 1000
        elif sr_code == 13:
            fs = b.read(16)
        elif sr_code == 14:
            fs = b.read(16) * 10
        else:
            raise ValueError("flac: invalid sample rate code")
        if ss_code == 0:
            bps = bps_si
        elif ss_code in _SAMPLE_SIZES:
            bps = _SAMPLE_SIZES[ss_code]
        else:
            raise ValueError("flac: reserved sample size code")
        b.align()  # header is byte-aligned before the CRC in our reader...
        # (the UTF-8/extension fields are already byte-multiples, so the
        # reader is byte-aligned here by construction)
        hdr_end_byte = b.pos >> 3
        crc8 = b.read(8)
        if _crc8(data[frame_start_byte:hdr_end_byte]) != crc8:
            raise ValueError("flac: frame header CRC mismatch")

        if ch_code < 8:
            nch = ch_code + 1
            if nch != channels_si:
                raise ValueError("flac: channel count mismatch")
            subs = [
                _decode_subframe(b, blocksize, bps) for _ in range(nch)
            ]
        elif ch_code in (8, 9, 10):
            if channels_si != 2:
                raise ValueError("flac: stereo decorrelation on non-stereo")
            if ch_code == 8:     # left/side
                left = _decode_subframe(b, blocksize, bps)
                side = _decode_subframe(b, blocksize, bps + 1)
                subs = [left, [l - s for l, s in zip(left, side)]]
            elif ch_code == 9:   # right/side
                side = _decode_subframe(b, blocksize, bps + 1)
                right = _decode_subframe(b, blocksize, bps)
                subs = [[r + s for r, s in zip(right, side)], right]
            else:                # mid/side
                mid = _decode_subframe(b, blocksize, bps)
                side = _decode_subframe(b, blocksize, bps + 1)
                left, right = [], []
                for m, s in zip(mid, side):
                    mm = (m << 1) | (s & 1)
                    left.append((mm + s) >> 1)
                    right.append((mm - s) >> 1)
                subs = [left, right]
        else:
            raise ValueError("flac: reserved channel assignment")

        b.align()
        if b.pos + 16 > b.n:
            raise ValueError("flac: truncated frame footer")
        footer_byte = b.pos >> 3
        crc16 = b.read(16)
        if _crc16(data[frame_start_byte:footer_byte]) != crc16:
            raise ValueError("flac: frame CRC mismatch")

        take = blocksize
        if total and decoded + take > total:
            take = total - decoded
        for c in range(channels_si):
            chans[c].extend(subs[c][:take])
        decoded += take

    if total and decoded < total:
        raise ValueError("flac: stream ends before total_samples")
    scale = float(1 << (bps_si - 1))
    arr = np.asarray(chans, dtype=np.float64).T / scale  # (N, C)
    if channels_si == 1:
        return arr[:, 0], int(fs_si)
    return arr, int(fs_si)


# ---------------------------------------------------------------------------
# Fixture encoder
# ---------------------------------------------------------------------------


class _BitW:
    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, value: int, bits: int) -> None:
        if bits == 0:
            return
        self.acc = (self.acc << bits) | (value & ((1 << bits) - 1))
        self.nbits += bits
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _utf8_encode_number(w: _BitW, v: int) -> None:
    if v < 0x80:
        w.write(v, 8)
        return
    payload = []
    nbytes = 2
    while v >= (1 << (1 + 5 * nbytes)):
        nbytes += 1
    shift = 6 * (nbytes - 1)
    w.write((0xFF00 >> nbytes) & 0xFF | (v >> shift), 8)
    for i in range(nbytes - 1):
        shift -= 6
        w.write(0x80 | ((v >> shift) & 0x3F), 8)


def _write_residual(w: _BitW, resid, param: int) -> None:
    w.write(0, 2)   # Rice method
    w.write(0, 4)   # partition order 0
    w.write(param, 4)
    for r in resid:
        u = (r << 1) if r >= 0 else ((-r) << 1) - 1  # zigzag
        q, rem = u >> param, u & ((1 << param) - 1)
        if q > (1 << 20):
            raise ValueError("flac encode: rice parameter too small")
        w.write(0, q)
        w.write(1, 1)
        w.write(rem, param)


def _write_subframe(w: _BitW, samples, bps: int, mode: str) -> None:
    vals = [int(v) for v in samples]
    if mode == "auto" and len(set(vals)) == 1:
        mode = "constant"
    elif mode == "auto":
        mode = "fixed"
    if mode == "constant":
        if len(set(vals)) != 1:
            raise ValueError("flac encode: constant subframe needs constant data")
        w.write(0, 1)
        w.write(0, 6)
        w.write(0, 1)
        w.write(vals[0], bps)
        return
    if mode == "verbatim":
        w.write(0, 1)
        w.write(1, 6)
        w.write(0, 1)
        for v in vals:
            w.write(v, bps)
        return
    if mode == "fixed":
        order = min(2, len(vals))
        w.write(0, 1)
        w.write(8 + order, 6)
        w.write(0, 1)
        for v in vals[:order]:
            w.write(v, bps)
        coefs = _FIXED_COEFS[order]
        resid = []
        for i in range(order, len(vals)):
            pred = sum(c * vals[i - 1 - j] for j, c in enumerate(coefs))
            resid.append(vals[i] - pred)
        mean = max(1, int(np.mean(np.abs(resid))) if resid else 1)
        param = min(14, max(0, mean.bit_length()))
        _write_residual(w, resid, param)
        return
    raise ValueError(f"flac encode: unknown subframe mode {mode!r}")


def write_flac(
    dst: Union[str, BinaryIO],
    fs: int,
    data: np.ndarray,
    bits: int = 16,
    blocksize: int = 4096,
    subframe: str = "auto",
    stereo_mode: str = "independent",
) -> None:
    """Lossless fixture encoder: int samples (N,) or (N, C), bits in
    {8, 16, 24, 32}.  ``subframe``: 'auto' (constant/fixed), 'verbatim',
    'constant', or 'fixed'; ``stereo_mode``: 'independent', 'left_side',
    'right_side', or 'mid_side' (stereo only)."""
    a = np.asarray(data)
    if a.ndim == 1:
        a = a[:, None]
    n, nch = a.shape
    if bits not in (8, 16, 24, 32):
        raise ValueError("flac encode: bits must be 8/16/24/32")
    lim = 1 << (bits - 1)
    ai = a.astype(np.int64)
    if np.any(ai >= lim) or np.any(ai < -lim):
        raise ValueError("flac encode: samples exceed bit depth")
    if stereo_mode != "independent" and nch != 2:
        raise ValueError("flac encode: decorrelation requires stereo")

    out = io.BytesIO()
    out.write(b"fLaC")
    si = _BitW()
    si.write(max(16, min(blocksize, 65535)), 16)
    si.write(max(16, min(blocksize, 65535)), 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(fs, 20)
    si.write(nch - 1, 3)
    si.write(bits - 1, 5)
    si.write(n, 36)
    body = si.bytes() + b"\x00" * 16
    out.write(bytes([0x80]) + len(body).to_bytes(3, "big") + body)

    ss_code = {8: 1, 16: 4, 24: 6, 32: 7}[bits]
    sr_code = {v: k for k, v in _SAMPLE_RATES.items()}.get(fs)
    frame_no = 0
    for start in range(0, max(n, 1), blocksize):
        blk = ai[start : start + blocksize]
        bs = blk.shape[0]
        if bs == 0:
            break
        w = _BitW()
        w.write(0x3FFE, 14)
        w.write(0, 1)
        w.write(0, 1)          # fixed blocksize strategy
        w.write(7, 4)          # blocksize: 16-bit at header end
        if sr_code is not None:
            w.write(sr_code, 4)
        elif fs < 65536:
            w.write(13, 4)
        else:
            raise ValueError("flac encode: unrepresentable sample rate")
        ch_code = {"independent": nch - 1, "left_side": 8,
                   "right_side": 9, "mid_side": 10}[stereo_mode]
        w.write(ch_code, 4)
        w.write(ss_code, 3)
        w.write(0, 1)
        _utf8_encode_number(w, frame_no)
        w.write(bs - 1, 16)
        if sr_code is None and fs < 65536:
            w.write(fs, 16)
        w.align()
        hdr = w.bytes()
        w = _BitW()
        for byte in hdr:
            w.write(byte, 8)
        w.write(_crc8(hdr), 8)

        if stereo_mode == "independent":
            subs = [(blk[:, c], bits) for c in range(nch)]
        elif stereo_mode == "left_side":
            subs = [(blk[:, 0], bits), (blk[:, 0] - blk[:, 1], bits + 1)]
        elif stereo_mode == "right_side":
            subs = [(blk[:, 0] - blk[:, 1], bits + 1), (blk[:, 1], bits)]
        else:  # mid_side
            s = blk[:, 0] - blk[:, 1]
            m = (blk[:, 0] + blk[:, 1]) >> 1
            subs = [(m, bits), (s, bits + 1)]
        for vals, sb in subs:
            _write_subframe(w, vals, sb, subframe)
        w.align()
        frame = w.bytes()
        w = _BitW()
        for byte in frame:
            w.write(byte, 8)
        w.write(_crc16(frame), 16)
        out.write(w.bytes())
        frame_no += 1

    payload = out.getvalue()
    if isinstance(dst, str):
        with open(dst, "wb") as fh:
            fh.write(payload)
    else:
        dst.write(payload)
