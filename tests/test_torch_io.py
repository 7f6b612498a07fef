"""The port's codecs and signal conditioning vs the JAX package's, byte for
byte (writes) and bit for bit (reads).

The port carries its own copies of ``io/wavio.py``, ``aiffio.py``,
``flacio.py`` and ``signal_io.py`` (importing the JAX modules would import
jax).  Same numpy code on the same inputs, so the tolerance is zero: every
encoded stream must be the same bytes, every decode the same array (dtype,
shape, bits) and rate, and every rejection the same exception type.  The
cases follow tests/test_io.py, test_flac.py and test_codec_fuzz.py:
truncation sweeps, seeded mutation fuzz, a bogus block align, zero
channels, oversized chunk sizes, a short extensible fmt, the 80-bit AIFF
rates and the 100-zero fallback on garbage.  The JAX side always decodes
with ``engine="numpy"``; the port's native engine is held against it in
tests/test_torch_native.py.
"""
from __future__ import annotations

import io
import struct

import numpy as np
import pytest

from dsp_audio_project_tpu.io import aiffio as jaiff
from dsp_audio_project_tpu.io import flacio as jflac
from dsp_audio_project_tpu.io import signal_io as jsig
from dsp_audio_project_tpu.io import wavio as jwav
from dsp_audio_project_tpu_torch.io import aiffio as taiff
from dsp_audio_project_tpu_torch.io import flacio as tflac
from dsp_audio_project_tpu_torch.io import signal_io as tsig
from dsp_audio_project_tpu_torch.io import wavio as twav

_OK_ERRORS = (ValueError, struct.error)


def _bytes(write, *args, **kw) -> bytes:
    buf = io.BytesIO()
    write(buf, *args, **kw)
    return buf.getvalue()


def _same(a, b) -> None:
    """Two (samples, fs) results identical: rate, dtype, shape and bits."""
    (xa, fa), (xb, fb) = a, b
    assert fa == fb and type(fa) is type(fb)
    xa, xb = np.asarray(xa), np.asarray(xb)
    assert xa.dtype == xb.dtype and xa.shape == xb.shape
    np.testing.assert_array_equal(xa, xb)


def _verdicts(jax_fn, port_fn, blob) -> str:
    """Both decoders on ``blob``: the same result or the same exception
    type; returns 'ok' or 'err'."""
    try:
        want = jax_fn(blob)
    except _OK_ERRORS as e:
        with pytest.raises(type(e)):
            port_fn(blob)
        return "err"
    _same(want, port_fn(blob))
    return "ok"


def _wav_blob(fmt_fields, payload: bytes, extra_fmt: bytes = b"") -> bytes:
    fmt = struct.pack("<HHIIHH", *fmt_fields) + extra_fmt
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload))
            + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(payload)) + payload)


def _valid_wav(n=200, channels=2, dtype=np.int16, fs=8000) -> bytes:
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, channels)) * 0.4
    x = (x * 30000).astype(np.int16) if dtype == np.int16 else x.astype(dtype)
    return _bytes(jwav.write_wav, fs, x)


# ---- WAV -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int16_mono", "int16_stereo", "float32",
                                  "float64", "int32_as_float32"])
def test_write_wav_bytes_match(kind):
    rng = np.random.default_rng(11)
    x = {
        "int16_mono": (rng.standard_normal(777) * 9000).astype(np.int16),
        "int16_stereo": (rng.standard_normal((500, 2)) * 9000).astype(np.int16),
        "float32": (rng.standard_normal((300, 3)) * 0.3).astype(np.float32),
        "float64": rng.standard_normal((400, 2)),
        "int32_as_float32": rng.integers(-5, 5, 100).astype(np.int32),
    }[kind]
    blob = _bytes(twav.write_wav, 44100, x)
    assert blob == _bytes(jwav.write_wav, 44100, x)
    _same(jwav.read_wav(blob), twav.read_wav(blob))


def _pcm24_payload(vals) -> bytes:
    return b"".join(struct.pack("<I", v & 0xFFFFFFFF)[:3] for v in vals)


_READ_CASES = {
    "pcm8": ((1, 2, 8000, 16000, 2, 8), bytes(range(0, 256, 3))),
    "pcm16": ((1, 1, 22050, 44100, 2, 16),
              struct.pack("<5h", 0, 1, -1, 32767, -32768)),
    "pcm24": ((1, 1, 8000, 24000, 3, 24),
              _pcm24_payload([0, 1, -1, (1 << 23) - 1, -(1 << 23)])),
    "pcm32": ((1, 2, 48000, 384000, 8, 32),
              struct.pack("<4i", 0, 2**31 - 1, -2**31, 12345)),
    "float32": ((3, 1, 16000, 64000, 4, 32),
                np.array([0.5, -0.25, 1.5], "<f4").tobytes()),
    "float64": ((3, 1, 16000, 128000, 8, 64),
                np.array([0.5, -0.25, 1e-9], "<f8").tobytes()),
    "odd_data": ((1, 1, 8000, 16000, 2, 16), b"\x01\x02\x03"),
}


@pytest.mark.parametrize("case", sorted(_READ_CASES))
def test_read_wav_matches(case):
    fields, payload = _READ_CASES[case]
    blob = _wav_blob(fields, payload)
    assert _verdicts(jwav.read_wav, twav.read_wav, blob) == "ok"


def test_read_wav_extensible_and_unknown_chunks():
    # WAVE_FORMAT_EXTENSIBLE: a 40-byte fmt whose sub-format names PCM.
    ext = struct.pack("<HHI", 22, 16, 3) + struct.pack("<H", 1) + b"\0" * 14
    blob = _wav_blob((0xFFFE, 1, 8000, 16000, 2, 16),
                     struct.pack("<3h", 5, -5, 300), ext)
    assert _verdicts(jwav.read_wav, twav.read_wav, blob) == "ok"
    # A LIST chunk (odd size, padded) between fmt and data.
    raw = _valid_wav(64, 1)
    junk = b"LIST" + struct.pack("<I", 5) + b"junk1\0"
    patched = raw[:36] + junk + raw[36:]
    assert _verdicts(jwav.read_wav, twav.read_wav, patched) == "ok"


def test_wav_truncation_sweep():
    blob = _valid_wav()
    for cut in range(0, len(blob), 7):
        _verdicts(jwav.read_wav, twav.read_wav, blob[:cut])


def test_wav_bogus_block_align():
    blob = _valid_wav(channels=2)
    for bogus in (0, 1, 2, 3, 5, 65535):
        b = bytearray(blob)
        struct.pack_into("<H", b, 12 + 8 + 12, bogus)
        assert _verdicts(jwav.read_wav, twav.read_wav, bytes(b)) == "err"


def test_wav_zero_channels():
    b = bytearray(_valid_wav())
    struct.pack_into("<H", b, 12 + 8 + 2, 0)
    assert _verdicts(jwav.read_wav, twav.read_wav, bytes(b)) == "err"


def test_wav_oversized_chunk_sizes():
    blob = _valid_wav()
    off = blob.index(b"data") + 4
    for huge in (0xFFFFFFFF, 0x7FFFFFFF, len(blob) * 2):
        b = bytearray(blob)
        struct.pack_into("<I", b, off, huge)
        _verdicts(jwav.read_wav, twav.read_wav, bytes(b))
    b = bytearray(blob)
    struct.pack_into("<I", b, 12 + 4, 4)   # fmt too small for its header
    assert _verdicts(jwav.read_wav, twav.read_wav, bytes(b)) == "err"


def test_wav_extensible_short_fmt():
    b = bytearray(_valid_wav())
    struct.pack_into("<H", b, 12 + 8, 0xFFFE)
    assert _verdicts(jwav.read_wav, twav.read_wav, bytes(b)) == "err"


def test_wav_mutation_fuzz():
    rng = np.random.default_rng(1234)
    corpus = [_valid_wav(), _valid_wav(channels=1, dtype=np.float32),
              _valid_wav(channels=3, dtype=np.float64)]
    for _ in range(200):
        base = bytearray(corpus[rng.integers(len(corpus))])
        for _ in range(rng.integers(1, 4)):
            base[rng.integers(len(base))] = rng.integers(256)
        _verdicts(jwav.read_wav, twav.read_wav, bytes(base))


# ---- AIFF ----------------------------------------------------------------

def _aiff_blob(bits: int, channels: int, payload: bytes, fs=22050.0,
               n_frames=None) -> bytes:
    frame = channels * bits // 8
    n = len(payload) // frame if n_frames is None else n_frames
    comm = struct.pack(">hIh", channels, n, bits) + taiff._ext80_encode(fs)
    ssnd = struct.pack(">II", 0, 0) + payload
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    return b"FORM" + struct.pack(">I", len(body)) + body


@pytest.mark.parametrize("kind", ["int16_stereo", "float_mono"])
def test_write_aiff_bytes_match(kind):
    rng = np.random.default_rng(9)
    x = ((rng.standard_normal((400, 2)) * 20000).astype(np.int16)
         if kind == "int16_stereo" else rng.standard_normal(300) * 0.7)
    blob = _bytes(taiff.write_aiff, 22050, x)
    assert blob == _bytes(jaiff.write_aiff, 22050, x)
    _same(jaiff.read_aiff(blob), taiff.read_aiff(blob))


@pytest.mark.parametrize("bits", [8, 16, 24, 32])
def test_read_aiff_bit_depths(bits):
    rng = np.random.default_rng(bits)
    payload = rng.integers(0, 256, 2 * (bits // 8) * 50, dtype=np.uint8)
    blob = _aiff_blob(bits, 2, payload.tobytes())
    assert _verdicts(jaiff.read_aiff, taiff.read_aiff, blob) == "ok"
    # A COMM frame count beyond the data reads what is there.
    short = _aiff_blob(bits, 2, payload.tobytes(), n_frames=10_000)
    assert _verdicts(jaiff.read_aiff, taiff.read_aiff, short) == "ok"


def test_aiff_ext80_rates():
    for fs in (8000, 11025, 16000, 22050, 44100, 48000, 96000, 192000,
               12345.5, 0.0):
        enc = taiff._ext80_encode(float(fs))
        assert enc == jaiff._ext80_encode(float(fs))
        assert taiff._ext80_decode(enc) == jaiff._ext80_decode(enc) == fs


def test_aiff_fuzz():
    x = (np.sin(np.arange(300) * 0.1) * 20000).astype(np.int16)
    blob = _bytes(jaiff.write_aiff, 44100, x)
    for cut in range(0, len(blob), 11):
        _verdicts(jaiff.read_aiff, taiff.read_aiff, blob[:cut])
    rng = np.random.default_rng(77)
    for _ in range(100):
        b = bytearray(blob)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(len(b))] = rng.integers(256)
        _verdicts(jaiff.read_aiff, taiff.read_aiff, bytes(b))


# ---- FLAC ----------------------------------------------------------------

def _rand_int(rng, n, c, bits):
    lim = 1 << (bits - 1)
    shape = (n,) if c == 1 else (n, c)
    return rng.integers(-lim, lim, size=shape, dtype=np.int64)


def _smooth(n, scale=3000):
    t = np.arange(n)
    return np.stack([(scale * np.sin(2 * np.pi * t / 50)).astype(np.int64),
                     (scale * np.cos(2 * np.pi * t / 37)).astype(np.int64)], 1)


_FLAC_CASES = {
    "verbatim8_mono": dict(bits=8, c=1, subframe="verbatim"),
    "verbatim24_stereo": dict(bits=24, c=2, subframe="verbatim"),
    "verbatim32_stereo": dict(bits=32, c=2, subframe="verbatim"),
    "constant": dict(bits=16, c=2, subframe="constant"),
    "fixed": dict(bits=16, c=2, subframe="fixed", smooth=True),
    "auto_mid_side": dict(bits=16, c=2, subframe="auto", smooth=True,
                          stereo_mode="mid_side"),
    "left_side": dict(bits=16, c=2, subframe="verbatim",
                      stereo_mode="left_side"),
    "right_side": dict(bits=16, c=2, subframe="verbatim",
                       stereo_mode="right_side"),
    "odd_rate_multiframe": dict(bits=16, c=1, subframe="auto", fs=12345,
                                blocksize=1024, n=5000),
}


@pytest.mark.parametrize("case", sorted(_FLAC_CASES))
def test_flac_bytes_and_decode_match(case):
    kw = dict(_FLAC_CASES[case])
    bits, c = kw.pop("bits"), kw.pop("c")
    n = kw.pop("n", 700)
    fs = kw.pop("fs", 44100)
    rng = np.random.default_rng(5)
    if kw.pop("smooth", False):
        x = _smooth(n)
    elif kw["subframe"] == "constant":
        x = np.full((n, c), -123, dtype=np.int64)
    else:
        x = _rand_int(rng, n, c, bits)
    kw.setdefault("blocksize", 256)
    blob = _bytes(tflac.write_flac, fs, x, bits=bits, **kw)
    assert blob == _bytes(jflac.write_flac, fs, x, bits=bits, **kw)
    assert _verdicts(jflac.read_flac, tflac.read_flac, blob) == "ok"
    y, got_fs = tflac.read_flac(blob)
    assert got_fs == fs
    np.testing.assert_array_equal(np.asarray(y) * (1 << (bits - 1)), x)


def _lpc_subframe(w, samples, bps, mode):
    """An order-2 LPC subframe (precision 5, shift 1, coefficients 4, -2:
    the second-order fixed predictor): the fixture encoder has no LPC."""
    vals = [int(v) for v in samples]
    w.write(0, 1)
    w.write(32 + 1, 6)               # LPC, order 2
    w.write(0, 1)
    for v in vals[:2]:
        w.write(v, bps)
    w.write(5 - 1, 4)                # coefficient precision
    w.write(1, 5)                    # shift
    for c in (4, -2):
        w.write(c, 5)
    resid = [vals[i] - 2 * vals[i - 1] + vals[i - 2]
             for i in range(2, len(vals))]
    tflac._write_residual(w, resid, 8)


def test_flac_lpc_subframes_match(monkeypatch):
    x = _smooth(600)
    monkeypatch.setattr(tflac, "_write_subframe", _lpc_subframe)
    blob = _bytes(tflac.write_flac, 48000, x, bits=16, blocksize=192)
    monkeypatch.undo()
    assert _verdicts(jflac.read_flac, tflac.read_flac, blob) == "ok"
    np.testing.assert_array_equal(
        np.asarray(tflac.read_flac(blob)[0]) * (1 << 15), x)


def test_flac_truncation_and_mutation_fuzz():
    rng = np.random.default_rng(3)
    blob = _bytes(jflac.write_flac, 44100, _rand_int(rng, 400, 2, 16),
                  bits=16, blocksize=128)
    for cut in list(range(0, 60)) + list(range(60, len(blob), 97)):
        _verdicts(jflac.read_flac, tflac.read_flac, blob[:cut])
    base = _bytes(jflac.write_flac, 44100, _smooth(300), bits=16,
                  blocksize=192)
    for _ in range(100):
        b = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        _verdicts(jflac.read_flac, tflac.read_flac, bytes(b))


def test_flac_crc_rejections_match():
    blob = _bytes(jflac.write_flac, 44100, _smooth(500), bits=16,
                  blocksize=256)
    start = 4 + 4 + 34
    hits = 0
    for off in range(start, start + 64):
        b = bytearray(blob)
        b[off] ^= 0x40
        hits += _verdicts(jflac.read_flac, tflac.read_flac, bytes(b)) == "err"
    assert hits >= 60


# ---- load_signal / export_wav ---------------------------------------------

def _sources():
    rng = np.random.default_rng(21)
    st16 = (rng.standard_normal((3000, 2)) * 9000).astype(np.int16)
    quiet = np.full(100, 1e-8, dtype=np.float32)
    return {
        "wav_stereo16": _bytes(jwav.write_wav, 44100, st16),
        "wav_float_3ch": _bytes(jwav.write_wav, 8000,
                                rng.standard_normal((300, 3)) * 0.3),
        "wav_quiet": _bytes(jwav.write_wav, 8000, quiet),
        "aiff": _bytes(jaiff.write_aiff, 22050, st16),
        "flac": _bytes(jflac.write_flac, 44100, st16.astype(np.int64)),
        "riff_garbage": b"RIFF\x10\x00\x00\x00WAVEjunkjunk",
        "form_garbage": b"FORMgarbage",
        "flac_garbage": b"fLaC" + b"\x00" * 64,
        "empty": b"",
    }


@pytest.mark.parametrize("engine", ["numpy", "auto"])
@pytest.mark.parametrize("mono", [True, False])
def test_load_signal_matches(mono, engine, tmp_path):
    for name, blob in _sources().items():
        want = jsig.load_signal(blob, mono=mono, engine="numpy")
        _same(want, tsig.load_signal(blob, mono=mono, engine=engine))
        if name.endswith("garbage") or name == "empty":
            x, fs = want
            assert fs == 44100 and x.shape[-1] == 100 and not x.any()
    path = tmp_path / "in.wav"
    path.write_bytes(_sources()["wav_stereo16"])
    _same(jsig.load_signal(str(path), mono=mono, engine="numpy"),
          tsig.load_signal(str(path), mono=mono, engine=engine))
    with open(path, "rb") as fh:
        _same(jsig.load_signal(str(path), mono=mono, engine="numpy"),
              tsig.load_signal(fh, mono=mono, engine=engine))
    _same(jsig.load_signal(str(tmp_path / "missing.wav"), mono=mono,
                           engine="numpy"),
          tsig.load_signal(str(tmp_path / "missing.wav"), mono=mono,
                           engine=engine))


@pytest.mark.parametrize("kind", ["mono_nan", "multichannel", "zeros",
                                  "inf", "float32_peak"])
def test_export_wav_bytes_match(kind, tmp_path):
    rng = np.random.default_rng(8)
    z = {
        "mono_nan": rng.standard_normal(500) * 3.0,
        "multichannel": rng.standard_normal((3, 400)).astype(np.float32),
        "zeros": np.zeros(64),
        "inf": np.array([0.1, np.inf, -0.5, -np.inf, np.nan]),
        "float32_peak": (rng.standard_normal(1000) * 0.7).astype(np.float32),
    }[kind]
    if kind == "mono_nan":
        z[10] = np.nan
    blob = tsig.export_wav(z, 22050)
    assert blob == jsig.export_wav(z, 22050)
    tsig.export_wav(z, 22050, str(tmp_path / "t.wav"))
    assert (tmp_path / "t.wav").read_bytes() == blob


def test_examples_match(tmp_path):
    for kind in tsig.EXAMPLE_KINDS:
        _same(jsig.example_signal(kind, 0.05, 8000),
              tsig.example_signal(kind, 0.05, 8000))
    with pytest.raises(ValueError):
        tsig.example_signal("bogus")
    exdir = tmp_path / "examples"
    exdir.mkdir()
    x = (0.5 * np.random.default_rng(2).standard_normal(512) * 32767)
    twav.write_wav(str(exdir / "FastCar.wav"), 22050, x.astype(np.int16))
    (exdir / "notes.txt").write_text("not audio")
    assert (tsig.list_example_files(str(exdir))
            == jsig.list_example_files(str(exdir)))
    _same(jsig.load_signal(str(exdir / "FastCar.wav"), engine="numpy"),
          tsig.resolve_example("fastcar", str(exdir)))
    with pytest.raises(ValueError, match="available"):
        tsig.resolve_example("nope", str(exdir))
