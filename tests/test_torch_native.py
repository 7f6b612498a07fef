"""The port's native C++ codec vs the numpy codecs, and where and how it
builds.

The port builds its own copy of ``native/wavcodec.cc`` into
``dsp_audio_project_tpu_torch/_build/`` (``io/native.py``).  Its decodes
must equal the port's numpy codec and the JAX package's numpy codec bit for
bit (the cases of tests/test_native.py), and its int16 encoder must equal
``export_wav``'s PCM bit for bit.  The build lands only in the port's
directory, and two processes that build at once both load a whole library.
"""
from __future__ import annotations

import io
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

from dsp_audio_project_tpu.io import signal_io as jsig
from dsp_audio_project_tpu.io.wavio import write_wav as jwrite_wav
from dsp_audio_project_tpu_torch.io import native
from dsp_audio_project_tpu_torch.io import signal_io as tsig

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.fail("the port's native codec did not build (make and g++ "
                    "are on this host)")
    return native.load_library()


def _wav_bytes(samples, fs=44100):
    buf = io.BytesIO()
    jwrite_wav(buf, fs, samples)
    return buf.getvalue()


def _numpy_decodes(data, mono):
    """The port's and the JAX package's numpy decodes, equal to each other."""
    a = tsig.load_signal(data, mono=mono, engine="numpy")
    b = jsig.load_signal(data, mono=mono, engine="numpy")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    return a


@pytest.mark.parametrize("channels", [1, 2, 4])
def test_native_decode_matches_numpy_pcm16(lib, channels):
    rng = np.random.default_rng(channels)
    x = (rng.standard_normal((1000, channels)) * 12000).astype(np.int16)
    data = _wav_bytes(x, 22050)
    got, fs = native.decode(data, mono=True)
    assert fs == 22050 and got.dtype == np.float32
    want, _ = _numpy_decodes(data, mono=True)
    np.testing.assert_array_equal(got, want)
    ref = x.astype(np.float64).mean(axis=1).astype(np.float32)
    np.testing.assert_array_equal(got, ref / np.max(np.abs(ref)))


def test_native_decode_float32(lib):
    x = (np.random.default_rng(5).standard_normal(500) * 0.3).astype(np.float32)
    data = _wav_bytes(x, 48000)
    got, fs = native.decode(data, mono=True)
    assert fs == 48000
    np.testing.assert_array_equal(got, _numpy_decodes(data, mono=True)[0])


def test_native_decode_pcm24(lib):
    vals = [0, 1, -1, (1 << 23) - 1, -(1 << 23)]
    payload = b"".join(struct.pack("<I", v & 0xFFFFFFFF)[:3] for v in vals)
    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 8000 * 3, 3, 24)
    data = (
        b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(payload))
        + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"data" + struct.pack("<I", len(payload)) + payload
    )
    got, _ = native.decode(data, mono=True, normalize=False)
    np.testing.assert_array_equal(
        got, (np.array(vals) / float(1 << 23)).astype(np.float32))
    np.testing.assert_array_equal(native.decode(data, mono=True)[0],
                                  _numpy_decodes(data, mono=True)[0])


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.float64])
def test_native_multichannel_layout(lib, dtype):
    x = np.random.default_rng(3).standard_normal((300, 3)) * 0.4
    x = (x * 30000).astype(np.int16) if dtype == np.int16 else x.astype(dtype)
    data = _wav_bytes(x, 8000)
    got, _ = native.decode(data, mono=False)
    assert got.shape == (3, 300)
    np.testing.assert_array_equal(got, _numpy_decodes(data, mono=False)[0])


@pytest.mark.parametrize("mono", [True, False])
def test_load_signal_auto_uses_native(lib, tmp_path, mono):
    x = (np.random.default_rng(9).standard_normal((2000, 2)) * 9000
         ).astype(np.int16)
    p = str(tmp_path / "n.wav")
    jwrite_wav(p, 16000, x)
    a, fs_a = tsig.load_signal(p, engine="auto", mono=mono)
    b, fs_b = jsig.load_signal(p, engine="numpy", mono=mono)
    assert fs_a == fs_b == 16000
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["random", "nan_inf", "zeros", "mono"])
def test_native_encode_pcm16_matches_export_wav(lib, case):
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, 4000)).astype(np.float32) * 3.0
    if case == "nan_inf":
        z[0, 10], z[1, 20], z[1, 21] = np.nan, np.inf, -np.inf
    elif case == "zeros":
        z[:] = 0.0
    elif case == "mono":
        z = z[0]
    out = native.encode_pcm16(z)
    c = 1 if z.ndim == 1 else z.shape[0]
    assert out.shape == (z.shape[-1], c) and out.dtype == np.int16
    for export_wav in (tsig.export_wav, jsig.export_wav):
        pcm = np.frombuffer(export_wav(z, 44100)[44:], dtype="<i2")
        np.testing.assert_array_equal(out.reshape(-1), pcm)
    if case == "random":
        assert np.abs(out).max() == 32767


def test_native_rejects_garbage(lib):
    with pytest.raises(ValueError):
        native.decode(b"RIFFxxxxWAVEjunkjunkjunk")


def test_native_fuzz_verdicts_match_numpy(lib):
    """Seeded corruption: native and numpy reject the same inputs, and
    decode the rest to the same bits (no crash, no over-read)."""
    rng = np.random.default_rng(1234)
    x = (rng.standard_normal((200, 2)) * 9000).astype(np.int16)
    blob = _wav_bytes(x, 8000)
    cases = [blob[:cut] for cut in range(0, len(blob), 13)]
    for _ in range(150):
        b = bytearray(blob)
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(len(b))] = rng.integers(256)
        cases.append(bytes(b))
    for data in cases:
        try:
            want, _ = jsig.read_wav(data)
        except (ValueError, struct.error):
            want = None
        try:
            got, _ = native.decode(data, mono=False, normalize=False)
        except ValueError:
            got = None
        if want is not None and got is not None:
            want = want.astype(np.float32)
            want = want[None, :] if want.ndim == 1 else want.T
            np.testing.assert_array_equal(got, want)


def test_library_builds_in_the_ports_build_dir(lib):
    path = native.library_path()
    pkg = ROOT / "dsp_audio_project_tpu_torch"
    assert path.parent == pkg / "_build" and path.exists()
    assert lib._name == str(path)
    assert not (ROOT / "dsp_audio_project_tpu") in path.parents
    assert sorted(p.name for p in (pkg / "native").iterdir()) == [
        "Makefile", "wavcodec.cc"]
    flags = [line for line in
             (pkg / "native" / "Makefile").read_text().splitlines()
             if line.startswith("CXXFLAGS")]
    assert len(flags) == 1 and "-O3" in flags[0]
    assert "-march" not in flags[0] and "-mtune" not in flags[0]
    # Git ignores the build directory.
    assert ("dsp_audio_project_tpu_torch/_build/"
            in (ROOT / ".gitignore").read_text().splitlines())


_CONCURRENT = r"""
import pathlib, sys
from dsp_audio_project_tpu_torch.io import native
native.BUILD_DIR = pathlib.Path(sys.argv[1])
sys.stdin.readline()                      # start together
lib = native.load_library()
assert lib is not None and lib._name == str(native.library_path())
out, fs = native.decode(bytes.fromhex(sys.argv[2]), mono=False)
assert fs == 8000 and out.shape == (1, 4), out
assert 'dsp_audio_project_tpu' not in sys.modules and 'jax' not in sys.modules
print("ok")
"""


def test_two_processes_build_at_once(tmp_path):
    data = _wav_bytes(np.array([1, -2, 3, -4], dtype=np.int16), 8000)
    build = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CONCURRENT, str(build), data.hex()],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for _ in range(2)]
    for p in procs:
        p.stdin.write("go\n")
        p.stdin.flush()
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "ok", err
    # One whole library, no temporary left behind.
    assert [p.name for p in build.iterdir()] == [native.library_path().name]
