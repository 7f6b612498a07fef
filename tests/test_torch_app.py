"""The port's surfaces: ``app/svgplot.py``, ``app/report.py``,
``app/webapp.py`` and the CLI, against the JAX package's where both run.

``svgplot`` is a copy: the same figure renders the same string.  The
report holds its structure (six charts, the player, the monitor line) and
runs the chain once, or not at all when the caller passes the
``PipelineOutputs`` it has.  The CLI runs with ``--device cpu`` (the
kernels' plain versions); without a card and without ``--device`` it exits
1.  One test runs the JAX CLI and the port's on the same short WAV: WAVs
within 1 LSB, spectra >= 100 dB.  Sizes stay at a few thousand samples.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.app import svgplot as jsvg
from dsp_audio_project_tpu_torch import EQConfig, PipelineConfig, SRCConfig
from dsp_audio_project_tpu_torch.app import svgplot as tsvg
from dsp_audio_project_tpu_torch.app.report import render_report
from dsp_audio_project_tpu_torch.cli import main
from dsp_audio_project_tpu_torch.io.wavio import read_wav, write_wav
from dsp_audio_project_tpu_torch.models import chain as tchain
from dsp_audio_project_tpu_torch.oracle import snr_db

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def forward_calls(monkeypatch):
    """Counts ``AudioPipeline.forward`` calls (the chain's runs)."""
    calls = []
    real = tchain.AudioPipeline.forward

    def counted(self, *a, **kw):
        calls.append(a[0].shape)
        return real(self, *a, **kw)

    monkeypatch.setattr(tchain.AudioPipeline, "forward", counted)
    return calls


def _wav(tmp_path, name, x, fs):
    path = str(tmp_path / name)
    write_wav(path, fs, x)
    return path


def _lsb(a: str, b: str) -> float:
    ya, fa = read_wav(a)
    yb, fb = read_wav(b)
    assert fa == fb and ya.shape == yb.shape
    return float(np.max(np.abs(ya - yb)) * 32768)


def _spectra(path):
    with open(path) as fh:
        return json.load(fh)


# ---- svgplot ---------------------------------------------------------------

def _figures(mod):
    mod.Figure._ids = itertools.count()
    f = mod.Figure("t", xlabel="x", ylabel="y", logx=True)
    f.line([1, 10, 100], [0.0, 5.0, -5.0], "#00ff00", "trace", opacity=0.5,
           dash="4,3")
    f.vline(10)
    g = mod.Figure("stems", height=200)
    g.stem(np.arange(40), np.sin(np.arange(40) * 0.3), "#cccccc")
    return [f.render(), f.render(interactive=True), g.render(interactive=True)]


def test_svgplot_matches_jax():
    assert _figures(tsvg) == _figures(jsvg)
    assert tsvg.INTERACTIVE_JS == jsvg.INTERACTIVE_JS
    assert tsvg.interactive_script("abc") == jsvg.interactive_script("abc")
    x = np.arange(10_000)
    np.testing.assert_array_equal(tsvg.decimate_for_display(x, 2500),
                                  jsvg.decimate_for_display(x, 2500))


# ---- report -----------------------------------------------------------------

def test_report_contents(audio_short, forward_calls):
    x, fs = audio_short
    cfg = PipelineConfig(src=SRCConfig(L=1, M=2),
                         eq=EQConfig.from_gains({"Bass": 6}))
    html = render_report(x, fs, cfg, title="t", device="cpu")
    assert len(forward_calls) == 1
    assert html.count("<svg") == 6  # time, freq, 3 stems, angular
    assert html.count('class="iplot"') == 6
    assert "audio/wav;base64" in html and "sessionStorage" in html
    assert f"Fs_out: {fs // 2} Hz" in html and "stroke-dasharray" in html
    # A CPU tensor stays on the CPU without device=.
    slim = render_report(torch.as_tensor(x), fs, cfg, include_audio=False,
                         main_charts=False, normalized_omega=True)
    assert "audio/wav" not in slim and "Spectral cascade" not in slim
    assert "Angular spectrum" in slim and slim.count("<svg") == 4


def test_report_outputs_skip_the_chain(audio_short, forward_calls):
    x, fs = audio_short
    cfg = PipelineConfig(src=SRCConfig(L=3, M=2))
    out = tchain.AudioPipeline(cfg, device="cpu")(x, fs)
    assert len(forward_calls) == 1
    tsvg.Figure._ids = itertools.count()
    given = render_report(x, fs, cfg, outputs=out, normalized_omega=True)
    assert len(forward_calls) == 1     # no second run
    tsvg.Figure._ids = itertools.count()
    again = render_report(x, fs, cfg, device="cpu", normalized_omega=True)
    assert len(forward_calls) == 2
    # The same report but for the random session id.
    same = (given.replace(given.split("audio_")[1][:12], "S")
            == again.replace(again.split("audio_")[1][:12], "S"))
    assert same
    # An array goes to the card by default, and there is none here.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_report(x, fs, cfg)


def test_webapp_import_guard():
    from dsp_audio_project_tpu_torch.app import webapp

    assert not webapp.HAVE_STREAMLIT
    with pytest.raises(SystemExit):
        webapp.main()


class _State(dict):
    __getattr__ = dict.__getitem__
    __setattr__ = dict.__setitem__


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _fake_streamlit(rendered):
    """The calls webapp.main makes, answered as a first visit would be:
    the first example, no window, L = 2, M = 1, every gain 0 but the
    first slider (6 dB), the spectral mode in Hz."""
    sliders = iter([6] + [0] * 5)
    col = types.SimpleNamespace(number_input=lambda label, lo, hi, v:
                                2 if "(L)" in label else 1)
    sidebar = types.SimpleNamespace(
        header=lambda *a: None, subheader=lambda *a: None,
        radio=lambda label, opts: opts[0],
        selectbox=lambda label, opts: opts[0],
        checkbox=lambda *a, **k: False,
        columns=lambda n: (col, col),
        slider=lambda *a, **k: next(sliders),
        file_uploader=lambda *a, **k: None)
    return types.SimpleNamespace(
        set_page_config=lambda **k: None, markdown=lambda *a, **k: None,
        title=lambda *a: None, session_state=_State(),
        sidebar=sidebar, info=lambda *a: None, stop=lambda: None,
        spinner=lambda *a: _Ctx(),
        radio=lambda label, opts, **k: opts[0],
        slider=lambda *a, **k: a[3],
        plotly_chart=lambda *a, **k: None,
        components=types.SimpleNamespace(v1=types.SimpleNamespace(
            html=lambda html, **k: rendered.append(html))),
        download_button=lambda *a, **k: rendered.append(a[1].getvalue()))


def test_webapp_runs_the_chain_once(monkeypatch, forward_calls):
    """The app's render on a stand-in for Streamlit, its pipeline on the
    CPU: one chain run feeds the report, the player and the download."""
    from dsp_audio_project_tpu_torch.app import webapp

    rendered = []
    monkeypatch.setattr(webapp, "st", _fake_streamlit(rendered))
    monkeypatch.setattr(webapp, "HAVE_STREAMLIT", True)
    monkeypatch.setattr(webapp, "_EXAMPLES", {
        "tones": lambda: webapp._synth("tones", 0.2, 8000)})
    monkeypatch.setattr(tchain, "default_device",
                        lambda what: torch.device("cpu"))
    webapp.main()
    assert len(forward_calls) == 1
    html, wav = rendered
    assert "Fs_out: 16000 Hz" in html and "audio/wav;base64" in html
    y, fs = read_wav(wav)
    assert fs == 16000 and len(y) == 3200


# ---- CLI --------------------------------------------------------------------

def test_cli_matches_jax_cli(tmp_path, audio_short, forward_calls, capsys):
    """The JAX CLI and the port's on one WAV: WAVs within 1 LSB, spectra
    >= 100 dB, the same report structure; the port's chain runs once."""
    from dsp_audio_project_tpu.cli import main as jax_main

    x, fs = audio_short
    src = _wav(tmp_path, "in.wav", (x * 30000).astype(np.int16), fs)
    args = ["-L", "2", "-M", "3", "-g", "Bass=6"]
    outs = {}
    for tag, fn, extra in (("jax", jax_main, []),
                           ("port", main, ["--device", "cpu"])):
        paths = [str(tmp_path / f"{tag}.{ext}")
                 for ext in ("wav", "json", "html")]
        assert fn([src, paths[0], *args, "--spectra", paths[1],
                   "--report", paths[2], *extra]) == 0
        outs[tag] = paths
    assert len(forward_calls) == 1     # the report reused the outputs
    assert _lsb(outs["jax"][0], outs["port"][0]) <= 1.0
    want, got = _spectra(outs["jax"][1]), _spectra(outs["port"][1])
    assert set(got) == set(want) == {"input", "resampled", "output"}
    for k in want:
        assert want[k]["freqs_hz"] == got[k]["freqs_hz"]
        assert snr_db(np.array(want[k]["magnitude"]),
                      np.array(got[k]["magnitude"])) >= 100.0, k
    reports = [open(outs[t][2]).read() for t in ("jax", "port")]
    assert [r.count("<svg") for r in reports] == [6, 6]
    monitor = [r.split("dsp-monitor'>")[1].split("</div>")[0]
               for r in reports]
    assert monitor[0] == monitor[1]
    assert os.path.getsize(outs["port"][2]) > 10_000
    lines = capsys.readouterr().out.splitlines()
    assert sum("4096 samples @ 48000 Hz -> 2731 samples @ 32000 Hz" in ln
               for ln in lines) == 2


def test_cli_bounds_and_device_rule(tmp_path, audio_short):
    x, fs = audio_short
    src = _wav(tmp_path, "in.wav", (x * 30000).astype(np.int16), fs)
    assert main([src, "-L", "160", "--device", "cpu"]) == 2
    assert main([src, "-L", "0", "--device", "cpu"]) == 2
    assert main([src, "-g", "Bass=40", "--device", "cpu"]) == 2
    assert main(["--device", "cpu"]) == 2            # no input
    assert main([src, "--mesh", "2y4", "--device", "cpu"]) == 2
    with pytest.raises(SystemExit):                   # argparse: bad band
        main([src, "-g", "Bas=6"])
    # No card and no --device: the device rule's message, exit 1, no file.
    out = str(tmp_path / "never.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "dsp_audio_project_tpu_torch.cli", src, out],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device is visible" in proc.stderr
    assert not os.path.exists(out)


def test_cli_examples(tmp_path, capsys):
    exdir = tmp_path / "examples"
    exdir.mkdir()
    x = (0.5 * np.random.default_rng(3).standard_normal(4096))
    write_wav(str(exdir / "FastCar.wav"), 22050, (x * 32767).astype(np.int16))
    assert main(["--list-examples", "--examples-dir", str(exdir)]) == 0
    listing = capsys.readouterr().out
    assert "example:tones" in listing and "FastCar.wav" in listing
    out = str(tmp_path / "ex.wav")
    assert main(["example:FastCar.wav", out, "--examples-dir", str(exdir),
                 "-L", "2", "--device", "cpu"]) == 0
    y, fs = read_wav(out)
    assert fs == 44100 and len(y) == 8192
    assert main(["example:noise", out, "-M", "2", "--window-seconds", "0.5",
                 "--multichannel", "--device", "cpu"]) == 0
    y, fs = read_wav(out)
    assert fs == 22050 and y.shape == (11025,)
    assert main(["example:bogus", out, "--device", "cpu"]) == 2


def test_cli_multichannel_and_mesh(tmp_path, forward_calls):
    """--multichannel keeps the channels; --mesh 2x4 (a virtual CPU mesh)
    is within 2 LSB of the one-shot run; 9x9 exceeds the CPU cap."""
    fs = 16000
    rng = np.random.default_rng(12)
    stereo = (rng.standard_normal((8000, 2)) * 12000).astype(np.int16)
    src = _wav(tmp_path, "m.wav", stereo, fs)
    one, sharded = str(tmp_path / "one.wav"), str(tmp_path / "mesh.wav")
    rpt = str(tmp_path / "r.html")
    common = ["-L", "3", "-M", "2", "-g", "Bass=6", "--multichannel",
              "--device", "cpu"]
    assert main([src, one, *common, "--report", rpt]) == 0
    # The report analyzes the channel mean: its own chain run.
    assert [s[0] if len(s) == 2 else 1 for s in forward_calls] == [2, 1]
    assert main([src, sharded, *common, "--mesh", "2x4"]) == 0
    y, fs_out = read_wav(one)
    assert fs_out == fs * 3 // 2 and y.shape == (12000, 2)
    assert _lsb(one, sharded) <= 2.0
    assert main([src, sharded, "--mesh", "9x9", "--device", "cpu"]) == 2


def test_cli_stream_chunk(tmp_path):
    """--stream-chunk, alone and on a 1x4 mesh: within 2 LSB of the one-shot
    CLI, and its spectra equal to the one-shot ones."""
    fs = 16000
    mono = (np.random.default_rng(5).standard_normal(24000) * 12000
            ).astype(np.int16)
    src = _wav(tmp_path, "s.wav", mono[:, None], fs)
    common = ["-L", "3", "-M", "2", "-g", "Bass=6", "--device", "cpu"]
    one, spec1 = str(tmp_path / "one.wav"), str(tmp_path / "one.json")
    assert main([src, one, *common, "--spectra", spec1]) == 0
    want = _spectra(spec1)
    for extra in (["--stream-chunk", "0.33"],
                  ["--stream-chunk", "0.25", "--mesh", "1x4"]):
        out, spec = str(tmp_path / "st.wav"), str(tmp_path / "st.json")
        assert main([src, out, *common, *extra, "--spectra", spec]) == 0
        assert _lsb(one, out) <= 2.0
        got = _spectra(spec)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k]["magnitude"],
                                       want[k]["magnitude"], atol=1e-4,
                                       err_msg=k)
    assert main([src, out, *common, "--stream-chunk", "0.25",
                 "--mesh", "4x4"]) == 2
