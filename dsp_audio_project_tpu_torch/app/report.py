"""Self-contained HTML analysis report — the reference UI's views, offline.

The reference is a Streamlit app (app.py) with four analysis surfaces; this
module renders the same views into one standalone HTML file (inline SVG +
base64 audio, zero JS dependencies):

  * header "dsp-monitor" with the output rate (A1/A3, app.py:27-32,71)
  * embedded <audio> player with sessionStorage position persistence
    (A3, app.py:63-100)
  * time-domain overlay of x/y/z with display decimation (A7, app.py:183-199)
  * spectral cascade in dB, log-x, 0.5 Hz mask, band-edge markers, optional
    normalized-omega axis (A7, app.py:201-251)
  * 40-sample stem views of x/y/z, per-window peak-normalized (A8,
    app.py:253-303)
  * 1024-point two-sided angular spectrum over [-pi, pi) (A8, app.py:305-343)

The port's ``render_report`` runs the chain and the spectra on the device
of the port's ``AudioPipeline`` (the card unless the caller asks for the
CPU) and takes results to the host only for the SVG, the embedded WAV and
the stems.  A caller that already ran the chain passes its
``PipelineOutputs`` (``outputs=``) and the chain does not run again.
"""
from __future__ import annotations

import base64
import uuid
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..io.signal_io import export_wav
from ..models.chain import AudioPipeline, PipelineOutputs
from ..ops.spectrum import angular_spectrum, magnitude_spectrum
from .svgplot import Figure, decimate_for_display, interactive_script

_BAND_EDGES_HZ = (60.0, 250.0, 2000.0, 4000.0, 6000.0)  # app.py:235

_CSS = """
body { background:#0a0a0a; color:#c8f5c8; font-family:monospace; margin:24px; }
h1 { color:#00ff00; font-size:20px; }
h2 { color:#00dd88; font-size:15px; margin-top:28px; }
.dsp-monitor { background-color:#1e1e1e; color:#00ff00; padding:10px 15px;
  border-radius:5px; font-size:0.9em; border:1px solid #333;
  margin-bottom:15px; display:inline-block; }
audio { width: 100%; max-width: 900px; }
"""

_PLAYER_JS = """
(function() {
  var a = document.getElementById('%(html_id)s');
  var k = '%(storage_key)s';
  a.onloadedmetadata = function() {
    var s = sessionStorage.getItem(k);
    if (s && s !== "null") {
      var t = parseFloat(s);
      if (!isNaN(t) && t < a.duration) { a.currentTime = t; }
    }
  };
  a.ontimeupdate = function() { sessionStorage.setItem(k, a.currentTime); };
})();
"""


def _masked_db(freqs: np.ndarray, mag: np.ndarray):
    # app.py:207-210: drop bins <= 0.5 Hz, convert to dB with 1e-12 floor.
    mask = freqs > 0.5
    return freqs[mask], 20.0 * np.log10(np.asarray(mag)[mask] + 1e-12)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _append_main_charts(parts, x, y, z, fs, fs_out, config, normalized_omega,
                        y_dev, z_dev):
    """A7 overview figures: time-domain overlay + spectral cascade; the
    spectra from the device copies ``y_dev`` and ``z_dev``, x on their
    device."""
    t_in = np.linspace(0, len(x) / fs, len(x))
    t_out = np.linspace(0, len(z) / fs_out, len(z))
    fig_t = Figure("Time-domain evolution", xlabel="time (s)", ylabel="amplitude")
    fig_t.line(decimate_for_display(t_in), decimate_for_display(x),
               "#888888", "x[n] input", opacity=0.4)
    fig_t.line(decimate_for_display(t_out), decimate_for_display(y),
               "#ffd700", "y[n] resampled", opacity=0.8)
    fig_t.line(decimate_for_display(t_out), decimate_for_display(z),
               "#00ff00", "z[n] output", width=1.5)
    parts.append("<h2>Time domain</h2>" + fig_t.render(interactive=True))

    scfg = config.spectrum
    dev = z_dev.device
    f_x, m_x = magnitude_spectrum(x, fs, scfg, device=dev)
    f_y, m_y = magnitude_spectrum(y_dev, fs_out, scfg)
    f_z, m_z = magnitude_spectrum(z_dev, fs_out, scfg)
    fx, dbx = _masked_db(f_x, _host(m_x))
    fy, dby = _masked_db(f_y, _host(m_y))
    fz, dbz = _masked_db(f_z, _host(m_z))
    if normalized_omega:
        # app.py:213-224: omega = 2 pi f / fs; Nyquist maps to pi.
        fx = fx * (2 * np.pi / fs)
        fy = fy * (2 * np.pi / fs_out)
        fz = fz * (2 * np.pi / fs_out)
        xlabel = "normalized frequency (rad/sample), pi = Nyquist"
    else:
        xlabel = "frequency (Hz)"
    fig_f = Figure("Spectral cascade", xlabel=xlabel, ylabel="magnitude (dB)",
                   logx=True)
    fig_f.line(decimate_for_display(fx), decimate_for_display(dbx),
               "#888888", "|X| input", opacity=0.5)
    fig_f.line(decimate_for_display(fy), decimate_for_display(dby),
               "#ffd700", "|Y| resampled", opacity=0.8)
    fig_f.line(decimate_for_display(fz), decimate_for_display(dbz),
               "#00e5ff", "|Z| output", width=1.5)
    limit = np.pi if normalized_omega else fs_out / 2
    for edge in _BAND_EDGES_HZ:
        pos = edge * (2 * np.pi / fs_out) if normalized_omega else edge
        if pos < limit:
            fig_f.vline(pos)
    parts.append("<h2>Frequency domain</h2>" + fig_f.render(interactive=True))


def render_report(
    x,
    fs: int,
    config: PipelineConfig = PipelineConfig(),
    *,
    title: str = "GPU DSP analysis",
    normalized_omega: bool = False,
    stem_time_s: Optional[float] = None,
    include_audio: bool = True,
    main_charts: bool = True,
    outputs: Optional[PipelineOutputs] = None,
    device=None,
) -> str:
    """Process ``x`` (a 1-D signal) through the configured chain and render
    the full report.

    ``main_charts=False`` skips the time/frequency overview figures — the
    webapp uses it when plotly is present and renders those two views as
    native plotly charts (A7 interactivity) above the embedded report.
    ``outputs``: the ``PipelineOutputs`` of ``AudioPipeline(config)(x, fs)``
    when the caller already has them; the chain then does not run, and the
    spectra run on their device.  Otherwise the chain runs on ``device``
    (None: a tensor's own device, else the card; "cpu" on request).
    """
    if outputs is None:
        if device is None and isinstance(x, torch.Tensor):
            device = x.device
        outputs = AudioPipeline(config, device=device)(x, fs,
                                                       with_spectra=False)
    x = _host(x)
    y_dev, z_dev = outputs.resampled, outputs.output
    dev = z_dev.device
    y, z = _host(y_dev), _host(z_dev)
    fs_out = outputs.fs_out
    session = uuid.uuid4().hex[:12]

    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{title}</title><style>{_CSS}</style></head><body>",
        f"<h1>{title}</h1>",
        f"<div class='dsp-monitor'>Fs_in: {fs} Hz &nbsp; Fs_out: {fs_out} Hz "
        f"&nbsp; N_in: {len(x)} &nbsp; N_out: {len(z)} &nbsp; "
        f"SRC: L={config.src.L}/M={config.src.M} &nbsp; "
        f"EQ: {'bypass' if config.eq.bypass else 'active'}</div>",
    ]

    # --- audio player (A3/A9) ------------------------------------------
    if include_audio:
        wav = export_wav(z, fs_out)
        b64 = base64.b64encode(wav).decode()
        html_id = f"audio_{session}"
        parts.append("<h2>Processed audio</h2>")
        parts.append(
            f"<audio id='{html_id}' controls>"
            f"<source src='data:audio/wav;base64,{b64}' type='audio/wav'>"
            f"</audio>"
        )
        parts.append("<script>%s</script>" % (
            _PLAYER_JS % dict(html_id=html_id, storage_key=f"time_{session}")
        ))

    # --- time domain (A7 tab 1) ----------------------------------------
    if main_charts:
        _append_main_charts(parts, x, y, z, fs, fs_out, config,
                            normalized_omega, y_dev, z_dev)

    # --- stem views (A8) ------------------------------------------------
    duration = len(x) / fs
    t_sel = duration / 2.0 if stem_time_s is None else float(stem_time_s)
    c = int(t_sel * fs)
    n_stem = 40
    if c + n_stem > len(x):
        c = max(0, len(x) - n_stem)
    ratio = fs_out / fs
    c_out = int(c * ratio)
    m_out = int(n_stem * ratio)
    if c_out + m_out > len(y):
        c_out = max(0, len(y) - m_out)
    x_s = x[c : c + n_stem]
    y_s = y[c_out : c_out + m_out]
    z_s = z[c_out : c_out + m_out]

    def _norm(v):
        peak = np.max(np.abs(v)) if len(v) else 0.0
        return v / peak if peak > 0 else v

    parts.append(f"<h2>Discrete sequences (40-sample zoom at t = {t_sel:.2f}s)</h2>")
    out_axis = np.linspace(0, len(x_s), len(y_s)) if len(y_s) else np.array([])
    for name, axis, vals, color in (
        (f"input x[n]", np.arange(len(x_s)), _norm(x_s), "#cccccc"),
        ("intermediate y[n] (SRC)", out_axis, _norm(y_s), "#ffd700"),
        ("output z[n] (EQ)", out_axis, _norm(z_s), "#00ff00"),
    ):
        fig = Figure(name, xlabel="n (relative samples)",
                     ylabel="norm. amp.", height=200)
        fig.stem(axis, vals, color)
        parts.append(fig.render(interactive=True))

    # --- angular spectrum (A8, app.py:305-343) --------------------------
    n_fft = 1024
    start = max(0, c - n_fft // 2)
    end = min(len(x), start + n_fft)
    seg_in = x[start:end]
    if len(seg_in) < n_fft:
        seg_in = np.pad(seg_in, (0, n_fft - len(seg_in)))
    start_out = int(start * ratio)
    len_out = int(n_fft * ratio)
    if start_out + len_out > len(z):
        start_out = max(0, len(z) - len_out)
    seg_y = y[start_out : start_out + len_out]
    seg_z = z[start_out : start_out + len_out]

    fig_w = Figure("Angular spectrum (-pi..pi)", xlabel="omega (rad/sample)",
                   ylabel="magnitude (dB)")
    w_x, a_x = angular_spectrum(_pad_pow2(seg_in), device=dev)
    fig_w.line(w_x, 20 * np.log10(_host(a_x) + 1e-9), "#888888",
               "x[n]", opacity=0.4, dash="4,3")
    if len(seg_y) >= 2:
        w_y, a_y = angular_spectrum(_pad_pow2(seg_y), device=dev)
        fig_w.line(w_y, 20 * np.log10(_host(a_y) + 1e-9), "#ffa500",
                   "y[n]", opacity=0.6)
        w_z, a_z = angular_spectrum(_pad_pow2(seg_z), device=dev)
        fig_w.line(w_z, 20 * np.log10(_host(a_z) + 1e-9), "#00ff00",
                   "z[n]", opacity=0.8)
    parts.append("<h2>Angular spectrum</h2>" + fig_w.render(interactive=True))

    # Zoom/pan/hover on every chart, view persisted per browser session
    # (the plotly uirevision analog, app.py:186-199).  Self-contained JS.
    parts.append(interactive_script(session))
    parts.append("</body></html>")
    return "".join(parts)


def _pad_pow2(seg: np.ndarray) -> np.ndarray:
    n = len(seg)
    target = 1 << max(1, (n - 1)).bit_length()
    if target != n:
        seg = np.pad(seg, (0, target - n))
    return seg.astype(np.float32)


def write_report(path: str, x, fs: int,
                 config: PipelineConfig = PipelineConfig(), **kw) -> None:
    """``render_report(x, fs, config, **kw)`` written to ``path``."""
    html = render_report(x, fs, config, **kw)
    with open(path, "w") as fh:
        fh.write(html)
