"""Command-line pipeline driver on the GPU.

The port's counterpart of the JAX package's CLI, with the same flags and
exit codes, plus ``--device``: the processing surface of the reference's
Streamlit app (app.py) — SRC factors, six EQ gains, optional 15 s center
window, WAV out, spectrum dump, HTML report — as a library-backed batch
tool:

    python -m dsp_audio_project_tpu_torch.cli in.wav out.wav \\
        --expand 160 --decimate 147 --gain Bass=6 --gain Presence=-4

It runs on the card (``--device cpu`` on request; without a card and
without it, it exits 1 with the device rule's message).  Routes: one-shot
``AudioPipeline(cfg, device=...)(x, fs)`` (the frames path where it
applies); ``--mesh CxB`` ``run_sharded`` over ``build_mesh``;
``--stream-chunk`` ``ShardedStreamProcessor``.  Widget bounds from the
reference UI (L, M in [1, 8]; gains in [-15, 15] dB, app.py:149-159) are
enforced by default; --no-ui-bounds lifts them (the math supports any
factors).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .config import (
    DEFAULT_BAND_NAMES,
    GAIN_DB_MAX,
    GAIN_DB_MIN,
    SRC_FACTOR_MAX,
    SRC_FACTOR_MIN,
    EQConfig,
    MeshConfig,
    PipelineConfig,
    SRCConfig,
)
from .io.signal_io import export_wav, load_signal
from .models.chain import AudioPipeline, PipelineOutputs
from .ops.spectrum import magnitude_spectrum
from .utils.device import default_device

# The most shards a --device cpu mesh may hold: the JAX tests' 8 forced host
# devices.
CPU_MESH_MAX = 8


def _parse_gain(text: str):
    name, _, value = text.partition("=")
    name = name.strip()
    if name not in DEFAULT_BAND_NAMES:
        raise argparse.ArgumentTypeError(
            f"unknown band {name!r}; expected one of {DEFAULT_BAND_NAMES}"
        )
    return name, float(value)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dsp_audio_project_tpu_torch",
        description="GPU audio pipeline: sample-rate conversion + 6-band EQ",
    )
    p.add_argument(
        "input",
        nargs="?",
        help="input WAV/AIFF/FLAC path, or an example source: example:tones "
             "| example:sweep | example:noise | example:<file in examples/>",
    )
    p.add_argument("output", nargs="?", help="output WAV path")
    p.add_argument("--expand", "-L", type=int, default=1, help="upsampling factor L")
    p.add_argument("--decimate", "-M", type=int, default=1, help="downsampling factor M")
    p.add_argument(
        "--gain", "-g", action="append", type=_parse_gain, default=[],
        metavar="BAND=DB", help="EQ band gain, e.g. 'Bass=6' (repeatable)",
    )
    p.add_argument(
        "--window-seconds", type=float, default=None,
        help="analyze only a centered window of this many seconds "
             "(reference's 15 s analysis window, app.py:137-145)",
    )
    p.add_argument(
        "--spectra", metavar="JSON_PATH",
        help="write input/resampled/output magnitude spectra as JSON",
    )
    p.add_argument(
        "--report", metavar="HTML_PATH",
        help="write a self-contained HTML analysis report (time/frequency/"
             "stem/angular views + audio player)",
    )
    p.add_argument(
        "--report-omega", action="store_true",
        help="use the normalized-omega (rad/sample) frequency axis in the report",
    )
    p.add_argument(
        "--no-ui-bounds", action="store_true",
        help="lift the reference UI's L,M<=8 and |gain|<=15 dB bounds",
    )
    p.add_argument(
        "--multichannel", action="store_true",
        help="keep channels separate (reference mixes to mono); processes "
             "all channels as a batch and writes a multichannel WAV",
    )
    p.add_argument(
        "--mesh", metavar="CxB", default=None,
        help="shard over a device mesh: C channel-parallel x B time-block "
             "shards (e.g. --mesh 2x4); on the card C*B <= the number of "
             f"visible CUDA devices, with --device cpu a virtual mesh of "
             f"C*B <= {CPU_MESH_MAX} shards on the CPU",
    )
    p.add_argument(
        "--stream-chunk", metavar="SECONDS", type=float, default=None,
        help="process the signal as a stream of chunks of this many seconds "
             "through the checkpointable streaming engine (consistent "
             "with one-shot; combine with --mesh to shard the super-steps)",
    )
    p.add_argument(
        "--device", default=None,
        help="where the chain runs: the card by default (exit 1 without "
             "one), 'cpu' on request (the kernels' plain versions)",
    )
    p.add_argument(
        "--examples-dir", metavar="DIR", default=None,
        help="directory of example audio files for example:<name> sources "
             "(default: $DSP_EXAMPLES_DIR or ./examples)",
    )
    p.add_argument(
        "--list-examples", action="store_true",
        help="list available example sources (built-in + on-disk) and exit",
    )
    return p


def _parse_mesh(text: str):
    """CxB with C, B >= 1, or None on malformed input."""
    c, sep, b = text.lower().partition("x")
    try:
        mc, mb = int(c), int(b)
    except ValueError:
        return None
    if not sep or mc < 1 or mb < 1:
        return None
    return mc, mb


def _mesh(text: str, device: torch.device):
    """The --mesh mesh on ``device``, or an error message: real cards on the
    GPU (C*B <= the visible count), a virtual mesh on the CPU (C*B <=
    CPU_MESH_MAX)."""
    from .parallel.mesh import build_mesh

    parsed = _parse_mesh(text)
    if parsed is None:
        return None, (f"--mesh expects CxB with C,B >= 1 (e.g. 2x4), got "
                      f"{text!r}")
    mc, mb = parsed
    if device.type == "cpu":
        have, devices = CPU_MESH_MAX, ["cpu"] * (mc * mb)
    else:
        have, devices = torch.cuda.device_count(), None
    if mc * mb > have:
        return None, f"mesh {mc}x{mb} needs {mc * mb} devices, have {have}"
    cfg = MeshConfig(channel_devices=mc, block_devices=mb)
    return build_mesh(cfg, devices=devices), None


def _spectra_json(path: str, spectra) -> None:
    payload = {
        key: {"freqs_hz": f.tolist(), "magnitude": m.cpu().numpy().tolist()}
        for key, (f, m) in spectra.items()
    }
    with open(path, "w") as fh:
        json.dump(payload, fh)


def _run_streaming(args, cfg, x, fs, device) -> int:
    """--stream-chunk: chunked processing through ShardedStreamProcessor.

    Consistent with the one-shot chain for any chunk size (held by
    tests/test_torch_app.py); --mesh shards each super-step.  The streamed
    engine emits only z (the EQ output); a --spectra request computes the
    resampled view from the signal's analysis prefix (the spectra read at
    most ``analysis_limit`` samples, app.py:202).
    """
    from .ops.src import resample
    from .parallel.mesh import single_device_mesh
    from .streaming import ShardedStreamProcessor

    if args.mesh:
        mesh, err = _mesh(args.mesh, device)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
    else:
        mesh = single_device_mesh(device)
    mc, mb = len(mesh.devices), len(mesh.devices[0])
    x2 = np.atleast_2d(np.asarray(x))
    chunk = max(1, int(args.stream_chunk * fs))
    sp = ShardedStreamProcessor(cfg, fs, mesh, x2.shape[0])
    outs = [
        sp.process(x2[:, pos : pos + chunk])
        for pos in range(0, x2.shape[1], chunk)
    ]
    outs.append(sp.flush())
    z = np.concatenate(outs, axis=1)
    fs_out = cfg.src.output_rate(fs)
    if x.ndim == 1:
        z = z[0]

    n_chunks = -(-x2.shape[1] // chunk)
    ch = f"{x2.shape[0]}ch " if x.ndim == 2 else ""
    print(
        f"{args.input}: {ch}{x2.shape[1]} samples @ {fs} Hz -> "
        f"{z.shape[-1]} samples @ {fs_out} Hz "
        f"(streamed, {n_chunks} chunks of {chunk}, mesh {mc}x{mb}, "
        f"L={args.expand}, M={args.decimate})"
    )
    if args.output:
        export_wav(z, fs_out, args.output)
        print(f"wrote {args.output}")
    if args.spectra:
        scfg = cfg.spectrum
        cap = scfg.analysis_limit or x2.shape[1]
        # The resampled view's spectrum reads y[:cap]; compute it from the
        # input prefix that fully determines it ('same' centering reads
        # ahead by at most the filter width).
        n_need = min(
            x2.shape[1], -(-cap * cfg.src.M) // max(1, cfg.src.L)
            + cfg.src.num_taps
        )
        y_head = resample(x2[:, :n_need], fs, cfg.src,
                          device=device)[0][:, :cap]
        if x.ndim == 1:
            y_head = y_head[0]
        _spectra_json(args.spectra, {
            "input": magnitude_spectrum(x, fs, scfg, device=device),
            "resampled": magnitude_spectrum(y_head, fs_out, scfg),
            "output": magnitude_spectrum(z, fs_out, scfg, device=device),
        })
        print(f"wrote {args.spectra}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_examples:
        # Example browsing — the reference lists examples/*.wav from disk
        # (app.py:123-126); built-in synthesized kinds cover the stripped
        # fixtures.
        import os

        from .io.signal_io import EXAMPLE_KINDS, list_example_files

        for kind in EXAMPLE_KINDS:
            print(f"example:{kind}\t(built-in)")
        for path in list_example_files(args.examples_dir):
            print(f"example:{os.path.basename(path)}\t({path})")
        return 0

    if args.input is None:
        print("error: input is required (or use --list-examples)",
              file=sys.stderr)
        return 2

    if not args.no_ui_bounds:
        for v, what in ((args.expand, "L"), (args.decimate, "M")):
            if not SRC_FACTOR_MIN <= v <= SRC_FACTOR_MAX:
                print(
                    f"error: {what}={v} outside UI bounds "
                    f"[{SRC_FACTOR_MIN},{SRC_FACTOR_MAX}] "
                    "(use --no-ui-bounds to lift)",
                    file=sys.stderr,
                )
                return 2
        for name, g in args.gain:
            if not GAIN_DB_MIN <= g <= GAIN_DB_MAX:
                print(
                    f"error: gain {name}={g} outside [{GAIN_DB_MIN},{GAIN_DB_MAX}] dB",
                    file=sys.stderr,
                )
                return 2

    if args.input.startswith("example:"):
        # Example sources — the reference's examples/*.wav browsing
        # (app.py:123-126): built-in kinds (``example:tones``) or on-disk
        # files from the examples directory (``example:FastCar.wav``).
        from .io.signal_io import resolve_example

        try:
            x, fs = resolve_example(
                args.input.split(":", 1)[1], args.examples_dir
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if args.multichannel:
            x = x[None, :]
    else:
        x, fs = load_signal(args.input, mono=not args.multichannel)
    if args.window_seconds:
        n_win = int(args.window_seconds * fs)
        length = x.shape[-1]
        center = length // 2
        start = max(0, center - n_win // 2)
        x = x[..., start : min(length, start + n_win)]

    try:
        device = (torch.device(args.device) if args.device
                  else default_device("the CLI"))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    cfg = PipelineConfig(
        src=SRCConfig(L=args.expand, M=args.decimate),
        eq=EQConfig.from_gains(dict(args.gain)),
    )
    if args.stream_chunk:
        return _run_streaming(args, cfg, x, fs, device)
    if args.mesh:
        from .parallel.pipeline import run_sharded

        mesh, err = _mesh(args.mesh, device)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        z, y, fs_out, _ = run_sharded(np.atleast_2d(x), fs, cfg, mesh)
        if x.ndim == 1:
            z, y = z[0], y[0]
        spectra = None
        if args.spectra:
            scfg = cfg.spectrum
            spectra = {
                "input": magnitude_spectrum(x, fs, scfg, device=z.device),
                "resampled": magnitude_spectrum(y, fs_out, scfg),
                "output": magnitude_spectrum(z, fs_out, scfg),
            }
        out = PipelineOutputs(output=z, resampled=y, fs_out=fs_out,
                              spectra=spectra)
    else:
        pipe = AudioPipeline(cfg, device=device)
        out = pipe(x, fs, with_spectra=bool(args.spectra))

    ch = f"{x.shape[0]}ch " if x.ndim == 2 else ""
    print(
        f"{args.input}: {ch}{x.shape[-1]} samples @ {fs} Hz -> "
        f"{out.output.shape[-1]} samples @ {out.fs_out} Hz "
        f"(L={args.expand}, M={args.decimate}, "
        f"eq={'on' if not cfg.eq.bypass else 'bypass'})"
    )

    if args.output:
        export_wav(out.output.cpu().numpy(), out.fs_out, args.output)
        print(f"wrote {args.output}")

    if args.report:
        from .app.report import write_report

        # The report analyzes the channel mean, like the app, and runs its
        # own chain on it; a mono run hands over the outputs it has.
        x_rep = x.mean(axis=0) if x.ndim == 2 else x
        write_report(args.report, x_rep, fs, cfg, title=args.input,
                     normalized_omega=args.report_omega, device=device,
                     outputs=None if x.ndim == 2 else out)
        print(f"wrote {args.report}")

    if args.spectra:
        _spectra_json(args.spectra, out.spectra)
        print(f"wrote {args.spectra}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
