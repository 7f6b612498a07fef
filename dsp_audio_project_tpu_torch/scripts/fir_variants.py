"""Ablations of the FIR kernel's warpgroup body (``csrc/fir_cat.cu``).

    python -m dsp_audio_project_tpu_torch.scripts.fir_variants [--parent F]

Writes patched copies of ``csrc/fir_cat.cu`` into a temporary directory,
builds them all at once with nvcc (the port's flags) and times each one's
launch through ctypes at three shapes of the main path: K1 at the serving
shape (L/M = 160/147, the 5-band EQ's G2, V = 170, 8 x 60 s), K1 at the
stream's step (FL 12288, pad_left 0, 8 channels) and the frames FIR (G,
V = P = 160) at the serving shape.  The variants:

* ``as built``: the source as it is;
* ``one-step runs`` / ``four-step runs``: FRESH = 1 / 4 k-steps a fresh
  accumulator takes before its fp32 add (one-step runs with ring slots of
  one k-step, six of them, in the same shared memory);
* ``no products``: the three wgmma of each k-step removed (what the rest
  of the kernel costs);
* ``no stores``: the epilogue's global stores skipped;
* ``no turns``: the two consumers issue their products without taking
  turns;
* ``parent``: the file ``--parent`` names (say the parent commit's
  ``fir_cat.cu``), as it is.

Each time is CUDA events over 20 launches after 3 (outputs and scratch
allocated once; a launch is the halves kernel and the FIR kernel), taken
in turns a b ... b a; each variant that computes the function is held
against the fp32 plain version (y0 and inj in dB).  Then the device time of
each kernel of an ``as built`` launch, from ``torch.profiler`` over 20
launches.  Needs the card and nvcc; prints the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import tempfile

import numpy as np
import torch

from ..config import EQConfig, SRCConfig
from ..kernels import _build
from ..kernels.fir_class import (
    _LAUNCHERS, cat_operator, fir_cat_plain, frame_grid,
)
from ..ops.eq import eq_cat_weights, make_block_operators
from ..ops.src import make_plan
from ..utils.deviceprof import profile_device_span

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}
_PRODUCTS = ("                Wgmma<N>::mma(fresh, al[u], bh, u);\n"
             "                Wgmma<N>::mma(fresh, ah[u], bl, 1);\n"
             "                Wgmma<N>::mma(fresh, ah[u], bh, 1);\n")
_STORE = "                if (f0 + r < p.f_out) {"
_FRESH = "constexpr int FRESH = 2;"
# name: [(text in the source, replacement)]
PATCHES = {
    "as built": [],
    "one-step runs": [(_FRESH, "constexpr int FRESH = 1;"),
                      ("int SUB = 2;", "int SUB = 1;"),
                      ("int SLOTS = 3;", "int SLOTS = 6;")],
    "four-step runs": [(_FRESH, "constexpr int FRESH = 4;")],
    "no products": [(_PRODUCTS, "")],
    "no stores": [(_STORE, "                if (f0 + r < p.f_out && p.n < 0) {")],
    "no turns": [("            named_sync(1 + cw);\n", ""),
                 ("            named_arrive(2 - cw);\n", ""),
                 ("    if (cw == 1) named_arrive(1);\n", ""),
                 ("    if (cw == 0) named_sync(1);\n", "")],
}
COMPUTES = ("as built", "one-step runs", "four-step runs", "no turns",
            "parent")


def variants(src: str) -> dict:
    """{name: patched source}; raises if a patch's text is not there."""
    out = {}
    for name, reps in PATCHES.items():
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(
                    f"variant {name!r}: {old!r} not in the source")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(sources: dict, where: pathlib.Path) -> dict:
    """{name: ctypes library}, one nvcc per source, all started together."""
    nvcc = _build.find_nvcc()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = where / f"v{i}.cu", where / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        lib.new = hasattr(lib, "fir_tf32_scratch_floats")
        if lib.new:
            for fn, argtypes in _LAUNCHERS.items():
                getattr(lib, fn).argtypes = argtypes
        else:                               # the launcher before the halves
            lib.fir_cat_launch.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 8
                                           + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def shapes(dev) -> dict:
    """{name: (x, g2, f_pad, P, s, pad_left)} from a seeded signal."""
    plan = make_plan(160, 147)
    fs_out = SRCConfig(L=160, M=147).output_rate(FS)
    bands = EQConfig.from_gains(GAINS).active_bands(fs_out)
    ops = make_block_operators(bands, fs_out, 1.0, 128 * plan.P, plan.P)
    g2 = torch.as_tensor(cat_operator(plan.G, eq_cat_weights(ops)),
                         device=dev)
    rng = np.random.default_rng(0)
    n = 60 * FS
    fl = 12288

    def sig(rows, length):
        return torch.as_tensor(
            (0.3 * rng.standard_normal((rows, length))).astype(np.float32),
            device=dev)

    f_pad = frame_grid(SRCConfig(L=160, M=147).output_length(n), plan.P)
    x = sig(8, n)
    g = torch.as_tensor(plan.G.astype(np.float32), device=dev)
    return {
        "K1 serving 8 x 60 s": (x, g2, f_pad, plan.P, plan.s, -plan.lo),
        f"K1 stream step FL {fl}": (sig(8, fl * plan.s + plan.W - plan.s),
                                    g2, fl, plan.P, plan.s, 0),
        "frames FIR serving 8 x 60 s": (x, g, f_pad, plan.P, plan.s,
                                        -plan.lo),
    }


class Launch:
    """One variant's launch at one shape, outputs and scratch held."""

    def __init__(self, lib, x, g2, f_pad, P, s, pad_left):
        B, n = x.shape
        W, V = g2.shape
        self.args = (lib, x, g2, f_pad, P, s, pad_left, B, n, W, V)
        self.y0 = torch.empty((B, f_pad, P), device=x.device)
        self.inj = torch.empty((B, f_pad, V - P), device=x.device)
        self.nf = lib.fir_tf32_scratch_floats(W, V, s) if lib.new else 0
        self.planes = torch.empty(max(self.nf, 1), device=x.device)

    def __call__(self):
        lib, x, g2, f_pad, P, s, pad_left, B, n, W, V = self.args
        head = (x.data_ptr(), g2.data_ptr(), self.y0.data_ptr(),
                self.inj.data_ptr())
        if lib.new:
            head += (self.planes.data_ptr(), self.nf)
        err = lib.fir_cat_launch(*head, B, n, f_pad, W, V, P, s, pad_left,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")


def time_us(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    err = ref - got.double()
    return float(10 * torch.log10((ref * ref).mean() / (err * err).mean()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="another fir_cat.cu to time beside the variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fir_variants needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    sources = variants((_build.CSRC / "fir_cat.cu").read_text())
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources, pathlib.Path(tmp))
        dev = torch.device("cuda")
        for shape, (x, g2, f_pad, P, s, pad_left) in shapes(dev).items():
            runs = {name: Launch(lib, x, g2, f_pad, P, s, pad_left)
                    for name, lib in libs.items()}
            y0_ref, inj_ref = fir_cat_plain(x, g2, P, s, f_pad, pad_left)
            times = {name: [] for name in runs}
            for name in list(runs) + list(runs)[::-1]:
                times[name].append(time_us(runs[name]))
            for name, run in runs.items():
                line = (f"{shape}: {name}: "
                        + " / ".join(f"{t:.1f}" for t in times[name]) + " us")
                if name in COMPUTES:
                    run()
                    torch.cuda.synchronize()
                    line += f"; y0 {snr_db(y0_ref, run.y0):.2f} dB"
                    if inj_ref.shape[-1]:
                        line += f", inj {snr_db(inj_ref, run.inj):.2f} dB"
                print(line, flush=True)
            reps = 20
            prof = profile_device_span(
                lambda: [runs["as built"]() for _ in range(reps)], top=None)
            print(f"{shape}: as built, device us a launch by kernel: "
                  + "; ".join(f"{name[:60]} {ms * 1e3 / reps:.1f}"
                              for name, ms in prof.ops), flush=True)


if __name__ == "__main__":
    main()
