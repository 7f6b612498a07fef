"""Where the device gain builder's time goes (``csrc/eq_design.cu``).

    python -m dsp_audio_project_tpu_torch.scripts.design_phases
        [--source FILE ...] [--geometry U G K]

For each source (default: the package's ``csrc/eq_design.cu``; ``--source``
may name others, say the parent commit's copy) this writes two copies into
a temporary directory and builds them at once with nvcc (the port's flags):

* as it is: each kernel's device time (``torch.profiler`` over 20 calls)
  and the call's (``utils/benchmarking.measure_device``);
* stamped: at every ``DESIGN_STAMP(n);  // kernel: phase`` line thread 0
  of each block writes ``clock64()``, ``%globaltimer`` and its SM into a
  ``__device__`` buffer, read back after one call.  A source without such
  lines (the three-launch body of the builder's first version) gets them
  inserted at its phase boundaries (``_FIRST_ANCHORS``).

Both builds take the launcher ``eq_design_launch`` with the arguments of
the package's ``kernels/eq_design.py`` (the outputs and the float32 table
of transposed powers), or, for a source without ``eq_design_grid`` (the
first version), its float64 scratch besides.  Prints, per kernel
and phase: the blocks that reached it, the median and largest cycles since
the block's previous stamp, and the median and last time it was reached
after the call's first stamp (ns, ``%globaltimer``); cycles convert to ns
at the rate a calibration spin measures.  The stamps cost a few global
stores by one thread at each phase.  Then the tables of both builds held
against ``dynamic_operators_plain`` (one float32 ulp).  The slider's
geometry and the first gain set of ``chip_smoke.py`` by default.  Needs
the card and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import statistics
import subprocess
import tempfile

import torch

from ..config import EQConfig
from ..kernels import _build
from ..kernels.eq_design import (
    _LAUNCHERS, cuda_layout, dynamic_operators_plain, ulp_error,
)
from ..ops.eq_dynamic import _band_trig
from ..utils.benchmarking import measure_device
from ..utils.deviceprof import profile_device_span

GAINS = (6.0, -3.0, 0.0, 12.0, -15.0, 4.0)
FS_OUT = 48000
MAX_BLOCKS, MAX_PHASES = 4096, 48

_STAMPS = r"""
#include <cuda_runtime.h>
__device__ unsigned long long design_stamps[%(blocks)d * %(phases)d * 3];
__device__ __forceinline__ void design_stamp(int phase)
{
    if (threadIdx.x != 0 || blockIdx.x >= %(blocks)d || phase >= %(phases)d)
        return;
    unsigned long long t, smid;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    asm volatile("{ .reg .u32 s; mov.u32 s, %%%%smid; cvt.u64.u32 %%0, s; }"
                 : "=l"(smid));
    unsigned long long* at =
        design_stamps + ((size_t)blockIdx.x * %(phases)d + phase) * 3;
    at[0] = clock64();
    at[1] = t;
    at[2] = smid + 1;
}
#define DESIGN_STAMP(phase) design_stamp(phase)
"""

_READ = r"""
__global__ void design_calibrate(unsigned long long* out, long long spin)
{
    unsigned long long t0, t1;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t0));
    const long long c0 = clock64();
    while (clock64() - c0 < spin) {}
    const long long c1 = clock64();
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t1));
    out[0] = c1 - c0;
    out[1] = t1 - t0;
}
extern "C" int design_stamps_clear()
{
    static unsigned long long zeros[%(blocks)d * %(phases)d * 3];
    return (int)cudaMemcpyToSymbol(design_stamps, zeros, sizeof(zeros));
}
extern "C" int design_stamps_read(unsigned long long* out)
{
    cudaDeviceSynchronize();
    return (int)cudaMemcpyFromSymbol(out, design_stamps,
                                     sizeof(design_stamps));
}
extern "C" int design_calibrate_run(unsigned long long* out_host)
{
    unsigned long long* dev = nullptr;
    cudaMalloc(&dev, 2 * sizeof(unsigned long long));
    design_calibrate<<<1, 1>>>(dev, 20000000);
    cudaMemcpy(out_host, dev, 2 * sizeof(unsigned long long),
               cudaMemcpyDeviceToHost);
    cudaFree(dev);
    return (int)cudaGetLastError();
}
"""

# The first version's three kernels: (text, text with a stamp).
_FIRST_ANCHORS = (
    ("    double* w = hR + sc.nR * DD;                 // one matrix of scratch\n",
     "    double* w = hR + sc.nR * DD;                 // one matrix of scratch\n"
     "    DESIGN_STAMP(0);  // design: start\n"),
    ("geo.two_q, bands + i * BAND_VALUES);\n    }\n    __syncthreads();\n",
     "geo.two_q, bands + i * BAND_VALUES);\n    }\n    __syncthreads();\n"
     "    DESIGN_STAMP(1);  // design: bands\n"),
    ("d_product(bands, nb, -1, nb);\n        }\n    }\n    __syncthreads();\n",
     "d_product(bands, nb, -1, nb);\n        }\n    }\n    __syncthreads();\n"
     "    DESIGN_STAMP(2);  // design: composition\n"),
    ("    power<D>(hQ, hA, geo.U, w);\n",
     "    DESIGN_STAMP(3);  // design: heads of A\n"
     "    power<D>(hQ, hA, geo.U, w);\n"
     "    DESIGN_STAMP(4);  // design: Q = A^U\n"),
    ("    if (sc.nR) {\n        power<D>(hR, hQ, geo.G, w);\n",
     "    DESIGN_STAMP(5);  // design: heads of Q\n"
     "    if (sc.nR) {\n        power<D>(hR, hQ, geo.G, w);\n"
     "    DESIGN_STAMP(6);  // design: R = Q^G\n"),
    ("    // D, B, C and the heads, contiguous in shared memory as in sc.\n",
     "    DESIGN_STAMP(7);  // design: heads of R\n"
     "    // D, B, C and the heads, contiguous in shared memory as in sc.\n"),
    ("        sc.Dv[idx] = vals[idx];\n}\n",
     "        sc.Dv[idx] = vals[idx];\n"
     "    DESIGN_STAMP(8);  // design: write-back\n}\n"),
    ("    const double* src = table == 0 ? sc.hA : table == 1 ? sc.hQ : sc.hR;\n",
     "    DESIGN_STAMP(9);  // powers: start\n"
     "    const double* src = table == 0 ? sc.hA : table == 1 ? sc.hQ : sc.hR;\n"),
    ("    power<D>(X, H, n, w);\n\n",
     "    power<D>(X, H, n, w);\n"
     "    DESIGN_STAMP(10);  // powers: heads copied, power raised\n\n"),
    ("    const int rows = first_fir + U;\n",
     "    const int rows = first_fir + U;\n"
     "    DESIGN_STAMP(16);  // expand: start\n"),
    ("                fir_t[(size_t)v * U + u] = (float)val;\n"
     "            }\n        }\n    }\n}\n",
     "                fir_t[(size_t)v * U + u] = (float)val;\n"
     "            }\n        }\n    }\n"
     "    DESIGN_STAMP(17);  // expand: end\n}\n"),
)
_STAMP_LINE = re.compile(
    r"DESIGN_STAMP\((\d+)( \+ \w+)?\);\s*//\s*([\w ]+):\s*(.+)")


def stamped(src: str) -> str:
    """``src`` with its stamps defined (inserted first where it has
    none), and the read-back functions appended."""
    if not _STAMP_LINE.search(src):
        for old, new in _FIRST_ANCHORS:
            if src.count(old) != 1:
                raise RuntimeError(f"no unique anchor {old!r} in the source")
            src = src.replace(old, new)
    fmt = {"blocks": MAX_BLOCKS, "phases": MAX_PHASES}
    return _STAMPS % fmt + src + _READ % fmt


def phases(src: str) -> dict:
    """{phase id: (kernel, phase)} from the stamped source's lines.  A
    stamp ``DESIGN_STAMP(n + i);  // kernel: phase +`` names the ids from
    n up to the next id a line names: "phase 0", "phase 1", ..."""
    lines = [(int(m.group(1)), bool(m.group(2)), m.group(3).strip(),
              m.group(4).strip()) for m in _STAMP_LINE.finditer(src)]
    fixed = sorted(n for n, ranged, _, _ in lines if not ranged)
    names = {}
    for n, ranged, kernel, phase in lines:
        if not ranged:
            names[n] = (kernel, phase)
            continue
        stop = min([f for f in fixed if f > n] + [MAX_PHASES])
        for i in range(stop - n):
            names[n + i] = (kernel, f"{phase.rstrip(' +')} {i}")
    return names


def build(sources: list, tmp: pathlib.Path) -> list:
    """[(label, plain library, stamped library, phase names)], built at
    once."""
    nvcc = _build.find_nvcc()
    jobs, out = [], []
    for i, path in enumerate(sources):
        text = pathlib.Path(path).read_text()
        marked = stamped(text)
        libs = []
        for tag, body in (("plain", text), ("stamped", marked)):
            cu = tmp / f"s{i}_{tag}.cu"
            cu.write_text(body)
            so = cu.with_suffix(".so")
            jobs.append((so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            libs.append(so)
        out.append((str(path), libs, phases(marked)))
    for so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {so.stem}:\n{log}")
    loaded = []
    for label, (plain, marked), names in out:
        pair = []
        for so in (plain, marked):
            lib = ctypes.CDLL(str(so))
            if hasattr(lib, "eq_design_grid"):
                lib.eq_design_launch.argtypes = _LAUNCHERS["eq_design_launch"]
            else:                        # the first version: a scratch more
                lib.eq_design_launch.argtypes = (
                    _LAUNCHERS["eq_design_launch"][:-1]
                    + [ctypes.c_void_p] * 2)
            lib.eq_design_launch.restype = ctypes.c_int
            pair.append(lib)
        loaded.append((label, pair[0], pair[1], names))
    return loaded


class Call:
    """One gain vector's inputs, outputs and scratch at (U, G, K)."""

    def __init__(self, U: int, G: int, K: int, dev):
        cfg = EQConfig()
        s, c = _band_trig(FS_OUT, cfg.band_centers, cfg.nyquist_safety)
        self.q, self.thr = cfg.q, cfg.bypass_threshold_db
        self.gains = torch.tensor(GAINS, dtype=torch.float32, device=dev)
        self.sin = torch.as_tensor(s, device=dev)
        self.cos = torch.as_tensor(c, device=dev)
        nb = len(GAINS)
        lay = cuda_layout(nb, U, G, K)
        d, kd = lay["d"], lay["K_dense"]
        self.U, self.G, self.kd = U, G, kd
        f = dict(dtype=torch.float32, device=dev)
        self.outs = [torch.empty(U, d, **f), torch.empty(d, U, **f),
                     torch.empty(U, U, **f), torch.empty(G * d, G * d, **f),
                     torch.empty(G, d, d, **f), torch.empty(d, d, **f),
                     torch.empty(kd * d, kd * d, **f) if kd else None]
        # The transposed float32 powers, and the first version's scratch
        # (seq, D, B, C and the heads of A, Q and R).
        heads = U.bit_length() + G.bit_length() + (
            (kd - 1).bit_length() if kd else 0)
        self.first = (
            torch.zeros(G + 1 + kd, d, d, **f),
            torch.zeros(U + 1 + 2 * d + heads * d * d, dtype=torch.float64,
                        device=dev))

    def run(self, lib) -> list:
        o = self.outs
        extra = self.first[:1] if hasattr(lib, "eq_design_grid") else self.first
        first = tuple(ctypes.c_void_p(t.data_ptr()) for t in extra)
        err = lib.eq_design_launch(
            self.gains.data_ptr(), self.sin.data_ptr(), self.cos.data_ptr(),
            len(GAINS), self.U, self.G, self.kd, 2.0 * self.q, self.thr,
            *(t.data_ptr() for t in o[:6]),
            0 if o[6] is None else o[6].data_ptr(), *first,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"eq_design_launch: CUDA error {err}")
        return o

    def worst_ulps(self) -> float:
        ref = dynamic_operators_plain(self.gains, self.sin, self.cos, self.q,
                                      self.thr, self.U, self.G,
                                      self.kd or None)
        return max(ulp_error(a, b) for a, b in zip(self.outs, ref)
                   if b is not None)


def read_stamps(lib) -> list:
    n = MAX_BLOCKS * MAX_PHASES * 3
    buf = (ctypes.c_ulonglong * n)()
    if lib.design_stamps_read(buf):
        raise RuntimeError("reading the stamps failed")
    return [[tuple(buf[(b * MAX_PHASES + p) * 3:(b * MAX_PHASES + p) * 3 + 3])
             for p in range(MAX_PHASES)] for b in range(MAX_BLOCKS)]


def cycles_per_ns(lib) -> float:
    out = (ctypes.c_ulonglong * 2)()
    if lib.design_calibrate_run(out):
        raise RuntimeError("the calibration spin failed")
    return out[0] / out[1]


def report(stamps: list, names: dict, rate: float) -> None:
    """Per kernel and phase: blocks, cycles since the block's previous
    stamp (median, largest), time reached after the call's first stamp."""
    t0 = min(s[1] for row in stamps for s in row if s[2])
    kernels = {}
    for pid, (kernel, _) in sorted(names.items()):
        kernels.setdefault(kernel, []).append(pid)
    for kernel, pids in kernels.items():
        print(f"  {kernel}:", flush=True)
        for i, pid in enumerate(pids):
            steps, at, sms = [], [], set()
            for row in stamps:
                clock, t, sm = row[pid]
                if not sm:
                    continue
                at.append(t - t0)
                sms.add(sm)
                prev = [row[q] for q in pids[:i] if row[q][2]]
                if prev:
                    steps.append(clock - prev[-1][0])
            if not at:
                continue
            line = (f"    {pid:2d} {names[pid][1]:<34s} blocks {len(at):4d} "
                    f"on {len(sms):3d} SMs, reached at {statistics.median(at):8.0f}"
                    f" ns (median), {max(at):8.0f} (last)")
            if steps:
                med = statistics.median(steps)
                line += (f"; since the last stamp {med:8.0f} cycles median "
                         f"({med / rate:7.0f} ns), {max(steps):8.0f} largest")
            print(line, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", nargs="*", default=None)
    parser.add_argument("--geometry", nargs=3, type=int,
                        default=(160, 128, 144))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("design_phases needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    sources = args.source or [str(_build.CSRC / "eq_design.cu")]
    dev = torch.device("cuda")
    U, G, K = args.geometry
    with tempfile.TemporaryDirectory() as tmp:
        built = build(sources, pathlib.Path(tmp))
        for label, plain, marked, names in built:
            call = Call(U, G, K, dev)
            print(f"{label} at U, G, K = {U}, {G}, {K}:", flush=True)
            call.run(plain)
            torch.cuda.synchronize()
            print(f"  tables within {call.worst_ulps():.3f} float32 ulp of "
                  "plain", flush=True)
            us = measure_device(lambda: call.run(plain), calls=20) * 1e6

            def twenty():
                for _ in range(20):
                    call.run(plain)

            prof = profile_device_span(twenty, top=None)
            rows = ", ".join(f"{name[:60]} {ms / 20 * 1e3:.2f}"
                             for name, ms in prof.ops)
            print(f"  measure_device {us:.2f} us a call; profiler us a call:"
                  f" {rows}", flush=True)
            rate = cycles_per_ns(marked)
            call.run(marked)                           # warm
            torch.cuda.synchronize()
            if marked.design_stamps_clear():
                raise RuntimeError("clearing the stamps failed")
            call.run(marked)
            stamps = read_stamps(marked)
            print(f"  stamped call, {rate:.3f} cycles a ns; tables within "
                  f"{call.worst_ulps():.3f} ulp:", flush=True)
            report(stamps, names, rate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
