"""Variants of the state solve's kernels (``csrc/group_states.cu``).

    python -m dsp_audio_project_tpu_torch.scripts.state_variants

Writes patched copies of ``csrc/group_states.cu`` into a temporary
directory, builds them at once with nvcc (the port's flags) and runs each
one's launchers through ctypes: the ends kernel, then the solve kernel
with a zero seed (the zero-entry states s_in).  The variants:

* ``as built``: the source as it is (float64 sums);
* ``float32 sums``: every ``double`` of the source made ``float`` (the
  same kernels, summed in float32).

Times (device µs a call, ``utils/benchmarking.measure_device``) at the main
paths' shapes, beside the dense product the kernels replace
(``group_states_plain``) and its one cuBLAS GEMM: the serve cell's (8 x
144 block rows of G = 128, d = 10), the slider's (144 rows, d = 12) and a
stream step's at FL 12288 (8 x 96 rows).  Then the accuracy where the
poles lie close to 1 within a group, config_matrix's P = 1 plans at low
rates and 160/147 for contrast: each variant's and the dense float32
product's SNR against the float64 product on the same seeded injections.
Needs the card and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import tempfile

import numpy as np
import torch

from ..config import EQConfig, SRCConfig
from ..kernels import _build
from ..kernels.group_states import _LAUNCHERS, group_states_plain
from ..ops.eq import make_block_operators
from ..ops.src import make_plan
from ..utils.benchmarking import measure_device

GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}
VARIANTS = {"as built": lambda src: src,
            "float32 sums": lambda src: src.replace("double", "float")}
# (name, block rows, L/M of the table's plan, d from the gains)
SHAPES = (("serve (8 x 60 s)", (8, 144), (160, 147), GAINS),
          ("slider (1 x 60 s, d = 12)", (1, 144), (160, 147),
           {"Sub-Bass": 6, "Bass": -3, "Low Mids": 1, "High Mids": 12,
            "Presence": -15, "Brilliance": 4}),
          ("stream step (FL 12288)", (8, 96), (160, 147), GAINS))
PLANS = ((1, 4), (2, 8), (1, 5), (1, 6), (160, 147))


def table(L: int, M: int, gains: dict, device):
    """(group_in, group_toeplitz) float32 at the frames path's geometry of
    an L/M plan: 128 groups of P samples a block."""
    fs_out = SRCConfig(L=L, M=M).output_rate(44100)
    P = make_plan(L, M).P
    cfg = EQConfig.from_gains(gains)
    ops = make_block_operators(cfg.active_bands(fs_out), fs_out, cfg.q,
                               128 * P, P)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (ops.group_in, ops.group_toeplitz))


def build(tmp: pathlib.Path) -> dict:
    """{variant: the library built from its patched source}."""
    nvcc = _build.find_nvcc()
    src = (_build.CSRC / "group_states.cu").read_text()
    procs = {}
    for name, patch in VARIANTS.items():
        path = tmp / f"v{len(procs)}.cu"
        path.write_text(patch(src))
        so = path.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for fn in ("group_ends_launch", "group_states_launch"):
            getattr(lib, fn).argtypes = _LAUNCHERS[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, inj: torch.Tensor, toe: torch.Tensor):
    """(s_in, end) from one variant's library: the ends kernel, then the
    solve kernel with a zero seed."""
    outer, K, G, d = inj.shape
    s_in = torch.empty(outer, K, G, d, device=inj.device)
    end = torch.empty(outer, K, d, device=inj.device)
    pre = torch.empty(outer, K, -(-G // 4), d, device=inj.device)
    geometry = (outer * K, K, G, d, *inj.stride()[:3], toe.stride(0),
                torch.cuda.current_stream().cuda_stream)
    err = (lib.group_ends_launch(inj.data_ptr(), toe.data_ptr(),
                                 end.data_ptr(), pre.data_ptr(), *geometry)
           or lib.group_states_launch(inj.data_ptr(), toe.data_ptr(),
                                      pre.data_ptr(), s_in.data_ptr(),
                                      *geometry))
    if err:
        raise RuntimeError(f"group_states: CUDA error {err}")
    return s_in, end


def snr_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    err = (got.double() - ref).pow(2).mean()
    return float(10.0 * torch.log10(ref.pow(2).mean() / err))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("state_variants needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(pathlib.Path(tmp))
        for name, (B, K), (L, M), gains in SHAPES:
            g_in, toe = table(L, M, gains, dev)
            x = torch.as_tensor(rng.standard_normal(
                (B, K, 128, g_in.shape[0])).astype(np.float32), device=dev)
            inj = x @ g_in
            rows, G, d = B * K, 128, g_in.shape[1]
            ref = group_states_plain(inj, toe)[0]
            times = {"dense product (plain)": measure_device(
                lambda: group_states_plain(inj, toe), calls=20),
                "its cuBLAS GEMM": measure_device(
                lambda: inj.reshape(rows, G * d) @ toe, calls=20)}
            agree = {}
            for v, lib in libs.items():
                agree[v] = snr_db(ref, launch(lib, inj, toe)[0])
                times[v] = measure_device(
                    lambda: launch(lib, inj, toe), calls=20)
            print(f"{name} {tuple(inj.shape)}: " + ", ".join(
                f"{k} {1e6 * t:.2f} us" for k, t in times.items())
                + "; against the plain version: " + ", ".join(
                f"{k} {s:.1f} dB" for k, s in agree.items()), flush=True)
        for L, M in PLANS:
            g_in, toe = table(L, M, GAINS, dev)
            x = torch.as_tensor(rng.standard_normal(
                (1, 88, 128, g_in.shape[0])).astype(np.float32), device=dev)
            inj = x @ g_in
            ref = group_states_plain(inj.double(), toe.double())[0]
            got = {"dense float32 product": group_states_plain(inj, toe)[0]}
            got.update({v: launch(lib, inj, toe)[0]
                        for v, lib in libs.items()})
            print(f"{L}/{M} (P = {make_plan(L, M).P}), SNR against the "
                  "float64 product: " + ", ".join(
                      f"{k} {snr_db(ref, s):.1f} dB" for k, s in got.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
