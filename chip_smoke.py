#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the run: build, check, time
    python3 chip_smoke.py --profile    # also torch.profiler tables by kernel

Drives the port (dsp_audio_project_tpu_torch) at its real size — 44.1 ->
48 kHz SRC (L/M = 160/147) + the 5-band EQ + |rfft| spectra of x, y and z
on the cat, frames and explicit-kernel (fir_path = iir_path = 'pallas')
paths, the analysis ops (STFT, spectrogram, long-window spectra) and the
experimental kernels' entry points, 60 s signals, batch 8 — through the
entry points a user calls, and checks it.
Phases, one or more lines each:

  1. device: card name, ``nvidia-smi`` name and power limit, TF32 off;
  2. build: every CUDA kernel from csrc/ with nvcc, one process per source,
     all started together (seconds);
  3. [k1] K1 (EQ-fused FIR, 3xTF32 on the tensor cores) vs its plain fp32
     torch version at the serving shape;
  4. [k2] K2 (register-radix |rfft|) vs its plain version at (24, 2048),
     and vs its plain version and float64 np.fft.rfft at one row of every
     power of two 256..8192; [k2c] K2's complex form the same way, at 2048
     rows of the STFT's (41344, 2048) frames and one row of each N;
  5. [k3] the frames FIR kernel (K1's body with V = P) vs its plain version
     at the serving shape, and each entry point that runs it (fir_frames
     'rect' K3, 'class' K4, 'shear' K5, the flat K6 and ``forward_flat``,
     E1 directly and as fir_path='pallas', E3, E4, E5) at a small shape and
     at the serving shape, the serving runs counted: each must launch the
     kernel and agree (> 120 dB);
  6. [k9] the EQ finish kernel vs its plain version at the cat path's and
     the frames path's serving shapes and at a U % 4 != 0 plan (441/480);
  7. [k7] K7 (one pass up to N = 32768, two above) vs its plain version
     and float64 np.fft.rfft at one row of every N from 16384 to 524288,
     and vs its plain version at the spectrogram's (5168, 16384) frames,
     both forms; [k8] K8 vs its plain version and float64 np.fft.rfft at
     the (8, 1048576) centre windows, both forms (K2, K7, K8: > 110 dB
     and max abs error <= 1e-5 * max|X|);
  8. [slice] the cat chain ``forward_cat_spectra``: K1, K9 and K2 must have
     launched; z and the spectra >= 60 dB against the numpy oracle; z with
     the kernel finish vs the torch finish > 120 dB;
  9. [frames] ``pipe(x, fs, with_spectra=True)`` (the JAX package's
     ``__call__``) and ``forward_frames_spectra``: the frames kernel, K9
     and K2 must have launched; z, y and the spectra >= 60 dB against the
     oracle outputs of [slice] (same x and config);
 10. [analysis] ``stft(x, 2048, 512)`` must launch K2 complex,
     ``spectrogram(x, 16384, 4096)`` K7, ``pipe(x, fs, with_spectra=True)``
     at SpectrumConfig(nfft=32768) K7 three times, ``magnitude_spectrum``
     at nfft 1048576 (no analysis cap) K8; each >= 60 dB against float64
     numpy (the STFT's Hann frames through np.fft.rfft, built here) or the
     oracle's spectra;
 11. [explicit] ``pipe_explicit(x, fs, with_spectra=True)`` with
     KernelConfig(fir_path='pallas', iir_path='pallas'): the frames kernel
     (E1), E2a, E2b and K2 must launch; z, y and the spectra >= 60 dB
     against the oracle outputs of [slice];
 12. [e2] E2a and E2b vs their plain versions on that path's own 2816
     blocks of 8192 (> 80 dB and max abs err <= 1e-3 * max|ref|: the
     plain version runs 8192 dependent float32 steps through poles at
     radius ~0.996); [e7] E7 at the serving flat shape (y padded to 8 x
     2,949,120), its own counted run, vs its plain version and the
     oracle's z (>= 60 dB), and a second run bitwise equal to the first;
     [e6] E6 vs its plain version and float64 np.fft.rfft (>= 135 dB) at one row of every N from 4 to 32768 and at
     65536 (the two-pass route), then its own counted run at the STFT's
     (41344, 2048) frames;
 13. [time] CUDA-event timings (median of 20 runs after 20 warm-up runs;
     the plain E2 versions, an 8192-step host loop, median of 2 after 2):
     the chains and analysis paths per call (per call, and per call of 20
     back-to-back calls; the host's own time per call), the cat chain with
     either finish in turns, and each kernel beside its plain version and
     one PyTorch library call computing the same function (``library_ms``;
     the port never calls it).  ``--profile`` adds device time by kernel
     (torch.profiler) for each chain and analysis path, and for E6 and E7.

Each path is driven with the launch counts set to 0 just before it and
read just after.  The third line from the end is the card's name and power
limit as ``nvidia-smi`` gives them; the line before the last is the kernel
record
{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"},
...]}: ``launches`` sums the kernel's launches over the main-path runs of
[slice], [frames], [analysis], [explicit] and the entry points' own runs
in [k3] (serving shape), [e7] and [e6] (for K7 and K8, calls of the
two-pass launcher, each of which starts both passes, as the JAX K8's two
``pallas_call``s are one kernel; K3-K6, E1 and E3-E5 rows all time the one
frames kernel through their entry points); ``bound_ms`` is the larger of
the operations over the H100's peak for their type and the bytes (each
input read once, each output written once) over 3.35 TB/s, from this
run's shapes.  The windowed FIR (K1 and the frames rows) counts three
TF32 products a multiply-add (its fp32-accurate split) at 495 TFLOP/s
dense TF32, the [time] line adds its fp32 SIMT bound; the rest count
fp32 operations at 67 TFLOP/s (an FMA is 2; an rfft 2.5 N log2 N a row;
E2a, E2b and E7 the multiply-adds of the group algebra their kernel runs,
at the group length U that needs the fewest: per sample d for the
injection and d*d/U for the Horner pass, and for E2b and E7 (U+1)/2 for
the triangular FIR product and d for the readout; E7 adds its look-back
and the A^{gU} sigma fold a block; the [time] line adds the same count at
the kernels' own U).  The last
line is {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.  Any failed phase raises, so the script exits nonzero
without those lines; it also fails when no CUDA device is visible.
Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SECONDS = 60.0
FS = 44100
BATCH = 8
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}
REPS = 20
WARMUP = 20   # the card idles during the host-side oracle phase: ramp it up
FFT_ROWS = 3 * BATCH
NFFT = 2048
STFT = (2048, 512)          # nfft, hop of the [analysis] stft
SPECGRAM = (16384, 4096)    # nfft, hop of the [analysis] spectrogram
LONG_NFFT = 32768           # pipe(..., with_spectra=True) spectra (K7)
HUGE_NFFT = 1 << 20         # magnitude_spectrum (K8)
PEAK_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores (data sheet)
PEAK_TF32 = 495e12      # H100 SXM dense TF32 on the tensor cores (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s (data sheet)
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def make_signal(n: int, fs: int, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = (
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 40 * t)
        + 0.2 * np.sin(2 * np.pi * 9800 * t)
        + 0.2 * rng.standard_normal(n)
    )
    return (x / np.max(np.abs(x))).astype(np.float32)


def make_batch(n: int) -> np.ndarray:
    """Batch of 60 s signals: the bench signal plus per-row noise (seeded)."""
    x = make_signal(n, FS)
    rng = np.random.default_rng(7)
    return np.stack([x] + [
        (x + 0.01 * rng.standard_normal(n)).astype(np.float32)
        for _ in range(BATCH - 1)
    ])


def real_view(t: torch.Tensor) -> torch.Tensor:
    """A complex tensor as its (..., 2) real view; a real one as it is."""
    return torch.view_as_real(t) if t.is_complex() else t


def snr_db(ref: torch.Tensor, test: torch.Tensor) -> float:
    ref = real_view(ref).double()
    err = ref - real_view(test).double()
    return float(10.0 * torch.log10((ref * ref).mean() / (err * err).mean()))


def hann(n: int, device) -> torch.Tensor:
    """The symmetric Hann window of the reference (dsp_core.py:86-87)."""
    k = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / (n - 1))).float()


def hann_frames(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """(rows, nfft) Hann-windowed frames of (B, N) x as ``stft`` frames
    them (pad_end: every sample covered), built here for the kernel checks."""
    import torch.nn.functional as F

    frames = -(-x.shape[-1] // hop)
    total = (frames - 1) * hop + nfft
    win = F.pad(x, (0, total - x.shape[-1])).unfold(-1, nfft, hop)
    return (win * hann(nfft, x.device)).reshape(-1, nfft)


def time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """Median CUDA-event time of fn() in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, calls: int = REPS) -> float:
    """CUDA-event time per call of ``calls`` calls enqueued back to back
    (after ``time_ms`` has warmed the card): the steady-state cost when the
    host keeps the device fed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound(flops: float, nbytes: float,
          peak: float = PEAK_FLOPS) -> tuple[float, str]:
    """(least ms the card could take, what binds it): the operations at
    ``peak`` or the bytes at PEAK_BYTES, the larger."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fir_bound(rows: int, frames: int, W: int, V: int, n: int):
    """The windowed FIR's bound at fp32 accuracy: three TF32 products of
    rows*frames x W x V at the tensor cores' rate against x, the operator
    and the output moved once; the fp32 SIMT bound of the same work, for
    the [time] line; and the three products' flops."""
    macs = rows * frames * W * V
    nbytes = 4.0 * (rows * n + W * V + rows * frames * V)
    return (bound(3 * 2.0 * macs, nbytes, PEAK_TF32),
            bound(2.0 * macs, nbytes), 3 * 2.0 * macs)


def compare(tag: str, name: str, got: torch.Tensor, ref: torch.Tensor,
            bound_db: float = 120.0, rel: float = 1e-5) -> float:
    """Kernel vs plain: SNR > bound_db and max abs err <= rel * max|ref|."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise RuntimeError(f"{tag} {name} {got.dtype} {tuple(got.shape)} != "
                           f"{ref.dtype} {tuple(ref.shape)}")
    snr = snr_db(ref, got)
    err = float((got - ref).abs().max())
    top = float(ref.abs().max())
    log(f"[{tag}] {name} {tuple(got.shape)}: snr {snr:.1f} dB (bound "
        f"{bound_db:.0f}), max abs err {err:.3e} (bound {rel:g} * {top:.3e})")
    if not (snr > bound_db and err <= rel * top):
        raise RuntimeError(f"{tag} {name} disagrees with its plain version")
    return err


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs a GPU")
    from dsp_audio_project_tpu_torch.utils.precision import fp32_pinned

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    if not fp32_pinned():
        raise RuntimeError("TF32 is not off for float32 matmuls")
    log("[device] tf32 off (cuda.matmul and cudnn), fp32 precision highest")
    return kind, smi


def phase_build() -> None:
    from dsp_audio_project_tpu_torch.kernels import _build
    from dsp_audio_project_tpu_torch.kernels.eq_finish import (
        _LAUNCHERS as EQ_FINISH,
    )
    from dsp_audio_project_tpu_torch.kernels.experiments.iir_group import (
        _LAUNCHERS as IIR_BLOCK,
    )
    from dsp_audio_project_tpu_torch.kernels.experiments.rfft_butterfly import (
        _LAUNCHERS as BUTTERFLY,
    )
    from dsp_audio_project_tpu_torch.kernels.fir_class import (
        _LAUNCHERS as FIR_CAT,
    )
    from dsp_audio_project_tpu_torch.kernels.rfft import (
        _LAUNCHERS as RFFT,
    )
    from dsp_audio_project_tpu_torch.kernels.rfft_two_pass import (
        _LAUNCHERS as TWO_PASS,
    )

    libs = (("fir_cat", FIR_CAT), ("eq_finish", EQ_FINISH),
            ("rfft_four_step", RFFT), ("rfft_two_pass", TWO_PASS),
            ("iir_block", IIR_BLOCK),
            ("rfft_butterfly", BUTTERFLY))
    t0 = time.perf_counter()
    _build.build([name for name, _ in libs])
    for name, launchers in libs:
        _build.load(name, launchers)
        log(f"[build] {name}.cu -> {_build.library_path(name).name}")
    log(f"[build] {len(libs)} sources, nvcc in parallel: "
        f"{time.perf_counter() - t0:.2f} s")


def conv_yardstick(x: torch.Tensor, g: torch.Tensor, s: int, f_pad: int,
                   pad_left: int):
    """F.conv1d computing windows @ g as (B, V, f_pad), on x padded ahead
    of the timed call: the library yardstick of K1 and the frames kernel."""
    import torch.nn.functional as F

    W = g.shape[0]
    total = (f_pad - 1) * s + W
    xp = F.pad(x, (pad_left, max(0, total - pad_left - x.shape[-1])))
    xp = xp[..., :total].unsqueeze(1).contiguous()
    w = g.t().unsqueeze(1).contiguous()            # (V, 1, W)
    return lambda: F.conv1d(xp, w, stride=s)


def phase_k1(pipe, x: torch.Tensor) -> dict:
    from dsp_audio_project_tpu_torch.kernels.fir_class import (
        fir_cat_plain, frame_grid, polyphase_fir_class_rect_cat,
    )

    plan = pipe._plan()
    n_out = pipe.config.src.output_length(x.shape[-1])
    f_pad = frame_grid(n_out, plan.P)
    g2 = pipe.g2

    def kern():
        return polyphase_fir_class_rect_cat(x, plan, n_out, None, g2=g2)

    def plain():
        return fir_cat_plain(x, g2, plan.P, plan.s, f_pad, -plan.lo)

    (y0, inj), (y0_ref, inj_ref) = kern(), plain()
    torch.cuda.synchronize()
    err = max(compare("k1", "y0", y0, y0_ref), compare("k1", "inj", inj, inj_ref))
    lib = conv_yardstick(x, g2, plan.s, f_pad, -plan.lo)
    b, simt, flops = fir_bound(x.shape[0], f_pad, plan.W, g2.shape[1],
                               x.shape[-1])
    return {"max_abs_err": err, "kern": kern, "plain": plain, "lib": lib,
            "bound": b, "simt_bound": simt, "flops": flops, "y0": y0,
            "inj": inj}


def phase_k2() -> dict:
    from dsp_audio_project_tpu_torch.kernels.rfft import (
        _device_tables, rfft_four_step_magnitude, rfft_four_step_plain,
    )
    from dsp_audio_project_tpu_torch.ops.fft import _four_step_kernel_n1

    rng = np.random.default_rng(11)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(NFFT) / (NFFT - 1))
    rows = torch.as_tensor(
        (rng.standard_normal((FFT_ROWS, NFFT)) * hann).astype(np.float32),
        device=DEVICE,
    )
    n1 = _four_step_kernel_n1(NFFT)
    tables = _device_tables(NFFT, rows.device)

    def kern():
        return rfft_four_step_magnitude(rows, n1=n1)

    def plain():
        return rfft_four_step_plain(rows, *tables)

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = compare("k2", f"{tuple(rows.shape)} n1={n1}", got, ref,
                  bound_db=110.0)
    n = 256
    while n <= 8192:
        n1_n = _four_step_kernel_n1(n)
        row = torch.as_tensor(rng.standard_normal((1, n)).astype(np.float32),
                              device=DEVICE)
        g = rfft_four_step_magnitude(row, n1=n1_n)
        compare("k2", f"N={n}", g,
                rfft_four_step_plain(row, *_device_tables(n, row.device)),
                bound_db=110.0)
        exact = torch.as_tensor(np.abs(np.fft.rfft(row.cpu().double().numpy())))
        compare("k2", f"N={n} vs float64 rfft", g.cpu().double(), exact,
                bound_db=110.0)
        n *= 2
    # rfft's operation count (2.5 N log2 N real flops a row); the twiddle
    # tables are the algorithm's, not the function's inputs.
    b = bound(2.5 * FFT_ROWS * NFFT * math.log2(NFFT),
              4.0 * FFT_ROWS * (NFFT + NFFT // 2 + 1))
    return {"max_abs_err": err, "kern": kern, "plain": plain,
            "lib": lambda: torch.fft.rfft(rows).abs(), "bound": b}


def rfft_bound(rows: int, n: int, out_bytes: int) -> tuple[float, str]:
    """The bound of an rfft of ``rows`` real rows of n points: 2.5 N log2 N
    flops a row (the DFT tables are the algorithm's, not the function's
    inputs), the rows read once and ``out_bytes`` per bin written once."""
    return bound(2.5 * rows * n * math.log2(n),
                 4.0 * rows * n + out_bytes * rows * (n // 2 + 1))


def in_chunks(fn, rows: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """fn over ``rows`` in chunks of ``chunk`` rows, concatenated."""
    return torch.cat([fn(r) for r in rows.split(chunk)])


def phase_k2c(x: torch.Tensor) -> dict:
    from dsp_audio_project_tpu_torch.kernels.rfft import (
        _device_tables, rfft_four_step_complex, rfft_four_step_plain,
    )
    from dsp_audio_project_tpu_torch.ops.fft import _four_step_kernel_n1

    nfft, hop = STFT
    frames = hann_frames(x, nfft, hop)           # (41344, 2048), the stft's
    n1 = _four_step_kernel_n1(nfft)
    tables = _device_tables(nfft, frames.device)
    part = frames[:2048]
    err = compare("k2c", f"{tuple(part.shape)} of {tuple(frames.shape)}",
                  rfft_four_step_complex(part, n1=n1),
                  rfft_four_step_plain(part, *tables, magnitude=False),
                  bound_db=110.0)
    rng = np.random.default_rng(17)
    n = 256
    while n <= 8192:
        n1_n = _four_step_kernel_n1(n)
        row = torch.as_tensor(rng.standard_normal((1, n)).astype(np.float32),
                              device=DEVICE)
        got = rfft_four_step_complex(row, n1=n1_n)
        compare("k2c", f"N={n}", got,
                rfft_four_step_plain(row, *_device_tables(n, row.device),
                                     magnitude=False),
                bound_db=110.0)
        exact = torch.as_tensor(np.fft.rfft(row.cpu().double().numpy()))
        compare("k2c", f"N={n} vs float64 rfft", got.cpu().to(exact.dtype),
                exact, bound_db=110.0)
        n *= 2

    def kern():
        return rfft_four_step_complex(frames, n1=n1)

    def plain():
        return rfft_four_step_plain(frames, *tables, magnitude=False)

    return {"max_abs_err": err, "kern": kern, "plain": plain,
            "lib": lambda: torch.fft.rfft(frames),
            "bound": rfft_bound(frames.shape[0], nfft, 8)}


def phase_k7(x: torch.Tensor) -> dict:
    from dsp_audio_project_tpu_torch.kernels.rfft_two_pass import (
        _device_tables, default_n2, rfft_four_step_tall, rfft_two_pass_plain,
    )

    rng = np.random.default_rng(19)
    n = 16384
    while n <= 524288:
        row = torch.as_tensor(rng.standard_normal((1, n)).astype(np.float32),
                              device=DEVICE)
        tables = _device_tables(n, row.device)
        exact = np.fft.rfft(row.cpu().double().numpy())
        for magnitude in (False, True):
            form = "|X|" if magnitude else "X"
            got = rfft_four_step_tall(row, magnitude=magnitude)
            compare("k7", f"N={n} n2={default_n2(n)} {form}", got,
                    rfft_two_pass_plain(row, *tables, magnitude),
                    bound_db=110.0)
            want = torch.as_tensor(np.abs(exact) if magnitude else exact)
            compare("k7", f"N={n} {form} vs float64 rfft",
                    got.cpu().to(want.dtype), want, bound_db=110.0)
        n *= 2
    nfft, hop = SPECGRAM
    frames = hann_frames(x, nfft, hop)           # (5168, 16384)
    tables = _device_tables(nfft, frames.device)

    def kern():
        return rfft_four_step_tall(frames)

    def plain():
        return rfft_two_pass_plain(frames, *tables, False)

    err = compare("k7", f"spectrogram frames {tuple(frames.shape)} X",
                  kern(), plain(), bound_db=110.0)
    compare("k7", f"spectrogram frames {tuple(frames.shape)} |X|",
            rfft_four_step_tall(frames, magnitude=True),
            rfft_two_pass_plain(frames, *tables, True), bound_db=110.0)
    return {"max_abs_err": err, "kern": kern, "plain": plain,
            "lib": lambda: torch.fft.rfft(frames),
            "bound": rfft_bound(frames.shape[0], nfft, 8)}


def phase_k8(x: torch.Tensor) -> dict:
    from dsp_audio_project_tpu_torch.kernels.rfft_two_pass import (
        _device_tables, rfft_two_level, rfft_two_pass_plain,
    )

    n = HUGE_NFFT
    mid = x.shape[-1] // 2                # magnitude_spectrum's centre window
    rows = (x[:, mid: mid + n] * hann(n, x.device)).contiguous()  # (8, 2^20)
    tables = _device_tables(n, rows.device)
    exact = np.fft.rfft(rows.cpu().double().numpy())
    errs = {}
    for magnitude in (False, True):
        got = rfft_two_level(rows, magnitude=magnitude)
        form = "|X|" if magnitude else "X"
        errs[magnitude] = compare(
            "k8", f"{tuple(rows.shape)} {form}", got,
            rfft_two_pass_plain(rows, *tables, magnitude), bound_db=110.0)
        want = torch.as_tensor(np.abs(exact) if magnitude else exact)
        compare("k8", f"{tuple(rows.shape)} {form} vs float64 rfft",
                got.cpu().to(want.dtype), want, bound_db=110.0)

    def kern():
        return rfft_two_level(rows, magnitude=True)

    def plain():
        return rfft_two_pass_plain(rows, *tables, True)

    return {"max_abs_err": errs[True], "kern": kern, "plain": plain,
            "lib": lambda: torch.fft.rfft(rows).abs(),
            "bound": rfft_bound(rows.shape[0], n, 4)}


def phase_k3(pipe, x: torch.Tensor, small: torch.Tensor):
    """The frames kernel vs its plain version at the serving shape, then
    every entry point that runs it (K3 'rect', K4 'class', K5 'shear', K6
    flat and ``forward_flat``, E1 as fir_path='pallas', E3-E5) at a small
    shape and at the serving shape: each must launch the kernel and agree.
    The serving runs are counted.  (k3 record entry, {tag: record entry}
    of K4-K6, E1, E3-E5, counts)."""
    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch.kernels import fir_frames
    from dsp_audio_project_tpu_torch.kernels.experiments import (
        polyphase_fir_dma, polyphase_fir_rect_rowdma,
        polyphase_fir_rect_splitbank,
    )
    from dsp_audio_project_tpu_torch.kernels.fir_class import (
        fir_frames_kernel, fir_frames_plain, frame_grid, polyphase_fir,
        polyphase_fir_class_flat,
    )

    plan = pipe._plan()
    cfg = pipe.config
    n_out = cfg.src.output_length(x.shape[-1])
    f_pad = frame_grid(n_out, plan.P)
    G = pipe.G

    def kern():
        return fir_frames_kernel(x, G, plan.s, f_pad, -plan.lo)

    def plain():
        return fir_frames_plain(x, G, plan.s, f_pad, -plan.lo)

    y, ref = kern(), plain()
    torch.cuda.synchronize()
    err = compare("k3", "frames", y, ref)
    pallas = pt.AudioPipeline(pt.PipelineConfig(
        src=cfg.src, eq=cfg.eq, kernels=pt.KernelConfig(fir_path="pallas")),
        device=DEVICE)
    # name: (entry point (x, n_out) -> frames or flat y, its counter, tag
    # of its record row or None)
    routes = {
        "fir_frames rect (K3)": (
            lambda a, ns: fir_frames(a, plan, ns, kernel="rect"),
            "fir_frames_kernel", None),
        "fir_frames class (K4)": (
            lambda a, ns: fir_frames(a, plan, ns, kernel="class"),
            "polyphase_fir_class_frames", "k4"),
        "fir_frames shear (K5)": (
            lambda a, ns: fir_frames(a, plan, ns, kernel="shear"),
            "polyphase_fir_shear_frames", "k5"),
        "flat (K6)": (lambda a, ns: polyphase_fir_class_flat(a, plan, ns),
                      "polyphase_fir_class_flat", "k6"),
        "forward_flat (K6)": (lambda a, ns: pipe.forward_flat(a, FS)[1],
                              "polyphase_fir_class_flat", None),
        "E1 polyphase_fir": (lambda a, ns: polyphase_fir(a, plan, ns),
                             "polyphase_fir", "e1"),
        "fir_path='pallas' (E1)": (lambda a, ns: pallas._forward(a, FS)[1],
                                   "polyphase_fir", None),
        "E3 polyphase_fir_dma": (
            lambda a, ns: polyphase_fir_dma(a, plan, ns),
            "polyphase_fir_dma", "e3"),
        "E4 polyphase_fir_rect_splitbank": (
            lambda a, ns: polyphase_fir_rect_splitbank(a, plan, ns),
            "polyphase_fir_rect_splitbank", "e4"),
        "E5 polyphase_fir_rect_rowdma": (
            lambda a, ns: polyphase_fir_rect_rowdma(a, plan, ns),
            "polyphase_fir_rect_rowdma", "e5"),
    }
    entries, total = {}, None
    for where, a in (("small", small), ("serving", x)):
        ns = cfg.src.output_length(a.shape[-1])
        nf = -(-ns // plan.P)
        want = (ref[:, :nf] if a is x
                else fir_frames_plain(a, G, plan.s, nf, -plan.lo))
        want_flat = want.reshape(a.shape[0], -1)[:, :ns]
        for name, (fn, counter, tag) in routes.items():
            got, counts = run_counted(functools.partial(fn, a, ns))
            if counts[counter] < 1 or counts["fir_frames_kernel"] < 1:
                raise RuntimeError(f"{name} did not launch the frames kernel")
            want_r = want if got.ndim == 3 else want_flat
            route_err = compare("k3", f"{where} {name} (launched "
                                f"{counts[counter]})", got, want_r)
            if where == "serving":
                total = counts if total is None else {
                    k: total[k] + counts[k] for k in total}
                if tag is not None:
                    flat = got.ndim == 2
                    entries[tag] = {
                        "max_abs_err": route_err,
                        "kern": functools.partial(fn, x, ns),
                        "plain": functools.partial(
                            _frames_plain, x, G, plan, nf,
                            ns if flat else None),
                        "lib": conv_yardstick(x, G, plan.s, nf, -plan.lo),
                        "bound": fir_bound(x.shape[0], nf, plan.W, plan.P,
                                           x.shape[-1])[0]}
    lib = conv_yardstick(x, G, plan.s, f_pad, -plan.lo)
    b, simt, flops = fir_bound(x.shape[0], f_pad, plan.W, plan.P,
                               x.shape[-1])
    return ({"max_abs_err": err, "kern": kern, "plain": plain, "lib": lib,
             "bound": b, "simt_bound": simt, "flops": flops, "y": y},
            entries, total)


def _frames_plain(x, G, plan, frames: int, flat_len):
    """The plain frames of an entry point: (B, frames, P), or viewed flat
    and cropped to ``flat_len``."""
    from dsp_audio_project_tpu_torch.kernels.fir_class import fir_frames_plain

    y = fir_frames_plain(x, G, plan.s, frames, -plan.lo)
    return y if flat_len is None else y.reshape(x.shape[0], -1)[:, :flat_len]


def phase_k9(pipe, k1: dict, k3: dict) -> dict:
    from dsp_audio_project_tpu_torch.kernels.eq_finish import (
        eq_finish, eq_finish_plain,
    )
    from dsp_audio_project_tpu_torch.kernels.fir_class import frame_grid
    from dsp_audio_project_tpu_torch.ops.eq import _true_states
    from dsp_audio_project_tpu_torch.ops.src import make_plan

    y0, inj = k1["y0"], k1["inj"]
    B, F_, U = y0.shape
    d = inj.shape[-1]
    K = F_ // 128
    tables = pipe._tables(FS, K)
    gout = tables["group_out"]
    st = _true_states(inj.reshape(B, K, 128, d), tables)[0].reshape(B, F_, d)
    # The frames path reads y0 as a column slice of [y0 | inj | 0].
    cat = k3["y"].reshape(B, K, 128, U) @ tables["w_frames"]
    st_f = _true_states(cat[..., U:U + d], tables)[0]
    # A U % 4 != 0 plan (441/480) at its serving shape: the scalar path.
    rng = np.random.default_rng(13)
    p441 = make_plan(441, 480)
    f441 = frame_grid(-(-int(SECONDS * FS) * 441 // 480), p441.P)
    y441, st441, g441 = (
        torch.as_tensor((scale * rng.standard_normal(shape)).astype(np.float32),
                        device=DEVICE)
        for scale, shape in ((0.5, (B, f441, 441)), (1.0, (B, f441, d)),
                             (0.2, (d, 441))))
    cases = (("cat (contiguous y0)", y0, st, gout),
             (f"frames (y0 slice, row stride {cat.shape[-1]})",
              cat[..., :U], st_f, gout),
             ("441/480 (U = 441)", y441, st441, g441))
    errs = []
    for name, a, s_, g in cases:
        z, ref = eq_finish(a, s_, g), eq_finish_plain(a, s_, g)
        torch.cuda.synchronize()
        errs.append(compare("k9", name, z, ref))

    def kern():
        return eq_finish(y0, st, gout)

    def plain():
        return eq_finish_plain(y0, st, gout)

    b = bound(2.0 * y0.numel() * d,
              4.0 * (2 * y0.numel() + st.numel() + gout.numel()))
    return {"max_abs_err": errs[0], "kern": kern, "plain": plain,
            "lib": None, "bound": b}


def oracle_outputs(pipe, xs: np.ndarray) -> list:
    """Per signal: (y, z, [spectrum of x, y, z]) from the numpy oracle."""
    from dsp_audio_project_tpu_torch import oracle

    cfg = pipe.config
    cap = cfg.spectrum.analysis_limit
    out = []
    for i in range(xs.shape[0]):
        y_want, fs_out = oracle.resample_oracle(xs[i], FS, cfg.src, "fast")
        z_want = oracle.equalize_oracle(y_want, fs_out, cfg.eq)
        spec = [oracle.spectrum_oracle(sig[:cap], rate, cfg.spectrum)[1]
                for sig, rate in ((xs[i], FS), (y_want, fs_out),
                                  (z_want, fs_out))]
        out.append((y_want, z_want, spec))
    return out


def gate(tag: str, want: list, z, y, mags) -> None:
    """z (and y when given) and the three spectra >= 60 dB vs the oracle."""
    from dsp_audio_project_tpu_torch import oracle

    worst = {"z": math.inf, "y": math.inf, "spectra": math.inf}
    z = z.cpu().numpy()
    y = None if y is None else y.cpu().numpy()
    mags = [m.cpu().numpy() for m in mags]
    for i, (y_want, z_want, spec) in enumerate(want):
        worst["z"] = min(worst["z"], oracle.snr_db(z_want, z[i]))
        if y is not None:
            worst["y"] = min(worst["y"], oracle.snr_db(y_want, y[i]))
        for s_want, m in zip(spec, mags):
            worst["spectra"] = min(worst["spectra"],
                                   oracle.snr_db(s_want, m[i]))
    if y is None:
        del worst["y"]
    log(f"[{tag}] vs oracle, min snr over {len(want)} signals: "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in worst.items())
        + " (gate 60)")
    if not all(v >= 60.0 for v in worst.values()):
        raise RuntimeError(f"[{tag}] output below the 60 dB oracle gate")


def run_counted(fn):
    """fn() with the launch counts set to 0 just before and read just after."""
    from dsp_audio_project_tpu_torch.kernels import (
        launch_counts, reset_launch_counts,
    )

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def require(tag: str, counts: dict, names) -> None:
    log(f"[{tag}] launches: {counts}")
    missing = [n for n in names if counts[n] < 1]
    if missing:
        raise RuntimeError(f"[{tag}] kernels of the path did not launch: "
                           f"{missing}")


def phase_slice(pipe, x: torch.Tensor, want: list) -> dict:
    cfg = pipe.config
    n_out = cfg.src.output_length(x.shape[-1])
    (z, mags), counts = run_counted(lambda: pipe.forward_cat_spectra(x, FS))
    require("slice", counts, ("polyphase_fir_class_rect_cat", "eq_finish",
                              "rfft_four_step_magnitude"))
    zf = z.reshape(BATCH, -1)[:, :n_out]
    if not bool(torch.isfinite(zf).all()):
        raise RuntimeError("non-finite output")
    gate("slice", want, zf, None, mags)
    z_torch = pipe.forward_cat(x, FS, finish="torch")
    torch.cuda.synchronize()
    s = snr_db(z_torch, z)
    log(f"[slice] z finish='kernel' vs finish='torch': snr {s:.1f} dB "
        "(bound 120)")
    if not s > 120.0:
        raise RuntimeError("the K9 finish disagrees with the torch finish")
    return counts


def phase_frames(pipe, x: torch.Tensor, want: list) -> dict:
    needed = ("fir_frames_kernel", "eq_finish", "rfft_four_step_magnitude")
    n_out = pipe.config.src.output_length(x.shape[-1])
    out, counts = run_counted(lambda: pipe(x, FS, with_spectra=True))
    require("frames", counts, needed)
    if out.output.shape != (BATCH, n_out) or out.fs_out != 48000:
        raise RuntimeError(f"pipe(x, fs): z {tuple(out.output.shape)}, "
                           f"fs_out {out.fs_out}")
    if not bool(torch.isfinite(out.output).all()):
        raise RuntimeError("non-finite output")
    gate("frames", want, out.output, out.resampled,
         [out.spectra[k][1] for k in ("input", "resampled", "output")])
    (zf, yf, mags), counts2 = run_counted(
        lambda: pipe.forward_frames_spectra(x, FS))
    require("frames", counts2, needed)
    gate("frames", want, zf.reshape(BATCH, -1)[:, :n_out],
         yf.reshape(BATCH, -1)[:, :n_out], mags)
    return {k: counts[k] + counts2[k] for k in counts}


def numpy_stft(xs: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    """float64 reference STFT (pad_end): Hann frames through np.fft.rfft."""
    n = xs.shape[-1]
    frames = -(-n // hop)
    xp = np.pad(xs.astype(np.float64), ((0, 0), (0, (frames - 1) * hop
                                                  + nfft - n)))
    win = np.lib.stride_tricks.sliding_window_view(xp, nfft, axis=-1)[:, ::hop]
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / (nfft - 1))
    return np.fft.rfft(win * hann, axis=-1)


def phase_analysis(cfg, x: torch.Tensor, xs: np.ndarray, want: list):
    """The four analysis paths, each counted on its own: (counts summed,
    the paths as callables for [time])."""
    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch import oracle

    def gate(tag, snrs):
        worst = min(snrs)
        log(f"[analysis] {tag}: min snr over {len(snrs)} signals "
            f"{worst:.1f} dB vs float64 numpy / the oracle (gate 60)")
        if not worst >= 60.0:
            raise RuntimeError(f"[analysis] {tag} below the 60 dB gate")

    def run(tag, fn, name, times):
        out, counts = run_counted(fn)
        log(f"[analysis] {tag}: launches {counts}")
        if counts[name] != times:
            raise RuntimeError(f"[analysis] {tag} launched {name} "
                               f"{counts[name]} times, not {times}")
        return out, counts

    # Each path binds its own sizes: they are called again in [time].
    nfft, hop = STFT
    stft = functools.partial(pt.stft, x, nfft=nfft, hop=hop)
    s, counts = run(f"stft nfft={nfft} hop={hop}", stft,
                    "rfft_four_step_complex", 1)
    total = counts
    ref = numpy_stft(xs, nfft, hop)
    got = s.cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise RuntimeError(f"stft: {got.shape} vs {ref.shape}, or not finite")
    gate("stft", [oracle.snr_db(np.stack([r.real, r.imag]),
                                np.stack([g.real, g.imag]))
                  for r, g in zip(ref, got)])
    del s, ref, got

    nfft, hop = SPECGRAM
    spec = functools.partial(pt.spectrogram, x, nfft=nfft, hop=hop)
    p, counts = run(f"spectrogram nfft={nfft} hop={hop}", spec,
                    "rfft_four_step_tall", 1)
    ref = np.abs(numpy_stft(xs, nfft, hop)) ** 2
    got = p.cpu().numpy()
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise RuntimeError(f"spectrogram: {got.shape} vs {ref.shape}")
    gate("spectrogram", [oracle.snr_db(r, g) for r, g in zip(ref, got)])
    total = {k: total[k] + counts[k] for k in total}
    del p, ref, got

    scfg = pt.SpectrumConfig(nfft=LONG_NFFT)
    long_pipe = pt.AudioPipeline(pt.PipelineConfig(
        src=cfg.src, eq=cfg.eq, kernels=cfg.kernels, spectrum=scfg),
        device=DEVICE)
    call = functools.partial(long_pipe, x, FS, with_spectra=True)
    out, counts = run(f"pipe(x, fs, with_spectra=True) nfft={LONG_NFFT}",
                      call, "rfft_four_step_tall", 3)
    snrs = []
    fs_out = cfg.src.output_rate(FS)
    for i, (y_want, z_want, _) in enumerate(want):
        for sig, rate, key in ((xs[i], FS, "input"),
                               (y_want, fs_out, "resampled"),
                               (z_want, fs_out, "output")):
            ref = oracle.spectrum_oracle(sig[:scfg.analysis_limit], rate,
                                         scfg)[1]
            got = out.spectra[key][1][i].cpu().numpy()
            if got.shape != ref.shape:
                raise RuntimeError(f"{key} spectrum {got.shape}")
            snrs.append(oracle.snr_db(ref, got))
    gate(f"with_spectra nfft={LONG_NFFT} (x, y, z)", snrs)
    total = {k: total[k] + counts[k] for k in total}

    hcfg = pt.SpectrumConfig(nfft=HUGE_NFFT, analysis_limit=0)
    huge = functools.partial(pt.magnitude_spectrum, x, FS, hcfg)
    (freqs, mag), counts = run(f"magnitude_spectrum nfft={HUGE_NFFT}", huge,
                               "rfft_two_level", 1)
    got = mag.cpu().numpy()
    snrs = []
    for i in range(xs.shape[0]):
        f_ref, ref = oracle.spectrum_oracle(xs[i], FS, hcfg)
        if got[i].shape != ref.shape or not np.array_equal(f_ref, freqs):
            raise RuntimeError("magnitude_spectrum: shape or axis")
        snrs.append(oracle.snr_db(ref, got[i]))
    gate(f"magnitude_spectrum nfft={HUGE_NFFT}", snrs)
    total = {k: total[k] + counts[k] for k in total}
    paths = {f"stft nfft={STFT[0]}": stft,
             f"spectrogram nfft={SPECGRAM[0]}": spec,
             f"pipe(x, fs, with_spectra=True) nfft={LONG_NFFT}": call,
             f"magnitude_spectrum nfft={HUGE_NFFT}": huge}
    return total, paths


# ---- the explicit-kernel routes and the experiments (E2-E7) ---------------

E2_DB, E2_REL = 80.0, 1e-3   # 8192 dependent fp32 steps, poles at r ~ 0.996


def eq_operators(cfg, block: int, unroll: int):
    """The EQ's block operators at the output rate for (block, unroll)."""
    from dsp_audio_project_tpu_torch.ops.eq import make_block_operators

    fs_out = cfg.src.output_rate(FS)
    return make_block_operators(cfg.eq.active_bands(fs_out), fs_out,
                                cfg.eq.q, block, unroll)


def phase_explicit(cfg, x: torch.Tensor, want: list):
    """``pipe_explicit(x, FS, with_spectra=True)`` with fir_path='pallas',
    iir_path='pallas': (counts, the pipeline, its flat y)."""
    import dsp_audio_project_tpu_torch as pt

    kc = cfg.kernels
    pipe = pt.AudioPipeline(pt.PipelineConfig(
        src=cfg.src, eq=cfg.eq, spectrum=cfg.spectrum,
        kernels=pt.KernelConfig(fir_path="pallas", iir_path="pallas",
                                src_fast=kc.src_fast, eq_fast=kc.eq_fast)),
        device=DEVICE)
    n_out = cfg.src.output_length(x.shape[-1])
    out, counts = run_counted(lambda: pipe(x, FS, with_spectra=True))
    require("explicit", counts, ("fir_frames_kernel", "block_end_states",
                                 "block_apply", "rfft_four_step_magnitude"))
    if out.output.shape != (BATCH, n_out) or out.fs_out != 48000:
        raise RuntimeError(f"pipe_explicit(x, fs): z {tuple(out.output.shape)}")
    if not bool(torch.isfinite(out.output).all()):
        raise RuntimeError("non-finite output")
    gate("explicit", want, out.output, out.resampled,
         [out.spectra[k][1] for k in ("input", "resampled", "output")])
    return counts, pipe, out.resampled


def phase_e2(cfg, y: torch.Tensor) -> tuple[dict, dict]:
    """E2a and E2b vs their plain versions on the explicit path's own
    blocks (y padded to K whole blocks of KernelConfig's iir_block), and
    through the path's own row launchers on the unpadded y."""
    import torch.nn.functional as F

    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch.kernels.experiments import iir
    from dsp_audio_project_tpu_torch.ops.eq import _carry_states, carry_tables

    kc = pt.KernelConfig()
    block = kc.iir_block
    ops = eq_operators(cfg, block, kc.iir_unroll)
    n = y.shape[-1]
    K = -(-n // block)
    xb = F.pad(y, (0, K * block - n)).reshape(y.shape[0], K, block)
    consts = iir.device_tables(iir._plain_consts, ops, device=y.device)
    e = iir.block_end_states(xb, ops)
    e_ref = iir.block_end_states_plain(xb, *consts[:2])
    torch.cuda.synchronize()
    err_a = compare("e2", f"E2a end states, {xb.shape[0] * K} blocks of "
                    f"{block}", e, e_ref, bound_db=E2_DB, rel=E2_REL)
    tables = carry_tables(ops, y.device, K)
    sigma = _carry_states(e, tables["state_corr"],
                          tables.get("carry_w")).contiguous()
    yk = iir.block_apply(xb, sigma, ops)
    y_ref = iir.block_apply_plain(xb, sigma, *consts)
    torch.cuda.synchronize()
    err_b = compare("e2", "E2b outputs", yk, y_ref, bound_db=E2_DB,
                    rel=E2_REL)
    # The path's own launches: the unpadded rows (the last block ragged,
    # zeros read past n), E2b clipped and cropped to n as it writes.
    rows = y.contiguous()
    er = iir.end_states_rows(rows, block, ops)
    yr = iir.apply_rows(rows, sigma, block, ops)
    torch.cuda.synchronize()
    compare("e2", f"E2a on the unpadded rows (n = {n})", er, e_ref,
            bound_db=E2_DB, rel=E2_REL)
    compare("e2", "E2b on the unpadded rows, clipped", yr,
            torch.clamp(y_ref.reshape(y.shape[0], -1)[:, :n], -1.0, 1.0),
            bound_db=E2_DB, rel=E2_REL)
    chains, d = xb.shape[0] * K, e.shape[-1]
    e2a = {"max_abs_err": err_a, "lib": None, "plain_reps": 2,
           "kern": lambda: iir.block_end_states(xb, ops),
           "plain": lambda: iir.block_end_states_plain(xb, *consts[:2]),
           **algebra_bound(chains, block, d, ("inj", "horner"), 0,
                           4.0 * (xb.numel() + e.numel()))}
    e2b = {"max_abs_err": err_b, "lib": None, "plain_reps": 2,
           "kern": lambda: iir.block_apply(xb, sigma, ops),
           "plain": lambda: iir.block_apply_plain(xb, sigma, *consts),
           **algebra_bound(chains, block, d,
                           ("inj", "horner", "fir", "readout"), 0,
                           4.0 * (2 * xb.numel() + sigma.numel()))}
    return e2a, e2b


def group_fmas(block: int, d: int, U: int) -> dict:
    """Multiply-adds a block of the group algebra at group length U: the
    injections, the Horner pass, the triangular FIR product (U(U+1)/2 a
    group; the ragged group's r(r+1)/2), the readout and E7's fold of
    sigma into each group's entry state."""
    from dsp_audio_project_tpu_torch.kernels.experiments import iir_group

    G, r = iir_group.groups(block, U)
    return {"inj": block * d, "horner": G * d * d,
            "fir": (G - 1) * U * (U + 1) // 2 + r * (r + 1) // 2,
            "readout": block * d, "fold": G * d * d}


def algebra_bound(chains: int, block: int, d: int, parts, extra: int,
                  nbytes: float) -> dict:
    """The bound of ``chains`` blocks of the group algebra: the larger of
    the bytes and the fewest multiply-adds of ``parts`` (plus ``extra`` a
    block) over every group length U; beside it, for the [time] line, the
    same count at the kernels' own U."""
    from dsp_audio_project_tpu_torch.kernels.experiments import iir_group

    def flops(U: int) -> float:
        f = group_fmas(block, d, U)
        return 2.0 * chains * (sum(f[p] for p in parts) + extra)

    least, u_least = min((flops(U), U) for U in range(1, block + 1))
    return {"bound": bound(least, nbytes),
            "alg_bound": (*bound(flops(iir_group.GROUP), nbytes),
                          iir_group.GROUP, least / PEAK_FLOPS * 1e3, u_least)}


def phase_e7(cfg, y: torch.Tensor, want: list):
    """E7 at the serving flat shape (y zero-padded to a multiple of 10
    blocks of 8192): its own counted run, vs its plain version and the
    oracle's z.  (kernel record entry, counts)."""
    import torch.nn.functional as F

    from dsp_audio_project_tpu_torch import oracle
    from dsp_audio_project_tpu_torch.kernels.experiments import (
        iir_group, iir_seq,
    )

    sb, block, unroll = 10, 8192, 128
    ops = eq_operators(cfg, block, unroll)
    n = y.shape[-1]
    L = -(-n // (sb * block)) * sb * block
    xf = F.pad(y, (0, L - n)).contiguous()
    z, counts = run_counted(
        lambda: iir_seq.equalize_seq_flat(xf, ops, super_blocks=sb))
    require("e7", counts, ("equalize_seq_flat",))
    tables = iir_seq.device_tables(iir_seq._seq_tables, ops, device=y.device)
    G = block // unroll

    def plain():
        return iir_seq.equalize_seq_plain(
            xf.reshape(xf.shape[0], -1, G, unroll), *tables).reshape(xf.shape)

    err = compare("e7", f"flat {tuple(xf.shape)}", z, plain())
    again = iir_seq.equalize_seq_flat(xf, ops, super_blocks=sb)
    if not torch.equal(again, z):
        raise RuntimeError("[e7] two runs on one input differ")
    log("[e7] a second run on the same input: bitwise equal (the fixed "
        "look-back window)")
    zh = z[:, :n].cpu().numpy()
    worst = min(oracle.snr_db(w[1], zh[i]) for i, w in enumerate(want))
    log(f"[e7] vs the oracle's z, min snr over {len(want)} signals "
        f"{worst:.1f} dB (gate 60)")
    if not worst >= 60.0:
        raise RuntimeError("[e7] output below the 60 dB oracle gate")
    K, d = L // block, tables[0].shape[1]
    # The group algebra, the fold of sigma into each group's entry state
    # and the look-back (W + 1 d x d products a block).
    b = algebra_bound(xf.shape[0] * K, block, d,
                      ("inj", "horner", "fir", "readout", "fold"),
                      (iir_group.WINDOW + 1) * d * d, 4.0 * 2 * xf.numel())
    return ({"max_abs_err": err, "lib": None, **b, "plain": plain,
             "kern": lambda: iir_seq.equalize_seq_flat(xf, ops,
                                                       super_blocks=sb)},
            counts)


def phase_e6(x: torch.Tensor):
    """E6 at one row of every N from 4 to 32768 and at 65536 (the two-pass
    route), then its own counted run at the STFT's (41344, 2048) frames.
    (kernel record entry, counts)."""
    from dsp_audio_project_tpu_torch.kernels.experiments import (
        rfft_butterfly as rb,
    )

    rng = np.random.default_rng(23)
    n = 4
    while n <= 2 * rb.MAX_N:
        row = torch.as_tensor(rng.standard_normal((1, n)).astype(np.float32),
                              device=DEVICE)
        got = rb.rfft_butterfly(row)
        if n <= rb.MAX_N:
            compare("e6", f"N={n}", got,
                    rb.rfft_butterfly_plain(row, *rb.radix_device_tables(
                        n, row.device)), bound_db=110.0)
        exact = torch.as_tensor(np.fft.rfft(row.cpu().double().numpy()))
        compare("e6", f"N={n} vs float64 rfft"
                + (" (two-pass route)" if n > rb.MAX_N else ""),
                got.cpu().to(exact.dtype), exact, bound_db=135.0)
        n *= 2
    nfft, hop = STFT
    frames = hann_frames(x, nfft, hop)           # (41344, 2048)
    tables = rb.radix_device_tables(nfft, frames.device)
    got, counts = run_counted(lambda: rb.rfft_butterfly(frames))
    require("e6", counts, ("rfft_butterfly",))

    def plain():
        return in_chunks(lambda r: rb.rfft_butterfly_plain(r, *tables),
                         frames, chunk=8192)

    err = compare("e6", f"stft frames {tuple(frames.shape)}", got, plain(),
                  bound_db=110.0)
    return ({"max_abs_err": err, "kern": lambda: rb.rfft_butterfly(frames),
             "plain": plain, "lib": lambda: torch.fft.rfft(frames),
             "bound": rfft_bound(frames.shape[0], nfft, 8)}, counts)


def host_ms(fn, reps: int = REPS) -> tuple[float, float, float]:
    """(median, min, max) host-clock ms until one call returns, the device
    idle before it: what the host spends to enqueue a call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times), min(times), max(times)


def phase_profile(chains: dict, calls: int = 5) -> None:
    """torch.profiler over ``calls`` calls of each chain (after one warm-up
    step): device time per call by kernel, and the total."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for name, fn in chains.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls),
                     acc_events=True) as prof:
            for _ in range(calls + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        rows = []
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
            # Device activity: device time and no CPU time; the profiler's
            # own ProfilerStep span is not a kernel.
            if (us > 0 and evt.self_cpu_time_total == 0
                    and not evt.key.startswith("ProfilerStep")):
                rows.append((us / calls, evt.count / calls, evt.key))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        log(f"[profile] {name}, batch {BATCH} x {SECONDS:.0f} s: device "
            f"kernel time {total:.1f} us per call over {calls} calls")
        for us, per_call, key in rows[:12]:
            log(f"[profile]   {us:9.1f} us {100 * us / total:5.1f} % "
                f"x{per_call:g}  {key[:90]}")


def main() -> None:
    profile_too = "--profile" in sys.argv[1:]
    kind, smi = phase_device()
    phase_build()

    import dsp_audio_project_tpu_torch as pt

    cfg = pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(src_fast=True, eq_fast=True),
    )
    pipe = pt.AudioPipeline(cfg, device=DEVICE)
    n = int(SECONDS * FS)
    xs = make_batch(n)
    x = torch.as_tensor(xs, device=DEVICE)
    small = x[:2, : FS // 4].contiguous()
    t0 = time.perf_counter()
    pt.tables_from_numpy(pipe, FS, pt.design_tables(cfg, FS))
    log(f"[setup] host design tables: {time.perf_counter() - t0:.2f} s")

    k1 = phase_k1(pipe, x)
    k2 = phase_k2()
    k2c = phase_k2c(x)
    k3, k3_routes, k3_counts = phase_k3(pipe, x, small)
    k9 = phase_k9(pipe, k1, k3)
    del k1["y0"], k1["inj"], k3["y"]
    k7 = phase_k7(x)
    k8 = phase_k8(x)
    t0 = time.perf_counter()
    want = oracle_outputs(pipe, xs)
    log(f"[oracle] numpy oracle for {BATCH} signals: "
        f"{time.perf_counter() - t0:.2f} s")
    runs = [phase_slice(pipe, x, want), phase_frames(pipe, x, want)]
    analysis_counts, analysis_paths = phase_analysis(cfg, x, xs, want)
    runs.append(analysis_counts)
    explicit_counts, pipe_explicit, y_flat = phase_explicit(cfg, x, want)
    runs.append(explicit_counts)
    e2a, e2b = phase_e2(cfg, y_flat)
    e7, e7_counts = phase_e7(cfg, y_flat, want)
    del y_flat
    e6, e6_counts = phase_e6(x)
    runs += [e7_counts, e6_counts, k3_counts]
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}

    chains = {
        "pipe(x, fs, with_spectra=True)":
            lambda: pipe(x, FS, with_spectra=True),
        "forward_frames_spectra": lambda: pipe.forward_frames_spectra(x, FS),
        "forward_cat_spectra": lambda: pipe.forward_cat_spectra(x, FS),
        **analysis_paths,
        "pipe_explicit(x, fs, with_spectra=True)":
            lambda: pipe_explicit(x, FS, with_spectra=True),
    }
    log(f"[time] card: {smi}")
    for name, fn in chains.items():
        per_call = time_ms(fn)
        b2b = back_to_back_ms(fn)
        host = host_ms(fn)
        log(f"[time] chain {name}, batch {BATCH} x {SECONDS:.0f} s: "
            f"{per_call:.4f} ms per call (median) -> {per_call / BATCH:.4f} "
            f"ms per signal; back to back {b2b:.4f} ms per call -> "
            f"{b2b / BATCH:.4f} ms per signal; host {host[0]:.4f} ms per "
            f"call (min {host[1]:.4f}, max {host[2]:.4f})")
    finish = {"kernel": [], "torch": []}
    for mode in ("kernel", "torch", "torch", "kernel"):
        finish[mode].append(time_ms(
            lambda: pipe.forward_cat_spectra(x, FS, finish=mode)))
    log("[time] chain forward_cat_spectra by finish, in turns (kernel, "
        f"torch, torch, kernel): kernel {finish['kernel']} ms, torch "
        f"{finish['torch']} ms per call")

    kernels = {"k1": k1, "k2": k2, "k3": k3, "k9": k9, "k2c": k2c,
               "k7": k7, "k8": k8, "e2a": e2a, "e2b": e2b, "e7": e7, "e6": e6,
               **k3_routes}
    timings = {}
    for tag, k in kernels.items():
        # The plain E2 loops over 8192 steps on the host: fewer runs.
        reps = k.get("plain_reps", REPS)
        timings[tag] = {"ms": time_ms(k["kern"]),
                        "plain_ms": time_ms(k["plain"], reps, min(reps, WARMUP)),
                        "library_ms": None if k["lib"] is None
                        else time_ms(k["lib"])}
        t = timings[tag]
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms")
        note = ("" if "simt_bound" not in k else
                f"; fp32 SIMT bound {k['simt_bound'][0]:.4f} ms "
                f"({k['simt_bound'][1]}); the three TF32 products at "
                f"{k['flops'] / t['ms'] / 1e9:.1f} TFLOP/s")
        if "alg_bound" in k:
            ms, by, u, least, u_least = k["alg_bound"]
            note = (f"; the group algebra's operations {least:.4f} ms at "
                    f"the fewest (U = {u_least}), bound {ms:.4f} ms ({by}) "
                    f"at the kernel's U = {u}")
        log(f"[time] {tag}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms (median of {reps}), library {lib}, "
            f"bound {k['bound'][0]:.4f} ms ({k['bound'][1]}){note}")

    if profile_too:
        phase_profile({**chains,
                       "E6 rfft_butterfly at the STFT's (41344, 2048) frames":
                           e6["kern"],
                       "E7 equalize_seq_flat at 8 x 2,949,120": e7["kern"]})

    rows = (
        ("k1", "polyphase_fir_class_rect_cat", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/fir_class.py:731"),
        ("k2", "rfft_four_step_magnitude", "csrc/rfft_four_step.cu",
         "dsp_audio_project_tpu/kernels/rfft.py:125"),
        ("k3", "fir_frames_kernel", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/fir_class.py:928"),
        ("k4", "polyphase_fir_class_frames", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/fir_class.py:1042"),
        ("k5", "polyphase_fir_shear_frames", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/fir_shear.py:167"),
        ("k6", "polyphase_fir_class_flat", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/fir_class.py:312"),
        ("e1", "polyphase_fir", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/experiments/fir.py:61"),
        ("e3", "polyphase_fir_dma", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/experiments/fir_dma.py:70"),
        ("e4", "polyphase_fir_rect_splitbank", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/experiments/fir_splitbank.py:103"),
        ("e5", "polyphase_fir_rect_rowdma", "csrc/fir_cat.cu",
         "dsp_audio_project_tpu/kernels/experiments/fir_rowdma.py:89"),
        ("k9", "eq_finish", "csrc/eq_finish.cu",
         "dsp_audio_project_tpu/kernels/eq_finish.py:50"),
        ("k2c", "rfft_four_step_complex", "csrc/rfft_four_step.cu",
         "dsp_audio_project_tpu/kernels/rfft.py:125"),
        ("k7", "rfft_four_step_tall", "csrc/rfft_two_pass.cu",
         "dsp_audio_project_tpu/kernels/rfft.py:327"),
        ("k8", "rfft_two_level", "csrc/rfft_two_pass.cu",
         "dsp_audio_project_tpu/kernels/rfft.py:476"),
        ("e2a", "block_end_states", "csrc/iir_block.cu",
         "dsp_audio_project_tpu/kernels/experiments/iir.py:100"),
        ("e2b", "block_apply", "csrc/iir_block.cu",
         "dsp_audio_project_tpu/kernels/experiments/iir.py:134"),
        ("e7", "equalize_seq_flat", "csrc/iir_block.cu",
         "dsp_audio_project_tpu/kernels/experiments/iir_seq.py:127"),
        ("e6", "rfft_butterfly", "csrc/rfft_butterfly.cu",
         "dsp_audio_project_tpu/kernels/experiments/rfft_butterfly.py:76"),
    )
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"dsp_audio_project_tpu_torch/{src}", "replaces": replaces,
         "launches": launches[name],
         "max_abs_err": kernels[tag]["max_abs_err"],
         "ms": timings[tag]["ms"], "plain_ms": timings[tag]["plain_ms"],
         "bound_ms": kernels[tag]["bound"][0],
         "bound_by": kernels[tag]["bound"][1],
         "library_ms": timings[tag]["library_ms"]}
        for tag, name, src, replaces in rows
    ]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
