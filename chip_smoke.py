#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (or every GPU of
the host).

    python3 chip_smoke.py              # the run: build, check, time
    python3 chip_smoke.py --profile    # also torch.profiler tables by kernel

(``python3 chip_smoke.py --multicard-worker RANK WORLD DIR`` is one rank of
the [multicard] phase, and ``--capture-fail-worker`` [jit]'s capture
failure; the phases start those processes themselves.)

Drives the port (dsp_audio_project_tpu_torch) at its real size — 44.1 ->
48 kHz SRC (L/M = 160/147) + the 5-band EQ + |rfft| spectra of x, y and z
on the cat, frames and explicit-kernel (fir_path = iir_path = 'pallas')
paths, the dynamic-gain cat and frames paths, the streams (one signal in
100 ms chunks; eight channels in super-steps on each route), the sharded
chain and stream on virtual meshes of several shards on the card and
across cards (one process a card on NCCL, and one process over them), the
CLI, the native codec and the graph stages, the port's bench and chip
scripts, the analysis
ops (STFT, spectrogram, long-window spectra) and the experimental
kernels' entry points, 60 s signals, batch 8 — through the entry points a
user calls, and checks it.
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
 13. [dynamic] dynamic gains at the serving shape: three gain vectors
     (tests/test_eq_dynamic.py's complex-pole, real-pole and
     below-threshold sets), each through both builders ('host': float64
     numpy; 'traced': float64 on the card) and both dynamic forwards,
     each counted: ``forward_cat_dynamic_ops`` must launch K1 and K9,
     ``forward_frames_dynamic_ops`` the frames kernel and K9; z >= 60 dB
     against the oracle for its gains, host vs traced builder >= 90 dB,
     cat vs frames >= 110 dB, the static table caches unchanged; K1 at
     V = P + 12 = 172 and K9 at d = 12 vs plain (> 120 dB); then the
     gain change inside one captured CUDA graph: graph (change) runs the
     device builder and the G2 fold from a gains buffer, graph (cat) the
     cat forward (kernels counted at capture), both replayed for two
     gain vectors copied into the buffer, each output equal to the eager
     call bit for bit (or >= 130 dB, and the run says so) and >= 60 dB
     against the oracle, with no host design between the replays;
 14. [jit] the compiled forwards (``AudioPipeline.jit_forward_*``, all 11)
     on a pipeline of their own at 8 x 60 s: each first call (a warm-up
     and a CUDA-graph capture) counted, its warm-up's K1, frames-kernel,
     K9 and K2 launches held against their plain versions
     (``LaunchChecker``); each result equal to its eager forward bit for
     bit, z (and y and the spectra) >= 60 dB against the oracle (the
     dynamic ones against the oracle for DYN_GAINS[0]); a second call on
     another batch (and DYN_GAINS[1]) equal to the eager forward and the
     first result unchanged by it; on ``jit_forward_cat_spectra`` a third
     call with both results held (its outputs copied) and the rate switch
     44.1 -> 48 -> 44.1 kHz, each replay bit for bit; a forward that
     synchronizes, in its own process (``--capture-fail-worker``), must
     raise at its capture on every call and run nothing eagerly; the MB
     an entry holds and the output copy's cost; then ``[time] jit`` rows
     (call, back to back, host and device ms a call, each beside the
     eager forward's);
 15. [stream] streaming (streaming.py): (a) ``StreamProcessor`` on one
     row of the serving signal in 100 ms chunks and in a ragged chunking
     with a 1-sample chunk, each counted (the frames kernel, K9), z >= 110
     dB against that row of the one-shot ``pipe(x, fs)``; (b)
     ``ShardedStreamProcessor`` on ``single_device_mesh()`` at C = 8 over
     the serving batch, routes flat (FL 1024), fused frames (FL 512), cat
     (FL 1024), dynamic frames and dynamic cat (DYN_GAINS[0]), each counted
     (cat: K1 and K9; the others: the frames kernel and K9), each step one
     replayed CUDA graph captured once, z >= 110 dB against [slice]'s
     one-shot z; a checkpoint mid-stream resumed bit for bit; the eager
     step bit for bit against the replays; ``set_gains`` between two steps
     >= 110 dB against the same stream on a CPU copy of the processor, with
     no re-capture; K1 (num_frames = FL, pad_left = 0), the frames kernel
     (a step's and a 100 ms chunk's span) and K9 (a step's (C, K_loc, G,
     U)) vs plain (> 120 dB), folded into the record's max_abs_err;
 16. [sharded] sharding (parallel/): ``run_sharded`` on the routes plain
     (fused=False), fused and cat over the virtual meshes 1x1, 1x2, 1x4,
     1x8, 2x4 and 8x1 (every shard on the one card), each run counted (the
     frames kernel and K9; cat: K1 and K9), z (and y) >= 60 dB against the
     oracle outputs of [slice] and >= 110 dB against the route at 1x1, the
     cat route at 1x1 >= 110 dB against [slice]'s ``forward_cat`` z; K1 and
     the frames kernel at a shard's shapes (an interior 1x8 shard's
     halo-extended input, num_frames = frames_local, pad_left 0; the 1x1
     shard, pad_left = -lo) vs plain (> 120 dB), folded into the record's
     max_abs_err; ``ShardedStreamProcessor`` at C = 8 on 1x4 and 2x4 (cat
     FL 1024, fused frames FL 512, dynamic cat), each counted, one capture
     covering every shard, >= 110 dB against the one-shot z, the eager step
     and a mid-stream checkpoint resumed bit for bit;
 17. [multicard] several cards: one process a card (as many as the host
     has; on one card, one), joined on NCCL through a file rendezvous in a
     temporary directory, each running ``scripts/pod_scaling`` at 8 x 60 s
     (``initialize``, ``multihost_mesh``, the halo and carry collectives,
     ``gather_grid``; its gates: every channel >= 60 dB against the oracle
     and >= 110 dB against a 1x1 run of rank 0's card) and then
     ``run_sharded`` on each route over ``multihost_mesh`` at 1xN, Nx1 and
     (N >= 4) 2x(N/2), each counted; z >= 60 dB against the oracle outputs
     of [slice] and >= 110 dB against its ``forward_cat`` z.  With two
     cards or more, the same routes and the stream (cat, fused frames,
     dynamic cat: eager steps, a checkpoint resumed bit for bit) on meshes
     over the cards held in this process; with one, a line says that those
     were not run.  Every K1, frames-kernel and K9 launch of the phase, on
     every card, is held against its plain version (``LaunchChecker``);
 18. [surfaces] the surfaces (io/, native/, cli.py, app/, models/graph.py):
     the port's native codec built from native/ into _build/ and loaded;
     an 8-channel 60 s PCM16 WAV of the batch decoded bit for bit equal
     by the native engine and the numpy codec, ``encode_pcm16`` bit for
     bit equal to ``export_wav``; ``cli.main`` one-shot at 160/147 with
     the GAINS, --multichannel, --spectra and --report, counted (the
     frames kernel, K9, K2), its WAV >= 60 dB against ``export_wav`` of
     the oracle's z and within 1 LSB in >= 99.9 % of samples, its spectra
     >= 60 dB against the oracle, the report written; --stream-chunk 0.1
     and --mesh 1x1, counted, within 1 LSB of the one-shot WAV; an
     oversized --mesh exits 2; the telephone ``Chain`` counted (the
     frames kernel) and >= 60 dB against the stagewise oracle; [time]
     surfaces (host clock, median of 5): the decodes, the int16 encodes,
     and main() split into load, chain, export, spectra JSON, report;
 19. [bench] the port's bench (``dsp_audio_project_tpu_torch.bench``,
     ``bench.run``) at its full width, counted (K1, K9, K2, the frames
     kernel): the headline chains at 8 x 60 s, the accuracy gate over the
     8 signals, the dynamic section, the 240 s stream at C = 8 and FL =
     12288, the host baseline; its lines here, then its JSON record on a
     line of its own with the [bench] prefix, which must hold bench.py's
     keys and positive finite numbers; then one stream step at the bench's
     FL 12288 with K1, the frames kernel and K9 held against their plain
     versions at each geometry it launches (> 120 dB);
 20. [scripts] the chip scripts (``dsp_audio_project_tpu_torch.scripts``),
     each counted: ``config_matrix`` (all 79 configurations at 1 s a
     signal, each >= 60 dB through the call and, where supported, the
     compiled cat forward ``jit_forward_cat()``, whose warm-up launches
     are eager), ``rfft_sweep`` at its default sizes (K7 vs float64 numpy),
     ``stream_sweep`` at FL 2048 and 8192, ``dyn_pipeline`` at 3 cycles
     (its graph expand bit for bit against the eager one), and
     ``graft_entry.entry()``'s program once (z >= 60 dB against the oracle);
     K1, the frames kernel, K9 and K2 held against their plain versions
     at every eager launch of config_matrix and graft_entry and at each
     geometry of stream_sweep (its steps checked first, outside the timed
     passes) and dyn_pipeline (> 120 dB, K2 > 110 dB, max abs err <= 1e-5
     * max|ref|; the errors go into the record's max_abs_err);
 21. [time] CUDA-event timings (median of 20 runs after 20 warm-up runs;
     the plain E2 versions, an 8192-step host loop, median of 2 after 2):
     the chains and analysis paths per call (per call, and per call of 20
     back-to-back calls; the host's own time per call), the cat chain with
     either finish in turns, and each kernel beside its plain version and
     one PyTorch library call computing the same function (``library_ms``;
     the port never calls it); for dynamic gains one gain change (the
     host builder's host tables, upload and expand; the device builder,
     eager and as a graph replay; the G2 fold) and the dynamic chains per
     call, eager and as graph replays, beside the static ``forward_cat``;
     for streams, (a)'s host ms per 100 ms chunk, the one-shot cat
     chain's samples/s, and for cat steps at FL 2048, 8192 and 24576 on an
     8 x 330 s signal the input samples/s with the signal in one
     process() call and one step's input a call, the host ms per step by
     part, the device ms per step (a graph replay), the bytes up and down
     per step, the pinned copy rates of the step's size and the step's
     bound max(device, up / H2D, down / D2H); for sharding, ``run_sharded``
     cat per call at 1x1 and 1x8 beside ``forward_cat`` (ms, host ms, and
     device ms by the profiler) with the frames each plan pads to, and one
     replayed cat stream step at 1x4 against 1x1 at FL 2048.
     ``--profile`` adds device time by kernel (torch.profiler) for each
     chain and analysis path, the dynamic chains and the device builder,
     one eager stream step (cat, FL 8192), and for E6 and E7.  Device
     times from the profiler are ``utils/deviceprof``'s rows.

Each path is driven with the launch counts set to 0 just before it and
read just after.  The third line from the end is the card's name and power
limit as ``nvidia-smi`` gives them; the line before the last is the kernel
record
{"kernels": [{"name", "route", "source", "replaces", "launches",
"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"},
...]}: ``launches`` sums the kernel's launches over the main-path runs of
[slice], [frames], [analysis], [explicit], [dynamic] (its eager runs),
[jit] (the first two calls of each compiled forward: their warm-ups and
captures), [stream] (a) and (b), [sharded], [multicard] (its worker processes'
launches too), [surfaces], [bench], [scripts] (a
replayed step launches through the graph and is counted at its capture
and warm-up) and
the entry points' own runs in [k3] (serving shape), [e7] and [e6] (for K7
and K8, calls of the
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

import contextlib
import functools
import gc
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


def oracle_outputs(cfg, xs: np.ndarray) -> list:
    """Per signal: (y, z, [spectrum of x, y, z]) from the numpy oracle."""
    from dsp_audio_project_tpu_torch import oracle

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


def gate(tag: str, want: list, z, y, mags) -> float:
    """z (and y when given) and the three spectra (when given) >= 60 dB vs
    the oracle; returns the worst."""
    from dsp_audio_project_tpu_torch import oracle

    worst = {"z": math.inf, "y": math.inf, "spectra": math.inf}
    z = z.cpu().numpy()
    y = None if y is None else y.cpu().numpy()
    mags = [] if mags is None else [m.cpu().numpy() for m in mags]
    for i, (y_want, z_want, spec) in enumerate(want):
        worst["z"] = min(worst["z"], oracle.snr_db(z_want, z[i]))
        if y is not None:
            worst["y"] = min(worst["y"], oracle.snr_db(y_want, y[i]))
        for s_want, m in zip(spec, mags):
            worst["spectra"] = min(worst["spectra"],
                                   oracle.snr_db(s_want, m[i]))
    if y is None:
        del worst["y"]
    if not mags:
        del worst["spectra"]
    log(f"[{tag}] vs oracle, min snr over {len(want)} signals: "
        + ", ".join(f"{k} {v:.1f} dB" for k, v in worst.items())
        + " (gate 60)")
    if not all(v >= 60.0 for v in worst.values()):
        raise RuntimeError(f"[{tag}] output below the 60 dB oracle gate")
    return min(worst.values())


def run_counted(fn):
    """fn() with the launch counts set to 0 just before and read just after."""
    from dsp_audio_project_tpu_torch.kernels import (
        launch_counts, reset_launch_counts,
    )

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def require(tag: str, counts: dict, names, at_least: int = 1) -> None:
    """Fail unless each kernel of ``names`` launched ``at_least`` times."""
    log(f"[{tag}] launches: {counts}")
    missing = [n for n in names if counts[n] < at_least]
    if missing:
        raise RuntimeError(f"[{tag}] kernels of the path launched fewer "
                           f"than {at_least} times: {missing}")


def phase_slice(pipe, x: torch.Tensor, want: list):
    """The cat chain: (counts, z flat), z the one-shot reference of
    [stream]."""
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
    return counts, zf


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


# ---- dynamic gains (ops/eq_dynamic.py) -------------------------------------

# tests/test_eq_dynamic.py's gain sets: complex and real poles, and gains
# below the 0.1 dB skip threshold.
DYN_GAINS = ((6.0, -3.0, 0.0, 12.0, -15.0, 4.0),
             (-15.0, -14.0, -13.0, -12.5, -3.0, 0.0),
             (0.05, -0.05, 0.0, 0.0, 0.0, 0.0))
DYN_ORACLE_DB, DYN_BUILDERS_DB = 60.0, 90.0
DYN_CAT_DB, DYN_GRAPH_DB = 110.0, 130.0


def dyn_oracle(pipe, want: list, gains) -> list:
    """Per signal, the oracle's z for ``gains``: pipeline_oracle(x, fs, src,
    EQConfig.from_gains(gains), engine="fast"), whose SRC half is [slice]'s
    oracle y (the same x and SRC config)."""
    from dsp_audio_project_tpu_torch import EQConfig, oracle

    names = [name for name, _ in pipe.config.eq.band_centers]
    eq = EQConfig.from_gains(dict(zip(names, gains)))
    fs_out = pipe.config.src.output_rate(FS)
    return [oracle.equalize_oracle(y_want, fs_out, eq)
            for y_want, _, _ in want]


def dyn_gate(what: str, z_want: list, z: torch.Tensor) -> float:
    from dsp_audio_project_tpu_torch import oracle

    zh = z.cpu().numpy()
    worst = min(oracle.snr_db(w, zh[i]) for i, w in enumerate(z_want))
    log(f"[dynamic] {what} vs oracle, min snr over {len(z_want)} signals "
        f"{worst:.1f} dB (gate {DYN_ORACLE_DB:.0f})")
    if not worst >= DYN_ORACLE_DB:
        raise RuntimeError(f"[dynamic] {what} below the oracle gate")
    return worst


def dyn_agree(what: str, a: torch.Tensor, b: torch.Tensor,
              gate_db: float) -> None:
    s = snr_db(a, b)
    log(f"[dynamic] {what}: snr {s:.1f} dB (gate {gate_db:.0f})")
    if not s >= gate_db:
        raise RuntimeError(f"[dynamic] {what} below its gate")


def phase_dynamic(pipe, x: torch.Tensor, want: list):
    """Dynamic gains at the serving shape: for each of DYN_GAINS and each
    builder ('host', 'traced'), ``forward_cat_dynamic_ops`` (K1, K9) and
    ``forward_frames_dynamic_ops`` (the frames kernel, K9), each counted;
    z vs the oracle, builder vs builder, cat vs frames; K1 at V = 172 and
    K9 at d = 12 vs plain; then the gain change inside one captured CUDA
    graph.  (counts, {tag: kernel check}, the graphs and callables for
    [time])."""
    from dsp_audio_project_tpu_torch.kernels import (
        launch_counts, reset_launch_counts,
    )
    from dsp_audio_project_tpu_torch.kernels.eq_finish import (
        eq_finish, eq_finish_plain,
    )
    from dsp_audio_project_tpu_torch.kernels.fir_class import (
        fir_cat_plain, polyphase_fir_class_rect_cat,
    )
    from dsp_audio_project_tpu_torch.ops import eq as teq
    from dsp_audio_project_tpu_torch.ops.eq_dynamic import _dyn_states

    n = x.shape[-1]
    n_out = pipe.config.src.output_length(n)
    plan = pipe._plan()

    def flat(z):
        return z.reshape(BATCH, -1)[:, :n_out]

    def caches():
        return (teq.make_block_operators.cache_info(), len(teq._device_tables))

    before = caches()
    total, z_wants = None, {}
    for gains in DYN_GAINS:
        z_want = z_wants[gains] = dyn_oracle(pipe, want, gains)
        outs = {}
        for builder, g in (("host", np.asarray(gains)),
                           ("traced", torch.tensor(gains, device=DEVICE))):
            ops = pipe.dynamic_eq_operators(g, FS, n, builder=builder)
            tabs = pipe.dynamic_cat_tables(ops)
            zc, c_cat = run_counted(
                lambda: pipe.forward_cat_dynamic_ops(x, ops, tabs, FS))
            require("dynamic", c_cat, ("polyphase_fir_class_rect_cat",
                                       "eq_finish"))
            (zf, _), c_fr = run_counted(
                lambda: pipe.forward_frames_dynamic_ops(x, ops, FS))
            require("dynamic", c_fr, ("fir_frames_kernel", "eq_finish"))
            for c in (c_cat, c_fr):
                total = c if total is None else {k: total[k] + c[k]
                                                 for k in total}
            zc, zf = flat(zc), flat(zf)
            if not (bool(torch.isfinite(zc).all())
                    and bool(torch.isfinite(zf).all())):
                raise RuntimeError("[dynamic] non-finite output")
            tag = f"gains {gains} {builder} builder"
            dyn_gate(f"{tag}: cat z", z_want, zc)
            dyn_gate(f"{tag}: frames z", z_want, zf)
            dyn_agree(f"{tag}: cat vs frames", zf, zc, DYN_CAT_DB)
            outs[builder] = (zc, zf)
        for i, path in enumerate(("cat", "frames")):
            dyn_agree(f"gains {gains}: host vs traced builder, {path}",
                      outs["host"][i], outs["traced"][i], DYN_BUILDERS_DB)
    if caches() != before:
        raise RuntimeError("[dynamic] a gain change grew a static table cache")
    log(f"[dynamic] {2 * len(DYN_GAINS)} gain changes left the static caches "
        f"as they were: make_block_operators {before[0]}, _device_tables "
        f"{before[1]}")

    # K1 at V = P + 12 and K9 at d = 12, on the first gain set's operators.
    ops = pipe.dynamic_eq_operators(torch.tensor(DYN_GAINS[0], device=DEVICE),
                                    FS, n)
    g2 = pipe.dynamic_cat_tables(ops).g2
    f_pad = pipe.dynamic_eq_geometry(FS, n)[2] * 128

    def k1_kern():
        return polyphase_fir_class_rect_cat(x, plan, n_out, None, g2=g2)

    def k1_plain():
        return fir_cat_plain(x, g2, plan.P, plan.s, f_pad, -plan.lo)

    (y0, inj), (y0_ref, inj_ref) = k1_kern(), k1_plain()
    torch.cuda.synchronize()
    k1_err = max(compare("dynamic", f"K1 y0 (V = {g2.shape[1]})", y0, y0_ref),
                 compare("dynamic", f"K1 inj (d = {inj.shape[-1]})", inj,
                         inj_ref))
    del y0_ref, inj_ref
    d = inj.shape[-1]
    st = _dyn_states(inj.reshape(BATCH, -1, 128, d), ops).reshape(
        BATCH, f_pad, d)

    def k9_kern():
        return eq_finish(y0, st, ops.group_out)

    def k9_plain():
        return eq_finish_plain(y0, st, ops.group_out)

    k9_err = compare("dynamic", f"K9 (d = {d})", k9_kern(), k9_plain())
    checks = {
        "k1_dyn": {"max_abs_err": k1_err, "kern": k1_kern, "plain": k1_plain,
                   "lib": conv_yardstick(x, g2, plan.s, f_pad, -plan.lo),
                   "bound": fir_bound(BATCH, f_pad, plan.W, g2.shape[1],
                                      n)[0]},
        "k9_dyn": {"max_abs_err": k9_err, "kern": k9_kern, "plain": k9_plain,
                   "lib": None,
                   "bound": bound(2.0 * y0.numel() * d,
                                  4.0 * (2 * y0.numel() + st.numel()
                                         + ops.group_out.numel()))}}

    # The gain change inside one captured CUDA graph.
    gains = torch.tensor(DYN_GAINS[0], device=DEVICE)

    def change():
        o = pipe.dynamic_eq_operators(gains, FS, n, builder="traced")
        return o, pipe.dynamic_cat_tables(o)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # builds, attributes, geometry caches
        for _ in range(2):
            o, t = change()
            pipe.forward_cat_dynamic_ops(x, o, t, FS)
            pipe.forward_frames_dynamic_ops(x, o, FS)
    torch.cuda.current_stream().wait_stream(side)
    del o, t
    graphs = {name: torch.cuda.CUDAGraph() for name in ("change", "cat",
                                                        "frames")}
    with torch.cuda.graph(graphs["change"]):
        ops_s, tabs_s = change()
    captured = {}
    for name, fn, needed in (
            ("cat", lambda: pipe.forward_cat_dynamic_ops(x, ops_s, tabs_s,
                                                         FS),
             ("polyphase_fir_class_rect_cat", "eq_finish")),
            ("frames", lambda: pipe.forward_frames_dynamic_ops(x, ops_s,
                                                               FS)[0],
             ("fir_frames_kernel", "eq_finish"))):
        reset_launch_counts()
        with torch.cuda.graph(graphs[name]):
            captured[name] = fn()
        require(f"dynamic graph ({name}), at capture", launch_counts(),
                needed)
    before = caches()
    for gains_k in DYN_GAINS[:2]:
        gains.copy_(torch.tensor(gains_k))
        graphs["change"].replay()
        graphs["cat"].replay()
        torch.cuda.synchronize()
        got = flat(captured["cat"]).clone()
        o, t = change()
        eager = flat(pipe.forward_cat_dynamic_ops(x, o, t, FS))
        torch.cuda.synchronize()
        if torch.equal(got, eager):
            how = "bit for bit"
        else:
            s = snr_db(eager, got)
            how = (f"{s:.1f} dB (gate {DYN_GRAPH_DB:.0f}; a captured "
                   "product took another cuBLAS algorithm)")
            if not s >= DYN_GRAPH_DB:
                raise RuntimeError("[dynamic] graph replay disagrees with "
                                   "the eager call")
        log(f"[dynamic] graphs (change, cat) replayed at gains {gains_k}: "
            f"equal to the eager call {how}")
        dyn_gate(f"graph replay at gains {gains_k}", z_wants[gains_k], got)
    after = caches()
    if after != before:
        raise RuntimeError("[dynamic] a host design ran between the replays")
    log("[dynamic] no host design ran between the replays: "
        f"make_block_operators {after[0]}, _device_tables {after[1]} before "
        "and after")
    ops_h = pipe.dynamic_eq_operators(np.asarray(DYN_GAINS[0]), FS, n,
                                      builder="host")
    return total, checks, {"graphs": graphs, "ops": ops_s, "tabs": tabs_s,
                           "gains": gains, "change": change,
                           "ops_host": ops_h}


def time_dynamic(pipe, x: torch.Tensor, dyn: dict) -> dict:
    """[time] lines of the dynamic path: one gain change (the host builder
    split into host tables, upload and expand; the device builder, eager
    and as graph replay; the G2 fold) and the dynamic chains per batch,
    eager and as graph replay, beside the static cat chain.  Returns the
    chains for --profile."""
    from dsp_audio_project_tpu_torch.ops.eq_dynamic import (
        _expand_dyn_operators, host_dyn_tables, upload_dyn_tables,
    )

    n = x.shape[-1]
    cfg = pipe.config
    fs_out = cfg.src.output_rate(FS)
    U, G, K = pipe.dynamic_eq_geometry(FS, n)
    g = np.asarray(DYN_GAINS[0])
    tabs = host_dyn_tables(g, fs_out, cfg.eq, U, G, K)
    up = upload_dyn_tables(tabs, DEVICE)
    graphs, ops_h = dyn["graphs"], dyn["ops_host"]
    rows = {
        "host builder: host tables (numpy float64)": (
            None,
            host_ms(lambda: host_dyn_tables(g, fs_out, cfg.eq, U, G, K))),
        "host builder: upload": (
            None, host_ms(lambda: upload_dyn_tables(tabs, DEVICE))),
        "host builder: expand (device)": (
            time_ms(lambda: _expand_dyn_operators(*up)), None),
        "host builder, whole": (
            time_ms(lambda: pipe.dynamic_eq_operators(g, FS, n,
                                                      builder="host")),
            host_ms(lambda: pipe.dynamic_eq_operators(g, FS, n,
                                                      builder="host"))),
        "device builder, eager": (
            time_ms(lambda: pipe.dynamic_eq_operators(dyn["gains"], FS, n)),
            host_ms(lambda: pipe.dynamic_eq_operators(dyn["gains"], FS, n))),
        "G2 fold (dynamic_cat_tables)": (
            time_ms(lambda: pipe.dynamic_cat_tables(ops_h)),
            host_ms(lambda: pipe.dynamic_cat_tables(ops_h))),
        "device builder + G2 fold, graph replay": (
            time_ms(graphs["change"].replay),
            host_ms(graphs["change"].replay)),
    }
    for name, (ms, host) in rows.items():
        parts = []
        if ms is not None:
            parts.append(f"{ms:.4f} ms (CUDA events, median of {REPS})")
        if host is not None:
            parts.append(f"host {host[0]:.4f} ms per call (min {host[1]:.4f}, "
                         f"max {host[2]:.4f})")
        log(f"[time] dynamic gain change, {name}: " + "; ".join(parts))
    tabs_h = pipe.dynamic_cat_tables(ops_h)
    chains = {
        "forward_cat_dynamic_ops": functools.partial(
            pipe.forward_cat_dynamic_ops, x, ops_h, tabs_h, FS),
        "forward_frames_dynamic_ops": functools.partial(
            pipe.forward_frames_dynamic_ops, x, ops_h, FS),
        "forward_cat (static)": functools.partial(pipe.forward_cat, x, FS),
        "forward_cat_dynamic_ops, graph replay": graphs["cat"].replay,
        "forward_frames_dynamic_ops, graph replay": graphs["frames"].replay,
    }
    for name, fn in chains.items():
        per_call = time_ms(fn)
        b2b = back_to_back_ms(fn)
        host = host_ms(fn)
        log(f"[time] dynamic chain {name}, batch {BATCH} x {SECONDS:.0f} s: "
            f"{per_call:.4f} ms per call (median); back to back {b2b:.4f} ms "
            f"per call; host {host[0]:.4f} ms per call (min {host[1]:.4f}, "
            f"max {host[2]:.4f})")
    return {"device builder + G2 fold (traced)": dyn["change"],
            **{k: v for k, v in chains.items() if "replay" not in k}}


# ---- the compiled forwards (AudioPipeline.jit_forward_*) -------------------

# (method, the eager forward its graph captures, the kernels its capture's
# warm-up must launch)
JIT_METHODS = (
    ("jit_forward", "_forward", ("fir_frames_kernel",)),
    ("jit_forward_frames", "forward_frames",
     ("fir_frames_kernel", "eq_finish")),
    ("jit_forward_frames_spectra", "forward_frames_spectra",
     ("fir_frames_kernel", "eq_finish", "rfft_four_step_magnitude")),
    ("jit_forward_spectra", "forward_spectra",
     ("fir_frames_kernel", "rfft_four_step_magnitude")),
    ("jit_forward_flat", "forward_flat", ("fir_frames_kernel",)),
    ("jit_forward_flat_spectra", "forward_flat_spectra",
     ("fir_frames_kernel", "rfft_four_step_magnitude")),
    ("jit_forward_cat", "forward_cat",
     ("polyphase_fir_class_rect_cat", "eq_finish")),
    ("jit_forward_cat_spectra", "forward_cat_spectra",
     ("polyphase_fir_class_rect_cat", "eq_finish",
      "rfft_four_step_magnitude")),
    ("jit_forward_frames_dynamic", "forward_frames_dynamic",
     ("fir_frames_kernel", "eq_finish")),
    ("jit_forward_frames_dynamic_ops", "forward_frames_dynamic_ops",
     ("fir_frames_kernel", "eq_finish")),
    ("jit_forward_cat_dynamic_ops", "forward_cat_dynamic_ops",
     ("polyphase_fir_class_rect_cat", "eq_finish")),
)
JIT_RATE_B = 48000          # the rate switch's other input rate
JIT_FAIL_TIMEOUT_S = 300    # the capture-failure worker's limit


def out_leaves(out) -> list:
    """The tensors of a forward's result or arguments, in order."""
    from dsp_audio_project_tpu_torch.utils.profiling import tensors

    return list(tensors(out))


def identical(what: str, got, want) -> None:
    """Every tensor of ``got`` equal to ``want``'s bit for bit."""
    got, want = out_leaves(got), out_leaves(want)
    if len(got) != len(want) or not all(
            a.shape == b.shape and torch.equal(a, b)
            for a, b in zip(got, want)):
        raise RuntimeError(f"[jit] {what}: not equal bit for bit")


def jit_args(pipe, method: str, x: torch.Tensor, k: int) -> tuple:
    """A call's arguments: x, then for the dynamic methods DYN_GAINS[k]
    (a (6,) tensor on the card, or operators from the host builder and
    their cat table), then fs."""
    if method == "jit_forward_frames_dynamic":
        return x, torch.tensor(DYN_GAINS[k], device=x.device), FS
    if method.endswith("_dynamic_ops"):
        ops = pipe.dynamic_eq_operators(np.asarray(DYN_GAINS[k]), FS,
                                        x.shape[-1], builder="host")
        if "cat" in method:
            return x, ops, pipe.dynamic_cat_tables(ops), FS
        return x, ops, FS
    return x, FS


def jit_outputs(method: str, out, n_out: int):
    """(z, y or None, spectra or None) of a forward's result, z and y flat
    (BATCH, n_out)."""
    leaves = out_leaves(out)
    mags = leaves[-3:] if "spectra" in method else None
    sig = leaves[:-3] if mags is not None else leaves

    def flat(t):
        return t.reshape(t.shape[0], -1)[:, :n_out] if t.dim() == 3 else t

    return flat(sig[0]), flat(sig[1]) if len(sig) > 1 else None, mags


def dropping(f):
    """``f`` with its result dropped: a list of results kept by a caller
    would hold a compiled forward's graph slots."""
    def call():
        f()
    return call


def entry_mb(fn, args) -> tuple:
    """(fn(*args), MB the card holds after it that it did not before):
    one entry's graph pool, static inputs and kept tables when the call
    makes a new entry, the caching allocator's free blocks released on
    both sides."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    out = fn(*args)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out, (torch.cuda.memory_reserved() - before) / 1e6


def capture_fail_worker() -> None:
    """``--capture-fail-worker``: a compiled forward over a forward that
    synchronizes (which no CUDA graph can capture) must raise on every
    call, return nothing and capture nothing, while its eager forward runs
    once a warm-up pass (twice a call); then a fresh pipeline's compiled
    forward must equal its eager forward bit for bit.  In its own process,
    so that a failed capture cannot touch the run's card state."""
    import dsp_audio_project_tpu_torch as pt

    cfg = pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(src_fast=True, eq_fast=True))
    pipe = pt.AudioPipeline(cfg, device=DEVICE)
    real, runs = pipe.forward_cat, []

    def syncing(x, fs):
        runs.append(1)
        z = real(x, fs)
        torch.cuda.synchronize()
        return z

    pipe.forward_cat = syncing
    fn = pipe.jit_forward_cat()
    x = torch.as_tensor(make_batch(FS)[:2], device=DEVICE)
    for call in range(2):
        try:
            fn(x, FS)
        except RuntimeError as err:
            if "capture" not in str(err):
                raise
            print(f"[jit] a capturing call over a syncing forward raised: "
                  f"{str(err).splitlines()[0][:160]}", flush=True)
        else:
            raise RuntimeError("a failed capture returned a result")
    # Two warm-up passes and the capture's one pass a call, nothing more.
    if fn.captures or len(runs) != 6:
        raise RuntimeError(f"captures {fn.captures}, eager runs {len(runs)}")
    other = pt.AudioPipeline(cfg, device=DEVICE)
    identical("after a failed capture", other.jit_forward_cat()(x, FS),
              other.forward_cat(x, FS))
    print("CAPTURE_FAIL_OK", flush=True)


def phase_jit(cfg, x: torch.Tensor, want: list, smi: str) -> tuple:
    """[jit]: the compiled forwards (``AudioPipeline.jit_forward_*``) at
    the serving shape, on a pipeline of their own.  Each method's first
    call is counted and its capture's warm-up held against the plain
    versions (``LaunchChecker``: K1, the frames kernel, K9, K2); its
    result equals the eager forward bit for bit and its z (and y, and the
    spectra) >= 60 dB against the oracle (the dynamic ones against the
    oracle for their gains); a second call on another batch (and gains)
    takes a second graph slot, equals the eager forward, and leaves the
    first result as it was.  Then, on ``jit_forward_cat_spectra``: a third
    call with both results held copies its outputs; the rate switch 44.1
    -> 48 -> 44.1 kHz; the entries' sizes; a capture failure, in a process
    of its own.  Last, [time] rows for each callable beside its eager
    forward.  Returns (counts, the checker's max abs errs)."""
    import dsp_audio_project_tpu_torch as pt

    checker = LaunchChecker("jit")
    pipe = pt.AudioPipeline(cfg, device=DEVICE)
    n_out = cfg.src.output_length(x.shape[-1])
    x2 = torch.flip(x, dims=[0]).contiguous()   # another batch
    z_dyn = dyn_oracle(pipe, want, DYN_GAINS[0])
    runs, entries = [], {}
    for method, eager_name, needed in JIT_METHODS:
        fn = getattr(pipe, method)()
        if getattr(pipe, method)() is not fn:
            raise RuntimeError(f"[jit] {method}() is not cached")
        eager = getattr(pipe, eager_name)
        a1, a2 = jit_args(pipe, method, x, 0), jit_args(pipe, method, x2, 1)
        t0 = time.perf_counter()
        with checker.on():
            (r1, mb), counts = run_counted(lambda: entry_mb(fn, a1))
        first_s = time.perf_counter() - t0
        require(f"jit {method}", counts, needed)
        runs.append(counts)
        identical(f"{method} vs {eager_name}", r1, eager(*a1))
        z, y, mags = jit_outputs(method, r1, n_out)
        if z.shape != (BATCH, n_out) or not bool(torch.isfinite(z).all()):
            raise RuntimeError(f"[jit] {method}: z {tuple(z.shape)}")
        if "dynamic" in method:
            gate(f"jit {method}", [(w[0], zd, w[2])
                                   for w, zd in zip(want, z_dyn)], z, y, None)
        else:
            gate(f"jit {method}", want, z, y, mags)
        kept = [t.clone() for t in out_leaves(r1)]
        with checker.on():
            r2, counts2 = run_counted(lambda: fn(*a2))
        runs.append(counts2)
        identical(f"{method} on a second batch", r2, eager(*a2))
        identical(f"{method}'s first result after a second call", r1, kept)
        copied = sum(t.numel() * t.element_size()
                     for t in out_leaves(a1[1:-1])) / 1e6
        log(f"[jit] {method}: equal to {eager_name} bit for bit on two "
            f"batches, the first result unchanged by the second call; "
            f"captures {fn.captures}, first call {first_s:.2f} s, "
            f"{mb:.1f} MB an entry"
            + (f", {copied:.2f} MB of operators copied a call" if copied
               else ""))
        entries[method] = (fn, eager, a1, mb)
        del r1, r2, kept, z, y, mags
    checker.report("the captures' warm-ups")

    fn, eager, a1, _ = entries["jit_forward_cat_spectra"]
    a2 = (x2, FS)
    held = [fn(*a1), fn(*a2)]
    r3 = fn(*a1)
    if fn.copies != 1 or fn.captures != 3:
        raise RuntimeError(f"[jit] with both slots held: captures "
                           f"{fn.captures}, copies {fn.copies}")
    want_a = eager(*a1)
    identical("a copied result", r3, want_a)
    identical("the held results", held, [want_a, eager(*a2)])
    outs = out_leaves(r3)
    out_mb = sum(t.numel() * t.element_size() for t in outs) / 1e6
    copy_ms = time_ms(lambda: [t.clone() for t in outs])
    held_ms = time_ms(lambda: fn(*a1))
    del held, r3, outs
    free_ms = time_ms(lambda: fn(*a1))
    log(f"[jit] output ownership (jit_forward_cat_spectra): a slot is "
        f"replayed only when no tensor shares its outputs, at no copy; with "
        f"both slots held a call replays a third graph and clones its "
        f"{out_mb:.1f} MB of outputs: {copy_ms * 1e3:.1f} us a call "
        f"(CUDA events), call {held_ms:.4f} ms held against {free_ms:.4f} "
        f"ms free; copies {fn.copies}")

    rb, mb_b = entry_mb(fn, (x, JIT_RATE_B))
    identical(f"rate {JIT_RATE_B}", rb, eager(x, JIT_RATE_B))
    del rb
    junk = [torch.full_like(t, math.nan) for t in pipe.buffers()
            for _ in range(2)]
    identical(f"rate {FS} after {JIT_RATE_B}", fn(*a1), want_a)
    del junk, want_a
    if fn._cache_size() != 2:
        raise RuntimeError(f"[jit] entries {fn._cache_size()}, not 2")
    log(f"[jit] rate switch {FS} -> {JIT_RATE_B} -> {FS} Hz: each replay "
        f"equal to the eager forward at its rate bit for bit, the {FS} Hz "
        f"entry reading the tables it keeps after the module's were "
        f"replaced (and NaN fills allocated); the {JIT_RATE_B} Hz entry "
        f"{mb_b:.1f} MB")

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--capture-fail-worker"],
                          capture_output=True, text=True,
                          timeout=JIT_FAIL_TIMEOUT_S)
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    if proc.returncode != 0 or "CAPTURE_FAIL_OK" not in proc.stdout:
        raise RuntimeError("[jit] the capture-failure worker failed:\n"
                           + "\n".join(lines[-30:]))
    for line in proc.stdout.splitlines():
        if line.startswith("[jit]"):
            log(line)
    log(f"[jit] a failed capture raised on each call and ran nothing "
        f"eagerly after its warm-up; a fresh pipeline then replayed bit for "
        f"bit ({time.perf_counter() - t0:.1f} s, own process)")

    captures = sum(e[0].captures for e in entries.values())
    log(f"[jit] {len(entries)} compiled forwards, {captures} captures, "
        f"{sum(e[3] for e in entries.values()):.1f} MB for their first "
        f"entries; card memory reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB")
    log(f"[time] card: {smi}")
    for method, (fn, eager, args, mb) in entries.items():
        rows = {}
        for name, f in (("eager", lambda: eager(*args)),
                        ("compiled", lambda: fn(*args))):
            # Each result dropped before the next call, as a server does.
            rows[name] = (time_ms(f), back_to_back_ms(f), host_ms(f)[0],
                          device_ms(dropping(f)))
        (c, b, h, d), (ce, be, he, de) = rows["compiled"], rows["eager"]
        log(f"[time] jit {method}, batch {BATCH} x {SECONDS:.0f} s: call "
            f"{c:.4f} ms (eager {ce:.4f}) -> {c / BATCH:.4f} ms per signal; "
            f"back to back {b:.4f} (eager {be:.4f}); host {h:.4f} (eager "
            f"{he:.4f}); device {d:.4f} (eager {de:.4f}) ms a call; "
            f"{mb:.1f} MB an entry")
    counts = add_runs(runs)
    entries.clear()
    del pipe, fn, eager
    gc.collect()
    torch.cuda.empty_cache()
    return counts, checker.errs


# ---- streaming (streaming.py) ----------------------------------------------

STREAM_CHUNK = FS // 10          # (a): 100 ms chunks
# (a): a ragged chunking with a 1-sample chunk (the rest in 1 s chunks)
STREAM_RAGGED = (1, 4409, 17, 100000, 3, 33333, 7)
STREAM_DB = 110.0                # the JAX package's stream invariance gate
# (b): FL and chunking of each route; the routes' chunks are 1 s, 2.5 s
# and a ragged start, so steps dispatch several at a time and one at a
# time.
STREAM_ROUTES = (
    ("flat", dict(fused=False, frames_per_shard=1024),
     ("fir_frames_kernel", "eq_finish")),
    ("fused frames", dict(frames_per_shard=512),
     ("fir_frames_kernel", "eq_finish")),
    ("cat", dict(frames_per_shard=1024),
     ("polyphase_fir_class_rect_cat", "eq_finish")),
    ("dynamic frames", dict(frames_per_shard=512, gains_db=DYN_GAINS[0]),
     ("fir_frames_kernel", "eq_finish")),
    ("dynamic cat", dict(frames_per_shard=1024, gains_db=DYN_GAINS[0]),
     ("polyphase_fir_class_rect_cat", "eq_finish")),
)
STREAM_FLS = (2048, 8192, 24576)     # (c): cat steps timed
STREAM_LONG_SECONDS = 330.0          # 4 steps at FL = 24576


def stream_chunks(n: int, first=(), size: int = FS) -> list:
    """``first`` then chunks of ``size`` covering n samples."""
    out = list(first)
    pos = sum(out)
    while pos < n:
        out.append(min(size, n - pos))
        pos += out[-1]
    return out


def stream_through(sp, x: np.ndarray, chunks, lat=None,
                   flush: bool = True) -> np.ndarray:
    """Feed x (..., n) through ``sp`` in ``chunks``, then flush (unless
    ``flush`` is False: the stream stays open); with ``lat`` a list,
    append each process() call's host ms to it."""
    outs, pos = [], 0
    for c in chunks:
        t0 = time.perf_counter()
        outs.append(sp.process(x[..., pos : pos + c]))
        if lat is not None:
            lat.append((time.perf_counter() - t0) * 1e3)
        pos += c
    if pos != x.shape[-1]:
        raise RuntimeError("the chunking does not cover the signal")
    if flush:
        outs.append(sp.flush())
    return np.concatenate(outs, axis=-1)


def stream_gate(what: str, want: torch.Tensor, z: np.ndarray,
                tag: str = "stream") -> float:
    """z >= STREAM_DB against the one-shot z, per row; returns the max
    abs error."""
    got = torch.as_tensor(z)
    want = want.cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"[{tag}] {what}: z {tuple(got.shape)} vs "
                           f"{tuple(want.shape)} or non-finite")
    worst = min(snr_db(want[i], got[i]) for i in range(want.shape[0]))
    err = float((got - want).abs().max())
    log(f"[{tag}] {what}: min snr vs the one-shot z over {want.shape[0]} "
        f"row(s) {worst:.1f} dB (gate {STREAM_DB:.0f}), max abs err "
        f"{err:.3e}")
    if not worst >= STREAM_DB:
        raise RuntimeError(f"[{tag}] {what} below the invariance gate")
    return err


def add_counts(total, c):
    return dict(c) if total is None else {k: total[k] + c[k] for k in total}


def phase_stream_one(cfg, x0: np.ndarray, want0: torch.Tensor):
    """[stream] (a): ``StreamProcessor`` on one row in 100 ms chunks and in
    a ragged chunking, each counted (the frames kernel, K9), z vs the
    one-shot ``pipe(x, fs)``.  Returns (counts, per-chunk host ms)."""
    import dsp_audio_project_tpu_torch as pt

    n = x0.shape[-1]
    total, lat = None, []
    for name, chunks, lat_ in (
            ("100 ms chunks", stream_chunks(n, size=STREAM_CHUNK), lat),
            ("ragged chunks", stream_chunks(n, STREAM_RAGGED), None)):
        z, counts = run_counted(lambda: stream_through(
            pt.StreamProcessor(cfg, FS, device=DEVICE), x0, chunks, lat_))
        require("stream", counts, ("fir_frames_kernel", "eq_finish"))
        stream_gate(f"StreamProcessor, {len(chunks)} {name}", want0[None],
                    z[None])
        total = add_counts(total, counts)
    return total, lat


def phase_stream_sharded(cfg, xs: np.ndarray, z_one: torch.Tensor):
    """[stream] (b): ``ShardedStreamProcessor`` on ``single_device_mesh()``
    at C = 8 over the serving batch: each route counted and >= 110 dB
    against [slice]'s one-shot z; resume and the eager step bit for bit
    against the replayed graphs; ``set_gains`` between two steps vs a CPU
    copy of the processor, with no re-capture.  Returns the counts of the
    routes' runs."""
    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch.parallel import single_device_mesh

    mesh = single_device_mesh()
    n = xs.shape[-1]
    chunks = stream_chunks(n, (1, 4409, 66150), size=FS)
    total, outs = None, {}
    for name, kw, needed in STREAM_ROUTES:
        sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, **kw)
        z, counts = run_counted(lambda: stream_through(sp, xs, chunks))
        require(f"stream {name}", counts, needed)
        if sp.captures != 1:
            raise RuntimeError(f"[stream] {name}: {sp.captures} captures")
        log(f"[stream] {name}: FL {sp._fl}, U {sp._U}, K_loc {sp._K_loc}, "
            f"fused {sp._fused}, cat {sp._cat or sp._cat_dyn}; "
            f"{sp._frames_done // sp._fl} steps, one graph capture")
        stream_gate(f"sharded {name}", z_one, z)
        total = add_counts(total, counts)
        outs[name] = z

    # Resume: a checkpoint mid-stream, then a new processor from the blob.
    kw = dict(STREAM_ROUTES[2][1])
    half = len(chunks) // 2
    sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, **kw)
    cut = sum(chunks[:half])
    part1 = stream_through(sp, xs[:, :cut], chunks[:half], flush=False)
    blob = sp.state_bytes()
    sp2 = pt.ShardedStreamProcessor.resume(cfg, mesh, BATCH, blob, **kw)
    rest = stream_through(sp2, xs[:, cut:], chunks[half:])
    if not np.array_equal(np.concatenate([part1, rest], 1), outs["cat"]):
        raise RuntimeError("[stream] the resumed stream differs")
    log(f"[stream] cat: checkpoint after {cut} samples ({len(blob)} bytes), "
        "resumed: equal to the uninterrupted run bit for bit")

    # The eager step, the reference the graph replay is held against.
    for name, kw, _ in (STREAM_ROUTES[1], STREAM_ROUTES[2], STREAM_ROUTES[4]):
        sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, graphs=False,
                                       **kw)
        z = stream_through(sp, xs, chunks)
        if sp.captures != 0 or not np.array_equal(z, outs[name]):
            raise RuntimeError(f"[stream] {name}: the graph replay differs "
                               "from the eager step")
        log(f"[stream] {name}: graph replays equal to the eager step bit "
            "for bit")

    # set_gains between two steps, vs the same stream on a CPU copy.
    kw = dict(STREAM_ROUTES[4][1])
    cut = 3 * 1024 * 147 + 20000      # three steps ready, then the change
    streams = {}
    for dev in (DEVICE, "cpu"):
        sp = pt.ShardedStreamProcessor(
            cfg, FS, mesh if dev == DEVICE else single_device_mesh("cpu"),
            BATCH, **kw)
        part1 = sp.process(xs[:, :cut])
        graphs = None if sp._runner is None else sp._runner.graphs
        caps = sp.captures
        sp.set_gains(DYN_GAINS[1])
        part2 = stream_through(sp, xs[:, cut:], stream_chunks(n - cut))
        if dev == DEVICE and (sp.captures != caps or caps != 1
                              or sp._runner.graphs is not graphs):
            raise RuntimeError("[stream] set_gains re-captured the step")
        streams[dev] = (part1.shape[1], np.concatenate([part1, part2], 1))
    (m_gpu, z_gpu), (m_cpu, z_cpu) = streams[DEVICE], streams["cpu"]
    s = min(snr_db(torch.as_tensor(z_cpu[i]), torch.as_tensor(z_gpu[i]))
            for i in range(BATCH))
    log(f"[stream] dynamic cat, set_gains {DYN_GAINS[0]} -> {DYN_GAINS[1]} "
        f"after {m_gpu} output samples (3 steps): card vs a CPU copy of "
        f"the processor min snr {s:.1f} dB (gate {STREAM_DB:.0f}); one "
        "capture before and after the change")
    if m_gpu != m_cpu or m_gpu != 3 * 1024 * 160 or not s >= STREAM_DB:
        raise RuntimeError("[stream] set_gains: card and CPU disagree")
    return total


def phase_stream_kernels(cfg, xs: np.ndarray) -> dict:
    """K1, the frames kernel and K9 at the stream's own shapes against
    their plain versions: K1 at num_frames = FL = 1024, pad_left = 0 on a
    cat step's span; the frames kernel on a 100 ms chunk's span and on a
    fused step's span; K9 at a step's (C, K_loc, G, U).  Returns the max
    abs error of each."""
    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch.kernels.eq_finish import (
        eq_finish, eq_finish_plain,
    )
    from dsp_audio_project_tpu_torch.kernels.fir_class import (
        fir_cat_plain, fir_frames_kernel, fir_frames_plain,
        polyphase_fir_class_rect_cat,
    )
    from dsp_audio_project_tpu_torch.ops import eq as teq
    from dsp_audio_project_tpu_torch.parallel import carry, single_device_mesh

    mesh = single_device_mesh()
    errs = {}
    sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, frames_per_shard=1024)
    plan, t, fl = sp._plan, sp._tab, sp._fl
    x = torch.as_tensor(np.ascontiguousarray(xs[:, : fl * plan.s + sp._hr]),
                        device=DEVICE)
    y0, inj = polyphase_fir_class_rect_cat(x, plan, fl * plan.P, None,
                                           num_frames=fl, pad_left=0,
                                           g2=t["g2"])
    y0_ref, inj_ref = fir_cat_plain(x, t["g2"], plan.P, plan.s, fl, 0)
    torch.cuda.synchronize()
    errs["k1"] = max(compare("stream", f"K1 y0 at a cat step (FL {fl})", y0,
                             y0_ref),
                     compare("stream", "K1 inj at a cat step", inj, inj_ref))
    # K9 at the step's (C, K_loc, G, U), its s_true from the step's algebra.
    K, U, d = sp._K_loc, sp._U, sp._d
    s_in, e = teq._group_states(inj.reshape(BATCH, K, -1, d),
                                t["group_toeplitz"])
    sigma_local, e_shard = carry.shard_end(e, t)
    sigma = carry.cross_shard(sigma_local, e_shard[None],
                              torch.zeros(BATCH, d, device=DEVICE), 0, t)
    st = teq._entry_states(s_in, sigma, t["group_pows"])
    y0g = y0.reshape(BATCH, K, -1, U)
    errs["k9"] = compare("stream", f"K9 at a step's {tuple(y0g.shape)}",
                         eq_finish(y0g, st, t["group_out"]),
                         eq_finish_plain(y0g, st, t["group_out"]))
    # The frames kernel: a fused step's span, and one 100 ms chunk's span.
    sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, frames_per_shard=512)
    x = torch.as_tensor(np.ascontiguousarray(xs[:, : 512 * plan.s + sp._hr]),
                        device=DEVICE)
    g = sp._tab["g"]
    frames = -(-STREAM_CHUNK // plan.s)
    x1 = torch.as_tensor(xs[0, : frames * plan.s + sp._hr], device=DEVICE)
    errs["k3"] = max(
        compare("stream", "frames kernel at a fused step (FL 512)",
                fir_frames_kernel(x, g, plan.s, 512, 0),
                fir_frames_plain(x, g, plan.s, 512, 0)),
        compare("stream", f"frames kernel on a 100 ms span ({frames} frames)",
                fir_frames_kernel(x1, g, plan.s, frames, 0),
                fir_frames_plain(x1[None], g, plan.s, frames, 0)[0]))
    return errs


def time_stream(cfg, pipe, x: torch.Tensor, lat_a: list) -> dict:
    """[stream] (c): cat steps at C = 8 for each FL on a STREAM_LONG_SECONDS
    signal.  After a first step (the capture), the rest of the signal goes
    in either as one process() call (every step dispatched back to back,
    then fetched: the steady state) or one step's input a call (each call
    dispatches and fetches one step).  For each FL: input samples/s of
    both feeds, device ms per step (CUDA events around a graph replay),
    host ms per step by part (``host_split``), bytes up and down per
    step, the pinned H2D and D2H rates of a plain copy of the
    step's size (alone, and both at once on two streams), the step's bound
    max(device, up / H2D, down / D2H); beside them the one-shot cat
    chain's samples/s and (a)'s host ms per 100 ms chunk.  Returns {name:
    one eager step} for --profile."""
    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch.parallel import single_device_mesh

    mesh = single_device_mesh()
    n = int(STREAM_LONG_SECONDS * FS)
    t0 = time.perf_counter()
    xl = make_batch(n)
    log(f"[time] stream: {BATCH} x {STREAM_LONG_SECONDS:.0f} s signal made "
        f"in {time.perf_counter() - t0:.2f} s")
    lat = sorted(lat_a)
    log(f"[time] stream (a) StreamProcessor, 100 ms chunks: host ms per "
        f"process() median {statistics.median(lat):.4f}, p90 "
        f"{lat[int(0.9 * len(lat))]:.4f}, max {lat[-1]:.4f} over "
        f"{len(lat)} chunks")
    one_ms = time_ms(lambda: pipe.forward_cat(x, FS))
    one_rate = x.numel() / (one_ms * 1e-3)
    xs_host = x.cpu().numpy()
    host_shot = host_ms(lambda: pipe.forward_cat(
        torch.as_tensor(xs_host, device=DEVICE), FS).cpu(), reps=5)
    log(f"[time] stream one-shot forward_cat, batch {BATCH} x "
        f"{SECONDS:.0f} s: {one_ms:.4f} ms device-resident (median of "
        f"{REPS}) -> {one_rate:.4e} input samples/s; host array to host "
        f"array {host_shot[0]:.4f} ms (median of 5) -> "
        f"{x.numel() / (host_shot[0] * 1e-3):.4e} samples/s")
    profiles = {}
    for fl in STREAM_FLS:
        rates, parts = {}, {}
        # The first "one call" feed warms the pinned host allocator's cache
        # (its pool of z buffers grows to the number of steps); not printed.
        for feed in ("warm-up", "one call", "a step a call"):
            sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH,
                                           frames_per_shard=fl)
            step_in = fl * sp._s
            first = step_in + sp._W + sp._lo + 2 * FS
            sp.process(xl[:, :first])             # the first step: capture
            runner = sp._runner
            split = host_split(sp)
            chunks = ([n - first] if feed != "a step a call"
                      else stream_chunks(n - first, size=step_in))
            done0 = sp._frames_done
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pos = first
            for c in chunks:
                sp.process(xl[:, pos : pos + c])
                pos += c
            wall = (time.perf_counter() - t1) * 1e3
            steps = (sp._frames_done - done0) // fl
            rates[feed] = (steps * step_in * BATCH / wall * 1e3,
                           wall / steps, steps)
            parts[feed] = {k: sum(v) / steps for k, v in split.items()}
            parts[feed]["rest of process()"] = (
                wall / steps - sum(parts[feed].values()))
            if feed != "a step a call":
                del sp, runner
                gc.collect()       # host_split's wrappers close a cycle
        del rates["warm-up"], parts["warm-up"]
        up = 4 * BATCH * (step_in + sp._hr)
        down = 4 * BATCH * fl * sp._P
        dev_ms = time_ms(runner.graphs[0].replay, reps=10, warmup=3)
        h2d, d2h, both_ms = copy_rates(up, down)
        bound_ms = max(dev_ms, up / h2d * 1e3, down / d2h * 1e3)
        for feed, r in rates.items():
            log(f"[time] stream cat FL {fl} (K_loc {sp._K_loc}, {BATCH} "
                f"channels), {feed}: {r[2]} steps, {r[1]:.4f} ms per step "
                f"-> {r[0]:.4e} input samples/s ({r[0] / BATCH / FS:.1f}x "
                f"real time a channel, {r[1] / bound_ms:.2f}x the bound); "
                "host ms per step: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in parts[feed].items()))
        log(f"[time] stream cat FL {fl}: device {dev_ms:.4f} ms per step "
            f"(CUDA events around a graph replay, median of 10); up "
            f"{up / 1e6:.3f} MB, down {down / 1e6:.3f} MB per step; pinned "
            f"H2D {h2d / 1e9:.2f} GB/s, D2H {d2h / 1e9:.2f} GB/s, both at "
            f"once {both_ms:.4f} ms (plain copies of the step's size, median "
            f"of 10); bound {bound_ms:.4f} ms = max(device, up/H2D "
            f"{up / h2d * 1e3:.4f}, down/D2H {down / d2h * 1e3:.4f}); "
            f"one-shot cat chain {one_rate:.4e} samples/s device-resident")
        if fl == 8192:
            profiles[f"stream cat step, FL {fl}, eager"] = functools.partial(
                sp._step, runner.x_dev[0], runner.sigma.clone())
        del sp, runner
    return profiles


# ---- sharding (parallel/) ---------------------------------------------------

# Virtual meshes: every shard on the one card (the list repeats cuda:0).
# They run the real halo exchange, gather and carry algebra; they measure
# the sharded code's cost on one card, not scaling.
SHARD_MESHES = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 4), (8, 1))
SHARD_ROUTES = (
    ("plain", dict(fused=False), ("fir_frames_kernel", "eq_finish")),
    ("fused", dict(fused=True), ("fir_frames_kernel", "eq_finish")),
    ("cat", dict(cat=True), ("polyphase_fir_class_rect_cat", "eq_finish")),
)
SHARD_STREAM_MESHES = ((1, 4), (2, 4))
STEP_CALLS_AT_CAPTURE = 4
# cat (FL 1024), fused frames (FL 512), dynamic cat (FL 1024)
SHARD_STREAM_ROUTES = (STREAM_ROUTES[2], STREAM_ROUTES[1], STREAM_ROUTES[4])


def virtual_mesh(mc: int, mb: int):
    import dsp_audio_project_tpu_torch as pt

    return pt.build_mesh(pt.MeshConfig(channel_devices=mc, block_devices=mb),
                         devices=[DEVICE] * (mc * mb))


def phase_sharded(cfg, x: torch.Tensor, xs: np.ndarray, want: list,
                  z_one: torch.Tensor):
    """[sharded]: ``run_sharded`` on each route (plain, fused, cat) and
    virtual mesh, each run counted, z (and y) >= 60 dB against the oracle
    and >= 110 dB against the route at 1x1, the cat route at 1x1 >= 110 dB
    against [slice]'s ``forward_cat`` z; K1 and the frames kernel at a
    shard's shapes against their plain versions; ``ShardedStreamProcessor``
    at C = 8 on 1x4 and 2x4 (cat, fused frames, dynamic cat): counted, one
    capture, >= 110 dB against the one-shot z, the eager step and a
    resumed checkpoint bit for bit.  Returns (counts, {tag: max abs
    err})."""
    import dsp_audio_project_tpu_torch as pt

    n_out = cfg.src.output_length(x.shape[-1])
    total = None
    for route, kw, needed in SHARD_ROUTES:
        base = None
        for mc, mb in SHARD_MESHES:
            mesh = virtual_mesh(mc, mb)
            (z, y, fs_out, sp), counts = run_counted(
                lambda: pt.run_sharded(x, FS, cfg, mesh, **kw))
            tag = f"sharded {route} {mc}x{mb}"
            # Each shard launches each kernel of its route once.
            require(tag, counts, needed, at_least=mc * mb)
            total = add_counts(total, counts)
            if (z.shape != (BATCH, n_out) or fs_out != 48000
                    or not bool(torch.isfinite(z).all())):
                raise RuntimeError(f"[{tag}] z {tuple(z.shape)}, fs_out "
                                   f"{fs_out} or non-finite")
            gate(tag, want, z, y, None)
            if base is None:
                base = z
            inv = min(snr_db(base[i], z[i]) for i in range(BATCH))
            log(f"[sharded] {route} {mc}x{mb}: {sp.frames_local} frames a "
                f"shard ({sp.frames_local * mb} in all), halo "
                f"({sp.halo_left}, {sp.halo_right}); z vs {route} 1x1 min "
                f"{inv:.1f} dB (gate 110)")
            if not inv >= 110.0:
                raise RuntimeError(f"[{tag}] below the invariance gate")
            if route == "cat" and (mc, mb) == (1, 1):
                s = min(snr_db(z_one[i], z[i]) for i in range(BATCH))
                log(f"[sharded] cat 1x1 vs forward_cat's z: min {s:.1f} dB "
                    "(gate 110)")
                if not s >= 110.0:
                    raise RuntimeError("[sharded] cat 1x1 differs from "
                                       "forward_cat")
        del base, z, y
    errs = sharded_kernels(cfg, x)

    n = xs.shape[-1]
    chunks = stream_chunks(n, (1, 4409, 66150), size=FS)
    half = len(chunks) // 2
    cut = sum(chunks[:half])
    for mc, mb in SHARD_STREAM_MESHES:
        mesh = virtual_mesh(mc, mb)
        for name, kw, needed in SHARD_STREAM_ROUTES:
            sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, **kw)
            z, counts = run_counted(lambda: stream_through(sp, xs, chunks))
            tag = f"sharded stream {name} {mc}x{mb}"
            # The step runs each shard's kernels once a call, and its
            # first call makes four: two warm-ups and the two slots'
            # captures (replays launch through the graph, uncounted).
            require(tag, counts, needed, at_least=STEP_CALLS_AT_CAPTURE
                    * mc * mb)
            total = add_counts(total, counts)
            if sp.captures != 1:
                raise RuntimeError(f"[{tag}] {sp.captures} captures")
            stream_gate(f"stream {name} {mc}x{mb} (FL {sp._fl}, "
                        f"{sp._frames_done // sp._F_sup} steps of "
                        f"{sp._F_sup} frames, one capture)", z_one, z,
                        tag="sharded")
            eager = stream_through(pt.ShardedStreamProcessor(
                cfg, FS, mesh, BATCH, graphs=False, **kw), xs, chunks)
            sp1 = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, **kw)
            part1 = stream_through(sp1, xs[:, :cut], chunks[:half],
                                   flush=False)
            sp2 = pt.ShardedStreamProcessor.resume(
                cfg, mesh, BATCH, sp1.state_bytes(), **kw)
            resumed = np.concatenate(
                [part1, stream_through(sp2, xs[:, cut:], chunks[half:])], 1)
            if not (np.array_equal(eager, z) and np.array_equal(resumed, z)):
                raise RuntimeError(f"[{tag}] the eager step or the resumed "
                                   "stream differs from the replays")
            log(f"[sharded] stream {name} {mc}x{mb}: the eager step and a "
                f"checkpoint after {cut} samples resumed equal to the "
                "replays bit for bit")
    return total, errs


def sharded_kernels(cfg, x: torch.Tensor) -> dict:
    """K1 and the frames kernel at a shard's shapes against their plain
    versions: the cat and fused routes' halo-extended input of an interior
    shard at 1x8 (num_frames = frames_local, pad_left 0) and the 1x1 shard
    (pad_left = -lo), built by the pipeline's own split and exchange."""
    import torch.nn.functional as F

    from dsp_audio_project_tpu_torch.kernels.fir_class import (
        cat_operator, fir_cat_plain, fir_frames_kernel, fir_frames_plain,
        plan_operator, polyphase_fir_class_rect_cat,
    )
    from dsp_audio_project_tpu_torch.ops.eq import (
        eq_cat_weights, make_block_operators,
    )
    from dsp_audio_project_tpu_torch.ops.src import make_plan
    from dsp_audio_project_tpu_torch.parallel import collectives, \
        shard_signal
    from dsp_audio_project_tpu_torch.parallel import pipeline as tpipe

    errs = {"k1": 0.0, "k3": 0.0}
    for mc, mb in ((1, 8), (1, 1)):
        mesh = virtual_mesh(mc, mb)
        _, sp = tpipe.build_sharded_pipeline(mesh, cfg, FS, x.shape[-1],
                                             BATCH, cat=True)
        plan = make_plan(cfg.src.L, cfg.src.M, cfg.src.taps_rule_factor)
        ops = make_block_operators(cfg.eq.active_bands(48000), 48000,
                                   cfg.eq.q, sp.iir_block, plan.P)
        g2 = torch.as_tensor(cat_operator(plan.G, eq_cat_weights(ops)),
                             device=DEVICE)
        xp = F.pad(x, (0, sp.n_in_local * mb - x.shape[-1]))
        axis = collectives.block_axis(mesh, 0)
        shards = shard_signal(mesh, xp)
        parts = tpipe._halo_extend([shards[(0, b)] for b in axis.blocks],
                                   sp, axis)
        x_ext = parts[min(1, mb - 1)].contiguous()
        pad_left = -(plan.lo + sp.halo_left)
        fl = sp.frames_local
        y0, inj = polyphase_fir_class_rect_cat(
            x_ext, plan, sp.n_out_local, None, num_frames=fl,
            pad_left=pad_left, g2=g2)
        y0_ref, inj_ref = fir_cat_plain(x_ext, g2, plan.P, plan.s, fl,
                                        pad_left)
        g = plan_operator(plan, DEVICE)
        yf = fir_frames_kernel(x_ext, g, plan.s, fl, pad_left)
        yf_ref = fir_frames_plain(x_ext, g, plan.s, fl, pad_left)
        torch.cuda.synchronize()
        what = (f"a {mc}x{mb} shard {tuple(x_ext.shape)}, {fl} frames, "
                f"pad_left {pad_left}")
        errs["k1"] = max(errs["k1"],
                         compare("sharded", f"K1 y0 at {what}", y0, y0_ref),
                         compare("sharded", "K1 inj", inj, inj_ref))
        errs["k3"] = max(errs["k3"], compare(
            "sharded", f"frames kernel at {what}", yf, yf_ref))
    return errs


# ---- several cards: NCCL between processes, meshes over the cards ---------

MULTICARD_SECONDS = 60.0      # pod_scaling's --seconds in [multicard]
MULTICARD_TIMEOUT_S = 420     # a worker that has not ended by then fails


def card_rows(cards: int) -> list:
    """The channel rows of the meshes over ``cards`` shards: 1 (1xN), N
    (Nx1) and, with four or more (an even count), 2 (2x(N/2))."""
    rows = [1] if cards == 1 else [1, cards]
    if cards >= 4 and cards % 2 == 0:
        rows.append(2)
    return rows


def multicard_worker(rank: int, world: int, tmp: str) -> None:
    """One rank of [multicard]: ``pod_scaling`` at MULTICARD_SECONDS on
    NCCL (a file rendezvous in ``tmp``), then ``run_sharded`` on each route
    over ``multihost_mesh`` at each row count of ``card_rows(world)``;
    every K1, frames-kernel and K9 launch of both held against its plain
    version.
    Rank 0 writes each z to ``tmp``; every rank writes its counts and
    checks to ``tmp/rank<r>.json``."""
    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch.kernels import (
        launch_counts, reset_launch_counts,
    )
    from dsp_audio_project_tpu_torch.parallel import distributed
    from dsp_audio_project_tpu_torch.scripts import pod_scaling

    checker = LaunchChecker(f"multicard rank {rank}")
    reset_launch_counts()
    with checker.on():
        res = pod_scaling.run(pod_scaling.parse_args([
            "--coordinator", f"file://{tmp}/rdzv", "--num-processes",
            str(world), "--process-id", str(rank), "--seconds",
            str(MULTICARD_SECONDS), "--channel-hosts", "1"]))
        torch.cuda.synchronize()
    pod_counts = launch_counts()
    pod_scaling.report(res)
    if not res["ok"]:
        raise RuntimeError(f"[multicard] rank {rank}: pod_scaling's gates "
                           "failed")
    cfg = pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(src_fast=True, eq_fast=True),
    )
    xs = make_batch(int(SECONDS * FS))
    runs = []
    for mc in card_rows(world):
        mesh = distributed.multihost_mesh(mc)
        for route, kw, needed in SHARD_ROUTES:
            with checker.on():
                (z, _, _, _), counts = run_counted(
                    lambda: pt.run_sharded(xs, FS, cfg, mesh, **kw))
            # This rank's one shard launches each kernel of its route once.
            require(f"multicard rank {rank} {route} {mc}x{world // mc}",
                    counts, needed)
            runs.append(counts)
            if rank == 0:
                np.save(f"{tmp}/z_{route}_{mc}x{world // mc}.npy",
                        z.cpu().numpy())
    with open(f"{tmp}/rank{rank}.json", "w") as fh:
        json.dump({"pod": {k: v for k, v in res.items() if k != "z"},
                   "counts": add_runs([pod_counts] + runs),
                   "errs": checker.errs, "held": checker.held,
                   "by_card": checker.by_card}, fh)
    torch.distributed.destroy_process_group()


def run_workers(cards: int, tmp: str) -> list:
    """Start one ``multicard_worker`` a card, all together; wait for every
    one (killing all on a timeout); returns their outputs, raising unless
    each exited 0."""
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--multicard-worker", str(r), str(cards),
         tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(cards)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTICARD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"[multicard] rank {r} exited "
                               f"{p.returncode}:\n{out[-4000:]}")
    return outs


def multicard_gate(tag: str, want: list, z_one: torch.Tensor,
                   z: torch.Tensor) -> None:
    """z >= 60 dB against the oracle and >= 110 dB against the one-shot z
    of [slice], on every row."""
    n_out = z_one.shape[-1]
    if tuple(z.shape) != (BATCH, n_out) or not bool(torch.isfinite(z).all()):
        raise RuntimeError(f"[{tag}] z {tuple(z.shape)} or non-finite")
    gate(tag, want, z, None, None)
    inv = min(snr_db(z_one[i], z[i].to(z_one.device)) for i in range(BATCH))
    log(f"[{tag}] z vs forward_cat's z: min {inv:.1f} dB (gate 110)")
    if not inv >= 110.0:
        raise RuntimeError(f"[{tag}] below the invariance gate")


def phase_multicard(cfg, x: torch.Tensor, xs: np.ndarray, want: list,
                    z_one: torch.Tensor):
    """[multicard]: one process a card on NCCL (``multicard_worker``),
    then, with two cards or more, ``run_sharded`` and the stream on meshes
    over the cards held in this process.  Every launch of K1, the frames
    kernel and K9 in both is held against its plain version.  Returns
    (counts, {tag: max abs err})."""
    import tempfile

    import dsp_audio_project_tpu_torch as pt

    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = run_workers(cards, tmp)
        log("[multicard] rank 0's pod_scaling, every launch held against "
            "its plain version (its times carry the checks: the script's "
            "own runs give the numbers):")
        for line in outs[0].splitlines():
            log(f"[multicard] {line}")
        ranks = []
        for r in range(cards):
            with open(f"{tmp}/rank{r}.json") as fh:
                ranks.append(json.load(fh))
        for mc in card_rows(cards):
            for route, _, _ in SHARD_ROUTES:
                tag = f"multicard nccl {route} {mc}x{cards // mc}"
                z = torch.as_tensor(np.load(
                    f"{tmp}/z_{route}_{mc}x{cards // mc}.npy"))
                multicard_gate(tag, want, z_one, z)
    total = add_runs([r["counts"] for r in ranks])
    errs = {k: max(r["errs"][k] for r in ranks) for k in ("k1", "k3", "k9")}
    held = {k: sum(r["held"][k] for r in ranks) for k in ("k1", "k3", "k9")}
    by_card: dict = {}
    for r in ranks:
        for card, n in r["by_card"].items():
            by_card[card] = by_card.get(card, 0) + n
    if any(by_card.get(str(card), 0) == 0 for card in range(cards)):
        raise RuntimeError(f"[multicard] a card held no launch: {by_card}")
    log(f"[multicard] NCCL, {cards} process(es) (one a card): pod_scaling "
        f"at {BATCH} x {MULTICARD_SECONDS:.0f} s and run_sharded on "
        f"{len(SHARD_ROUTES)} routes x {len(card_rows(cards))} mesh(es) in "
        f"{time.perf_counter() - t0:.1f} s; launches {total}; held against "
        f"plain: {held} (by card {by_card}), max abs err {errs}")

    if cards < 2:
        log("[multicard] the meshes across cards in one process (1xN, Nx1, "
            "2x(N/2): run_sharded on each route and the stream) need two "
            f"cards; this host has {cards}: not run")
        return total, errs
    checker = LaunchChecker("multicard")
    n = xs.shape[-1]
    chunks = stream_chunks(n, (1, 4409, 66150), size=FS)
    half = len(chunks) // 2
    cut = sum(chunks[:half])
    runs = []
    for mc in card_rows(cards):
        mb = cards // mc
        mesh = pt.build_mesh(pt.MeshConfig(channel_devices=mc,
                                           block_devices=mb))
        for route, kw, needed in SHARD_ROUTES:
            tag = f"multicard {route} {mc}x{mb} over {cards} cards"
            with checker.on():
                (z, _, _, _), counts = run_counted(
                    lambda: pt.run_sharded(x, FS, cfg, mesh, **kw))
            require(tag, counts, needed, at_least=mc * mb)
            runs.append(counts)
            multicard_gate(tag, want, z_one, z)
        for name, kw, needed in SHARD_STREAM_ROUTES:
            tag = f"multicard stream {name} {mc}x{mb}"
            with checker.on():
                sp = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, **kw)
                z, counts = run_counted(
                    lambda: stream_through(sp, xs, chunks))
                require(tag, counts, needed, at_least=mc * mb)
                runs.append(counts)
                if sp.captures != 0:
                    raise RuntimeError(f"[{tag}] a mesh over several cards "
                                       "steps eagerly; it captured")
                stream_gate(f"{name} {mc}x{mb} over {cards} cards (FL "
                            f"{sp._fl}, {sp._frames_done // sp._F_sup} "
                            "eager steps)", z_one, z, tag="multicard")
                sp1 = pt.ShardedStreamProcessor(cfg, FS, mesh, BATCH, **kw)
                part1, counts = run_counted(lambda: stream_through(
                    sp1, xs[:, :cut], chunks[:half], flush=False))
                runs.append(counts)
                sp2 = pt.ShardedStreamProcessor.resume(
                    cfg, mesh, BATCH, sp1.state_bytes(), **kw)
                rest, counts = run_counted(lambda: stream_through(
                    sp2, xs[:, cut:], chunks[half:]))
                runs.append(counts)
            if not np.array_equal(np.concatenate([part1, rest], 1), z):
                raise RuntimeError(f"[{tag}] the resumed stream differs")
            log(f"[multicard] stream {name} {mc}x{mb}: a checkpoint after "
                f"{cut} samples resumed equal bit for bit")
    checker.report(f"meshes over {cards} cards")
    off_zero = sum(n for card, n in checker.by_card.items() if card != 0)
    log(f"[multicard] launches held on cards other than cuda:0: {off_zero} "
        f"(by card {dict(checker.by_card)})")
    if not off_zero:
        raise RuntimeError("[multicard] no launch on another card was held")
    for k in errs:
        errs[k] = max(errs[k], checker.errs[k])
    return add_runs([total] + runs), errs


def device_ms(fn, calls: int = 3) -> float:
    """Device kernel time per call of fn (torch.profiler over ``calls``
    calls after one warm-up call, ``utils/deviceprof``)."""
    from dsp_audio_project_tpu_torch.utils.deviceprof import (
        profile_device_span,
    )

    fn()
    torch.cuda.synchronize()
    prof = profile_device_span(lambda: [fn() for _ in range(calls)])
    return prof.total_ms / calls


def time_sharded(cfg, pipe, x: torch.Tensor, xs: np.ndarray) -> dict:
    """[time] sharded: ``run_sharded`` cat per call at 1x1 and at 1x8
    virtual beside ``forward_cat`` (CUDA events, host ms, profiler device
    ms), and one replayed cat stream step at 1x4 against 1x1 at the same
    FL.  Returns {name: run_sharded call} for --profile."""
    import dsp_audio_project_tpu_torch as pt

    log("[time] sharded: virtual meshes on one card measure the sharded "
        "code's cost there, not scaling over cards")
    paths = {"forward_cat": functools.partial(pipe.forward_cat, x, FS)}
    for mc, mb in ((1, 1), (1, 8)):
        mesh = virtual_mesh(mc, mb)
        sp = pt.run_sharded(x, FS, cfg, mesh, cat=True)[3]
        log(f"[time] sharded cat {mc}x{mb} plan: {sp.frames_local} frames a "
            f"shard, {sp.frames_local * mb} frames in all")
        paths[f"run_sharded cat {mc}x{mb}"] = functools.partial(
            pt.run_sharded, x, FS, cfg, mesh, cat=True)
    for name, fn in paths.items():
        ms = time_ms(fn)
        host = host_ms(fn)
        dev = device_ms(fn)
        log(f"[time] sharded {name}, batch {BATCH} x {SECONDS:.0f} s: "
            f"{ms:.4f} ms per call (median of {REPS}), host {host[0]:.4f} "
            f"ms (min {host[1]:.4f}, max {host[2]:.4f}), device "
            f"{dev:.4f} ms (profiler, 3 calls)")
    fl = 2048
    for mc, mb in ((1, 1), (1, 4)):
        sp = pt.ShardedStreamProcessor(cfg, FS, virtual_mesh(mc, mb), BATCH,
                                       frames_per_shard=fl)
        sp.process(xs[:, : sp._F_sup * sp._s + sp._W])      # the capture
        replay = sp._runner.graphs[0].replay
        dev = time_ms(replay, reps=10, warmup=3)
        host = host_ms(replay, reps=10)
        log(f"[time] sharded stream cat {mc}x{mb}, FL {fl} ({sp._F_sup} "
            f"frames a step, {BATCH} channels): one replayed step "
            f"{dev:.4f} ms (CUDA events, median of 10) -> "
            f"{dev / sp._F_sup * 1e3:.4f} us a frame; host {host[0]:.4f} "
            "ms per replay")
        del sp
    return {k: v for k, v in paths.items() if k.startswith("run_sharded")}


def host_split(sp) -> dict:
    """Wrap a stream processor's step dispatch and fetch with host clocks:
    {part: [ms, ...]} for the wait for a free input slot, the span's copy
    into the pinned buffer (with the step's bookkeeping), the enqueue
    (upload, replay, download), the wait for a step's download and its
    copy out of the pinned buffer."""
    runner = sp._runner
    out = {k: [] for k in ("slot wait", "span fill", "enqueue",
                           "fetch wait", "fetch copy")}
    run_step, host_buffer, run, fetch = (sp._run_step, runner.host_buffer,
                                         runner.run, runner.fetch)

    def clocked(name, fn):
        def wrapped(*args):
            t0 = time.perf_counter()
            res = fn(*args)
            out[name].append((time.perf_counter() - t0) * 1e3)
            return res
        return wrapped

    def dispatch():
        n0 = len(out["slot wait"]), len(out["enqueue"])
        t0 = time.perf_counter()
        res = run_step()
        out["span fill"].append((time.perf_counter() - t0) * 1e3
                                - sum(out["slot wait"][n0[0]:])
                                - sum(out["enqueue"][n0[1]:]))
        return res

    def fetch_split(pending, dest):
        t0 = time.perf_counter()
        pending[1].synchronize()
        out["fetch wait"].append((time.perf_counter() - t0) * 1e3)
        clocked("fetch copy", fetch)(pending, dest)

    runner.host_buffer = clocked("slot wait", host_buffer)
    runner.run = clocked("enqueue", run)
    runner.fetch = fetch_split
    sp._run_step = dispatch
    return out


def copy_rates(up: int, down: int) -> tuple[float, float, float]:
    """Pinned host <-> device: (H2D bytes/s of ``up`` bytes, D2H bytes/s of
    ``down`` bytes, ms of both at once on two streams), plain copies timed
    with CUDA events, median of 10."""
    h_up = torch.empty(up // 4, pin_memory=True)
    d_up = torch.empty(up // 4, device=DEVICE)
    h_dn = torch.empty(down // 4, pin_memory=True)
    d_dn = torch.empty(down // 4, device=DEVICE)
    t_up = time_ms(lambda: d_up.copy_(h_up, non_blocking=True), 10, 3)
    t_dn = time_ms(lambda: h_dn.copy_(d_dn, non_blocking=True), 10, 3)
    side = torch.cuda.Stream()

    def both():
        side.wait_stream(torch.cuda.current_stream())
        d_up.copy_(h_up, non_blocking=True)
        with torch.cuda.stream(side):
            h_dn.copy_(d_dn, non_blocking=True)
        torch.cuda.current_stream().wait_stream(side)

    return up / (t_up * 1e-3), down / (t_dn * 1e-3), time_ms(both, 10, 3)


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


def phase_profile(chains: dict, calls: int = 5,
                  shape: str = f"batch {BATCH} x {SECONDS:.0f} s") -> None:
    """torch.profiler over ``calls`` calls of each chain (after one warm-up
    step): device time per call by kernel (the rows
    ``utils/deviceprof.device_rows`` counts), and the total."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from dsp_audio_project_tpu_torch.utils.deviceprof import device_rows

    for name, fn in chains.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=calls),
                     acc_events=True) as prof:
            for _ in range(calls + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        rows = [(us / calls, count / calls, key)
                for key, us, count in device_rows(prof.key_averages())]
        total = sum(r[0] for r in rows)
        log(f"[profile] {name}, {shape}: device kernel time {total:.1f} us "
            f"per call over {calls} calls")
        for us, per_call, key in rows[:12]:
            log(f"[profile]   {us:9.1f} us {100 * us / total:5.1f} % "
                f"x{per_call:g}  {key[:90]}")


# ---- the surfaces (io/, native/, cli.py, app/, models/graph.py) -------------

SURFACE_CHUNK = "0.1"       # --stream-chunk seconds
SURFACE_REPS = 5            # [time] surfaces: median of this many main() runs
# The telephone chain of the Chain docstring (models/graph.py): 44.1 kHz ->
# 6 kHz -> 44.1 kHz with an EQ between and a clip.
TELEPHONE = ((20, 147, 4), {"Low Mids": 6}, (147, 20, 4))


class Split:
    """Host ms a main() run spends in each part: ``wrap`` replaces a
    function or method by a timed one (synchronizing the card at its end,
    so a part holds its own device work); a part called inside another is
    counted in the outer one.  ``restore`` puts every original back."""

    def __init__(self):
        self.ms: dict = {}
        self._active = None
        self._undo = []

    def wrap(self, owner, attr: str, part: str) -> None:
        real = getattr(owner, attr)

        def timed(*args, **kwargs):
            if self._active is not None:
                return real(*args, **kwargs)
            self._active = part
            t0 = time.perf_counter()
            try:
                out = real(*args, **kwargs)
                torch.cuda.synchronize()
                return out
            finally:
                self.ms[part] = (self.ms.get(part, 0.0)
                                 + (time.perf_counter() - t0) * 1e3)
                self._active = None

        self._undo.append((owner, attr, real))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()


def timed_main(argv: list, stream: bool) -> dict:
    """One ``cli.main(argv)`` run split into load, chain, export, spectra
    JSON and report (the stream route: its process() and flush() calls as
    the chain, and no report); "other" is the rest of main().  The CLI's
    own lines are not printed."""
    import contextlib
    import io

    from dsp_audio_project_tpu_torch import cli, streaming
    from dsp_audio_project_tpu_torch.app import report

    split = Split()
    split.wrap(cli, "load_signal", "load")
    if stream:
        for attr in ("process", "flush"):
            split.wrap(streaming.ShardedStreamProcessor, attr, "chain")
    else:
        split.wrap(cli.AudioPipeline, "forward", "chain")
    split.wrap(cli, "export_wav", "export")
    split.wrap(cli, "_spectra_json", "spectra JSON")
    split.wrap(report, "write_report", "report")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        split.restore()
    if rc != 0:
        raise RuntimeError(f"[time] surfaces: cli.main exited {rc}")
    parts = dict(split.ms)
    parts["other"] = total - sum(parts.values())
    parts["main()"] = total
    return parts


def wav_pcm(path: str) -> np.ndarray:
    """A PCM16 WAV's samples as int16 (N, C), with the file's rate."""
    from dsp_audio_project_tpu_torch.io.wavio import read_wav

    y, fs = read_wav(path)
    return np.round(np.atleast_2d(y.T).T * 32768).astype(np.int16), fs


def lsb_apart(tag: str, what: str, got: np.ndarray, want: np.ndarray,
              bulk: float = 1.0) -> None:
    """int16 samples at most 1 LSB apart in a ``bulk`` share of them."""
    if got.shape != want.shape:
        raise RuntimeError(f"[{tag}] {what}: {got.shape} vs {want.shape}")
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((diff <= 1).mean())
    log(f"[{tag}] {what}: max {int(diff.max())} LSB apart, {share:.6f} of "
        f"{diff.size} samples within 1 LSB (gate {bulk:g})")
    if not share >= bulk:
        raise RuntimeError(f"[{tag}] {what}: more than 1 LSB apart")


def phase_surfaces(xs: np.ndarray, smi: str) -> dict:
    """[surfaces]: the port's io/, native codec, CLI and graph at the
    serving size, and [time] surfaces.

    1. The native codec builds from native/ into _build/ (the run fails if
       it does not load); an 8-channel 60 s 44.1 kHz PCM16 WAV of the
       serving batch decodes bit for bit equal through the native engine
       and ``engine="numpy"``, and ``encode_pcm16`` equals ``export_wav``'s
       PCM bit for bit.
    2. ``cli.main`` one-shot (-L 160 -M 147, the GAINS, --multichannel,
       --spectra, --report), counted: the frames kernel, K9 and K2 must
       launch; the WAV against ``export_wav`` of the numpy oracle's z for
       the loaded input (all eight channels): >= 60 dB and within 1 LSB in
       >= 99.9 % of samples; the spectra JSON >= 60 dB against
       ``oracle.spectrum_oracle``; the report over 10 kB with its audio
       element.
    3. ``--stream-chunk 0.1`` (fused frames: the frames kernel and K9) and
       ``--mesh 1x1`` (the frames kernel and K9), counted, each WAV within
       1 LSB of the one-shot WAV; ``--mesh`` over more cards than are
       visible exits 2.
    4. The telephone ``Chain`` on the serving batch on the card, counted
       (the frames kernel must launch), >= 60 dB against the stagewise
       numpy oracle.
    5. [time] surfaces: the two decodes, the native int16 encode beside
       ``export_wav``, and main() one-shot and streamed split into its
       parts, median of SURFACE_REPS runs each.
    Returns the launches of the counted runs."""
    import os
    import tempfile

    import dsp_audio_project_tpu_torch as pt
    from dsp_audio_project_tpu_torch import cli, oracle
    from dsp_audio_project_tpu_torch.io import native

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("[surfaces] the native codec did not build/load")
    lib = native.library_path()
    log(f"[surfaces] native codec: {lib.parent.name}/{lib.name} built and "
        f"loaded in {time.perf_counter() - t0:.2f} s")
    cfg = pt.PipelineConfig(src=pt.SRCConfig(L=160, M=147),
                            eq=pt.EQConfig.from_gains(GAINS))
    gains = [arg for band, g in GAINS.items() for arg in ("-g", f"{band}={g}")]
    total = None
    with tempfile.TemporaryDirectory() as tmp:
        path = functools.partial(os.path.join, tmp)
        src = path("in.wav")
        pt.export_wav(xs, FS, src)
        with open(src, "rb") as fh:
            data = fh.read()
        x_nat, fs_nat = pt.load_signal(src, mono=False)
        x_np, fs_np = pt.load_signal(src, mono=False, engine="numpy")
        direct, _ = native.decode(data, mono=False)
        if not (fs_nat == fs_np == FS and x_nat.shape == (BATCH, xs.shape[1])
                and np.array_equal(x_nat, x_np)
                and np.array_equal(direct, x_np)):
            raise RuntimeError("[surfaces] native decode != numpy decode")
        enc = native.encode_pcm16(x_nat)
        pcm = np.frombuffer(pt.export_wav(x_nat, FS)[44:], "<i2")
        if not np.array_equal(enc.reshape(-1), pcm):
            raise RuntimeError("[surfaces] encode_pcm16 != export_wav")
        log(f"[surfaces] {BATCH} x {SECONDS:.0f} s PCM16 WAV "
            f"({len(data)} bytes): native decode == numpy decode bit for "
            f"bit; encode_pcm16 == export_wav's PCM bit for bit")

        # 2. the one-shot CLI
        one, spec, rpt = path("one.wav"), path("spec.json"), path("r.html")
        base = ["-L", "160", "-M", "147", "--no-ui-bounds", *gains,
                "--multichannel"]
        argv_one = [src, one, *base, "--spectra", spec, "--report", rpt]
        rc, counts = run_counted(lambda: cli.main(argv_one))
        if rc != 0:
            raise RuntimeError(f"[surfaces] cli one-shot exited {rc}")
        require("surfaces", counts, ("fir_frames_kernel", "eq_finish",
                                     "rfft_four_step_magnitude"))
        total = add_counts(total, counts)
        want = oracle_outputs(cfg, x_np)
        z_want = np.stack([z for _, z, _ in want])
        got, fs_out = wav_pcm(one)
        ref = np.frombuffer(pt.export_wav(z_want, 48000)[44:],
                            "<i2").reshape(-1, BATCH)
        q = min(oracle.snr_db(ref[:, i], got[:, i]) for i in range(BATCH))
        log(f"[surfaces] cli one-shot WAV ({got.shape[0]} x {BATCH} @ "
            f"{fs_out} Hz) vs export_wav of the oracle's z: min snr {q:.1f}"
            f" dB (gate 60)")
        if not (fs_out == 48000 and q >= 60.0):
            raise RuntimeError("[surfaces] cli WAV below the oracle gate")
        lsb_apart("surfaces", "cli one-shot WAV vs the oracle's", got, ref,
                  0.999)
        with open(spec) as fh:
            spectra = json.load(fh)
        worst = min(oracle.snr_db(s_want, np.asarray(
            spectra[key]["magnitude"])[i])
            for i, (_, _, specs) in enumerate(want)
            for key, s_want in zip(("input", "resampled", "output"), specs))
        log(f"[surfaces] cli spectra JSON vs oracle.spectrum_oracle: min snr"
            f" {worst:.1f} dB over {3 * BATCH} (gate 60)")
        if not worst >= 60.0:
            raise RuntimeError("[surfaces] spectra below the oracle gate")
        with open(rpt) as fh:
            html = fh.read()
        log(f"[surfaces] report: {len(html)} bytes, {html.count('<svg')} "
            "charts")
        if len(html) <= 10_000 or "<audio" not in html:
            raise RuntimeError("[surfaces] the report lacks its audio")

        # 3. streamed, and over a 1x1 mesh
        routes = (("stream", ["--stream-chunk", SURFACE_CHUNK]),
                  ("mesh 1x1", ["--mesh", "1x1"]))
        for name, extra in routes:
            out = path(f"{name.replace(' ', '_')}.wav")
            rc, counts = run_counted(lambda: cli.main([src, out, *base,
                                                       *extra]))
            if rc != 0:
                raise RuntimeError(f"[surfaces] cli {name} exited {rc}")
            require("surfaces", counts, ("fir_frames_kernel", "eq_finish"))
            total = add_counts(total, counts)
            lsb_apart("surfaces", f"cli {name} WAV vs one-shot",
                      wav_pcm(out)[0], got)
        over = f"1x{torch.cuda.device_count() + 1}"
        rc = cli.main([src, path("x.wav"), *base, "--mesh", over])
        log(f"[surfaces] cli --mesh {over}: exit {rc} (want 2)")
        if rc != 2:
            raise RuntimeError("[surfaces] an oversized mesh did not exit 2")

        # 4. the telephone chain
        (l1, m1, f1), eq_gains, (l2, m2, f2) = TELEPHONE
        stages = [pt.Resample(pt.SRCConfig(L=l1, M=m1, taps_rule_factor=f1)),
                  pt.Equalize(pt.EQConfig.from_gains(eq_gains)),
                  pt.Resample(pt.SRCConfig(L=l2, M=m2, taps_rule_factor=f2)),
                  pt.Clip()]
        x = torch.as_tensor(x_np, device=DEVICE)
        (y, fs_tel), counts = run_counted(lambda: pt.Chain(stages)(x, FS))
        require("surfaces", counts, ("fir_frames_kernel",))
        total = add_counts(total, counts)
        y = y.cpu().numpy()
        q = math.inf
        for i in range(BATCH):
            o1, r1 = oracle.resample_oracle(x_np[i], FS, stages[0].config,
                                            "fast")
            o2 = oracle.equalize_oracle(o1, r1, stages[1].config)
            o3, r3 = oracle.resample_oracle(o2.astype(np.float32), r1,
                                            stages[2].config, "fast")
            o3 = np.clip(o3, -1.0, 1.0)
            if o3.shape != y[i].shape or r3 != fs_tel:
                raise RuntimeError(f"[surfaces] telephone {y[i].shape} @ "
                                   f"{fs_tel} vs {o3.shape} @ {r3}")
            q = min(q, oracle.snr_db(o3, y[i]))
        log(f"[surfaces] telephone Chain {BATCH} x {y.shape[1]} @ {fs_tel} Hz"
            f" vs the stagewise oracle: min snr {q:.1f} dB (gate 60)")
        if not q >= 60.0:
            raise RuntimeError("[surfaces] telephone below the oracle gate")

        # 5. [time] surfaces
        dec = {}
        for engine in ("auto", "numpy"):
            ts = []
            for _ in range(SURFACE_REPS):
                t0 = time.perf_counter()
                pt.load_signal(src, mono=False, engine=engine)
                ts.append((time.perf_counter() - t0) * 1e3)
            dec[engine] = statistics.median(ts)
        z32 = z_want.astype(np.float32)
        for name, fn in (("encode_pcm16", lambda: native.encode_pcm16(z32)),
                         ("export_wav", lambda: pt.export_wav(z32, 48000))):
            ts = []
            for _ in range(SURFACE_REPS):
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            dec[name] = statistics.median(ts)
        log(f"[time] surfaces, card {smi}: decode of the {BATCH} x "
            f"{SECONDS:.0f} s WAV ({len(data)} bytes), median of "
            f"{SURFACE_REPS}: native {dec['auto']:.2f} ms, numpy "
            f"{dec['numpy']:.2f} ms; int16 encode of the one-shot's "
            f"({BATCH}, {z32.shape[1]}) z: native encode_pcm16 "
            f"{dec['encode_pcm16']:.2f} ms, export_wav to bytes "
            f"{dec['export_wav']:.2f} ms")
        for name, argv, stream in (
                ("one-shot", argv_one, False),
                ("--stream-chunk " + SURFACE_CHUNK,
                 [src, path("t.wav"), *base, "--stream-chunk", SURFACE_CHUNK,
                  "--spectra", path("t.json")], True)):
            runs = [timed_main(argv, stream) for _ in range(SURFACE_REPS)]
            med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
            log(f"[time] surfaces, card {smi}: cli.main {name}, median of "
                f"{SURFACE_REPS}: " + ", ".join(
                    f"{k} {v:.2f} ms" for k, v in med.items()))
    return total


# ---- the bench, the chip scripts and the graft entry -------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_EXTRA = {"src_eq_ms_per_60s_signal", "full_chain_ms_per_60s_signal",
               "streaming_samples_per_sec_per_chip"}
STREAM_SWEEP_FLS = (2048, 8192)
DYN_PIPELINE_CYCLES = 3


def add_runs(runs: list) -> dict:
    return {k: sum(r[k] for r in runs) for k in runs[0]}


class LaunchChecker:
    """Holds K1, the frames kernel, K9 and K2 against their plain versions
    at the launches a path makes.  Inside ``on()``, each launch made
    outside a CUDA-graph capture (a captured launch replays a geometry its
    warm-up ran eagerly) is followed by its plain version on the same
    inputs, under ``compare``'s bounds (> 120 dB, K2 > 110 dB, and max abs
    err <= 1e-5 * max|ref|): every launch, or with ``every=False`` only the
    first of each geometry this checker has not seen.  The comparisons
    launch no kernel, so the counts are untouched.  ``errs``: max abs err
    by record row."""

    ROWS = ("k1", "k3", "k9", "k2")

    def __init__(self, tag: str):
        self.tag = tag
        self.errs = dict.fromkeys(self.ROWS, 0.0)
        self.seen: set = set()
        self.held = dict.fromkeys(self.ROWS, 0)
        self.by_card: dict = {}      # held launches by the card's index
        self.worst_db = dict.fromkeys(self.ROWS, math.inf)
        self.every = True

    def _fresh(self, key) -> bool:
        if torch.cuda.is_current_stream_capturing():
            return False
        if not self.every and key in self.seen:
            return False
        self.seen.add(key)
        return True

    def _hold(self, row: str, what: str, *pairs,
              bound_db: float = 120.0) -> None:
        """One launch: each (kernel output, plain output) pair.  A pair
        that is all zeros (a stream's flush step past the signal's end on
        some shard) has no SNR: it must be equal bit for bit."""
        for got, ref in pairs:
            err = float((got - ref).abs().max())
            top = float(ref.abs().max())
            snr = snr_db(ref, got) if top > 0.0 else math.inf
            if not (got.shape == ref.shape and snr > bound_db
                    and err <= 1e-5 * top):
                raise RuntimeError(
                    f"[{self.tag}] {what} {tuple(got.shape)} disagrees with "
                    f"its plain version: snr {snr:.1f} dB (bound "
                    f"{bound_db:.0f}), max abs err {err:.3e} (bound 1e-05 * "
                    f"{top:.3e})")
            self.errs[row] = max(self.errs[row], err)
            self.worst_db[row] = min(self.worst_db[row], snr)
        self.held[row] += 1
        card = pairs[0][0].device.index
        self.by_card[card] = self.by_card.get(card, 0) + 1

    @contextlib.contextmanager
    def on(self, every: bool = True):
        import importlib

        fc = importlib.import_module(
            "dsp_audio_project_tpu_torch.kernels.fir_class")
        ef = importlib.import_module(
            "dsp_audio_project_tpu_torch.kernels.eq_finish")
        rf = importlib.import_module(
            "dsp_audio_project_tpu_torch.kernels.rfft")
        real = (fc._launch, fc._launch_frames, ef._launch, rf._launch)

        def k1(x, g2, y0, inj, n, f_pad, W, V, P, s, pad_left):
            real[0](x, g2, y0, inj, n, f_pad, W, V, P, s, pad_left)
            if self._fresh(("k1", tuple(x.shape), f_pad, W, V, P, s,
                            pad_left)):
                y_ref, inj_ref = fc.fir_cat_plain(x, g2, P, s, f_pad,
                                                  pad_left)
                self._hold("k1", f"K1 (y0, inj) at P={P} s={s} W={W} V={V}",
                           (y0, y_ref), (inj, inj_ref))

        def k3(x, g, y, n, f_out, W, P, s, pad_left):
            real[1](x, g, y, n, f_out, W, P, s, pad_left)
            if self._fresh(("k3", tuple(x.shape), f_out, W, P, s, pad_left)):
                self._hold("k3", f"frames kernel at P={P} s={s} W={W}",
                           (y, fc.fir_frames_plain(x, g, s, f_out, pad_left)))

        def k9(y0, st, gout, z, rows, U, d, ldy, vec):
            real[2](y0, st, gout, z, rows, U, d, ldy, vec)
            if self._fresh(("k9", tuple(y0.shape), y0.stride(), d, vec)):
                self._hold("k9", f"K9 at U={U} d={d}",
                           (z, ef.eq_finish_plain(y0, st, gout)))

        def k2(name, x, tw, un, out, n):
            real[3](name, x, tw, un, out, n)
            if self._fresh(("k2", name, tuple(x.shape))):
                mag = name == "rfft_mag_launch"
                ref = rf.rfft_four_step_plain(x, tw, un, mag)
                self._hold("k2", f"K2 {name} at N={n}",
                           (out, ref if mag else torch.view_as_real(ref)),
                           bound_db=110.0)

        self.every = every
        fc._launch, fc._launch_frames, ef._launch, rf._launch = (k1, k3, k9,
                                                                 k2)
        try:
            yield self
        finally:
            fc._launch, fc._launch_frames, ef._launch, rf._launch = real

    def report(self, what: str) -> None:
        log(f"[{self.tag}] {what}: launches held against their plain "
            "versions (bound 120 dB, max abs err <= 1e-5 * max|ref|): " +
            ", ".join(f"{row} {self.held[row]} (worst {self.worst_db[row]:.1f}"
                      f" dB, max abs err {self.errs[row]:.3e})"
                      for row in self.ROWS))


def stream_step_checked(cfg, fl: int, checker: LaunchChecker) -> None:
    """The first step of the bench's stream processor (C = 8, ``fl``
    frames a step, the bench's signal) under ``checker``: its eager
    warm-up launches K1 and K9 at the step's geometry."""
    from dsp_audio_project_tpu_torch import bench
    from dsp_audio_project_tpu_torch.ops.src import make_plan
    from dsp_audio_project_tpu_torch.parallel import single_device_mesh
    from dsp_audio_project_tpu_torch.streaming import ShardedStreamProcessor

    plan = make_plan(cfg.src.L, cfg.src.M, cfg.src.taps_rule_factor)
    first = fl * plan.s + plan.W
    xs = bench.signal_batch(bench.make_signal(first, FS),
                            bench.STREAM_CHANNELS, seed=11)
    sp = ShardedStreamProcessor(cfg, FS, single_device_mesh(),
                                bench.STREAM_CHANNELS, frames_per_shard=fl)
    with checker.on(every=False):
        z = sp.process(xs)
    if not (z.shape[1] > 0 and np.isfinite(z).all()):
        raise RuntimeError(f"[{checker.tag}] the stream's first step at FL "
                           f"{fl} gave {z.shape} or a non-finite value")


def phase_bench() -> tuple[dict, dict]:
    """[bench]: the port bench's run (``dsp_audio_project_tpu_torch.bench``)
    at its full width, counted; its stderr lines here, its JSON line with
    the [bench] prefix.  Then K1, the frames kernel and K9 at the geometry
    the bench adds, one stream step at its FL, against their plain
    versions (the run itself stays unchecked: its times would carry the
    checks).  Returns the counts and the max abs err by record row."""
    from dsp_audio_project_tpu_torch import bench

    with contextlib.redirect_stderr(sys.stdout):
        rec, counts = run_counted(bench.run)
    require("bench", counts, ("polyphase_fir_class_rect_cat", "eq_finish",
                              "rfft_four_step_magnitude",
                              "fir_frames_kernel"))
    numbers = [rec["value"], rec["vs_baseline"], *rec["extra"].values()]
    if (set(rec) != BENCH_KEYS or set(rec["extra"]) != BENCH_EXTRA
            or not all(math.isfinite(v) and v > 0 for v in numbers)):
        raise RuntimeError(f"[bench] malformed record {rec}")
    checker = LaunchChecker("bench")
    stream_step_checked(bench.serving_config(), bench.STREAM_FL, checker)
    checker.report(f"the stream's step at FL {bench.STREAM_FL}")
    if not (checker.held["k1"] and checker.held["k9"]):
        raise RuntimeError("[bench] the stream step held no K1 or K9 launch")
    log("[bench] " + json.dumps(rec))
    return counts, checker.errs


def graft_entry_once() -> float:
    """``graft_entry.entry()``'s program once: z >= 60 dB against the
    oracle for both channels; returns the worst snr."""
    from dsp_audio_project_tpu_torch import graft_entry, oracle
    from dsp_audio_project_tpu_torch.config import EQConfig, SRCConfig

    fn, (x,) = graft_entry.entry()
    z, mags = fn(x)
    src = SRCConfig(L=160, M=147)
    eq = EQConfig.from_gains(graft_entry.GAINS)
    n_out = src.output_length(x.shape[-1])
    zf = z.reshape(x.shape[0], -1)[:, :n_out].cpu().numpy()
    xs = x.cpu().numpy()
    worst = min(oracle.snr_db(oracle.pipeline_oracle(
        xs[i], FS, src, eq, engine="fast")[0], zf[i])
        for i in range(xs.shape[0]))
    log(f"[scripts] graft_entry.entry(): z {tuple(z.shape)}, spectra "
        f"{[tuple(m.shape) for m in mags]}, min snr vs oracle {worst:.1f} dB "
        "(gate 60)")
    if not (worst >= 60.0 and all(bool(torch.isfinite(m).all())
                                  for m in mags)):
        raise RuntimeError("[scripts] graft_entry's program failed its gate")
    return worst


def phase_scripts() -> tuple[dict, dict]:
    """[scripts]: config_matrix (79 configurations, 1 s a signal),
    rfft_sweep (its default sizes), stream_sweep (FL 2048 and 8192),
    dyn_pipeline (3 cycles) and graft_entry's program, each counted; their
    stderr lines here.  K1, the frames kernel and K9 are held against their
    plain versions at every launch of config_matrix and graft_entry, and at
    the first launch of each geometry of stream_sweep and dyn_pipeline
    (the stream's steps checked beforehand, so that no check falls inside
    a timed or profiled pass).  Returns the counts and the max abs err by
    record row."""

    from dsp_audio_project_tpu_torch import bench
    from dsp_audio_project_tpu_torch.scripts import (
        config_matrix, dyn_pipeline, rfft_sweep, stream_sweep,
    )

    checker = LaunchChecker("scripts")
    for fl in STREAM_SWEEP_FLS:
        stream_step_checked(bench.serving_config(), fl, checker)
    checker.report(f"stream steps at FL {STREAM_SWEEP_FLS}")
    # config_matrix last: its checks' plain products load many cuBLAS
    # kernels, after which the profiler lost the records of the next
    # script's one-call K7 sessions in two H100 runs of two.
    steps = (
        ("rfft_sweep", rfft_sweep.run, True, ("rfft_four_step_tall",)),
        ("stream_sweep", lambda: stream_sweep.run(STREAM_SWEEP_FLS), False,
         ("polyphase_fir_class_rect_cat", "eq_finish")),
        ("dyn_pipeline", lambda: dyn_pipeline.run(DYN_PIPELINE_CYCLES), False,
         ("fir_frames_kernel", "eq_finish")),
        ("graft_entry", graft_entry_once, True,
         ("polyphase_fir_class_rect_cat", "eq_finish",
          "rfft_four_step_magnitude")),
        ("config_matrix", config_matrix.run, True,
         ("fir_frames_kernel", "eq_finish", "polyphase_fir_class_rect_cat")),
    )
    runs = []
    for name, fn, every, needed in steps:
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(sys.stdout), checker.on(every):
            res, counts = run_counted(fn)
        require(f"scripts {name}", counts, needed)
        if name == "config_matrix" and len(res) != 79:
            raise RuntimeError(f"[scripts] config_matrix ran {len(res)} "
                               "configurations, not 79")
        log(f"[scripts] {name}: {time.perf_counter() - t0:.1f} s")
        checker.report(f"up to {name}")
        runs.append(counts)
    return add_runs(runs), checker.errs


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
    want = oracle_outputs(cfg, xs)
    log(f"[oracle] numpy oracle for {BATCH} signals: "
        f"{time.perf_counter() - t0:.2f} s")
    slice_counts, z_one = phase_slice(pipe, x, want)
    runs = [slice_counts, phase_frames(pipe, x, want)]
    analysis_counts, analysis_paths = phase_analysis(cfg, x, xs, want)
    runs.append(analysis_counts)
    explicit_counts, pipe_explicit, y_flat = phase_explicit(cfg, x, want)
    runs.append(explicit_counts)
    e2a, e2b = phase_e2(cfg, y_flat)
    e7, e7_counts = phase_e7(cfg, y_flat, want)
    del y_flat
    e6, e6_counts = phase_e6(x)
    dyn_counts, dyn_checks, dyn = phase_dynamic(pipe, x, want)
    jit_counts, jit_errs = phase_jit(cfg, x, want, smi)
    stream_one_counts, stream_lat = phase_stream_one(
        cfg, xs[0], pipe(x[:1], FS).output[0])
    stream_counts = phase_stream_sharded(cfg, xs, z_one)
    sharded_counts, sharded_errs = phase_sharded(cfg, x, xs, want, z_one)
    multicard_counts, multicard_errs = phase_multicard(cfg, x, xs, want,
                                                       z_one)
    del z_one
    surfaces_counts = phase_surfaces(xs, smi)
    bench_counts, bench_errs = phase_bench()
    scripts_counts, scripts_errs = phase_scripts()
    for errs in (jit_errs, sharded_errs, multicard_errs, bench_errs,
                 scripts_errs):
        for tag, err in errs.items():
            k = {"k1": k1, "k3": k3, "k9": k9, "k2": k2}[tag]
            k["max_abs_err"] = max(k["max_abs_err"], err)
    for tag, err in phase_stream_kernels(cfg, xs).items():
        k = {"k1": k1, "k3": k3, "k9": k9, "k2": k2}[tag]
        k["max_abs_err"] = max(k["max_abs_err"], err)
    runs += [e7_counts, e6_counts, k3_counts, dyn_counts, jit_counts,
             stream_one_counts, stream_counts, sharded_counts,
             multicard_counts, surfaces_counts, bench_counts, scripts_counts]
    launches = add_runs(runs)

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
    dyn_chains = time_dynamic(pipe, x, dyn)
    stream_steps = time_stream(cfg, pipe, x, stream_lat)
    sharded_paths = time_sharded(cfg, pipe, x, xs)

    kernels = {"k1": k1, "k2": k2, "k3": k3, "k9": k9, "k2c": k2c,
               "k7": k7, "k8": k8, "e2a": e2a, "e2b": e2b, "e7": e7, "e6": e6,
               **k3_routes, **dyn_checks}
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
        phase_profile(stream_steps, shape=f"{BATCH} channels x one step")
        phase_profile({**chains, **dyn_chains, **sharded_paths,
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
    if sys.argv[1:2] == ["--multicard-worker"]:
        multicard_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    if sys.argv[1:2] == ["--capture-fail-worker"]:
        capture_fail_worker()
        sys.exit(0)
    sys.exit(main())
