"""Bounds of the library products the port still leaves to cuBLAS.

    python -m dsp_audio_project_tpu_torch.scripts.library_bounds

A computation from shapes, no device needed: for each product, the least
time an H100 SXM could take for it, the larger of its bytes (each input
read once, the output written once, float32) over 3.35 TB/s and its
operations over the rate of the unit named (fp32 outside the tensor cores
at 67 TFLOP/s; 3xTF32, three TF32 products a multiply-add as the FIR
kernel runs them, at 495 TFLOP/s).  The products, at the shapes of the
benchmark's cells (60 s at 44.1 kHz, 160/147):

* ``resample_rows``' ``win @ G``, the y spectrum's frame rows of the serve
  cell's cat chain (8 signals);
* the slider's weight-concat product ``x_g @ dyn_frames_weights(ops)``
  (one signal, d = 12);
* the static frames path's weight-concat product ``x_g @ frames_weights``
  at 8 x 60 s (d = 10).
"""
from __future__ import annotations

from ..config import EQConfig, PipelineConfig, SRCConfig
from ..kernels.fir_class import frame_grid
from ..ops.spectrum import spectrum_rows_needed
from ..ops.src import make_plan

PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s (data sheet)
PEAK_FP32 = 67e12         # float32 outside the tensor cores
PEAK_TF32 = 495e12        # TF32 on the tensor cores, dense
FS, SECONDS = 44100, 60
SERVE_GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
               "Brilliance": 4}


def bounds(M: int, K: int, N: int, batch: int = 1) -> dict:
    """(batch, M, K) @ (K, N) float32: bytes, fp32 and 3xTF32 bounds (µs)."""
    nbytes = 4.0 * (batch * M * K + K * N + batch * M * N)
    flops = 2.0 * batch * M * N * K
    return {"shape": f"{batch} x ({M}, {K}) @ ({K}, {N})",
            "bytes_us": nbytes / PEAK_BYTES * 1e6,
            "fp32_us": flops / PEAK_FP32 * 1e6,
            "tf32x3_us": 3 * flops / PEAK_TF32 * 1e6}


def products() -> dict:
    cfg = PipelineConfig()
    src = SRCConfig(L=160, M=147)
    plan = make_plan(src.L, src.M)
    n = FS * SECONDS
    n_out = -(-n * plan.L // plan.M)
    r0, r1 = spectrum_rows_needed(n_out, plan.P, cfg.spectrum)
    frames = frame_grid(n_out, plan.P)      # the frames kernel's padded rows

    def v_pad(d):                   # U + d columns, padded to 4
        return plan.P + d + -(plan.P + d) % 4

    d_serve = 2 * len(EQConfig.from_gains(SERVE_GAINS).active_bands(
        src.output_rate(FS)))
    d_slider = 2 * len(cfg.eq.band_centers)
    return {
        "resample_rows win @ G (serve, y spectrum rows)":
            bounds(r1 - r0, plan.W, plan.P, batch=8),
        "slider weight-concat x_g @ dyn_frames_weights":
            bounds(frames, plan.P, v_pad(d_slider)),
        "frames weight-concat x_g @ frames_weights (8 x 60 s)":
            bounds(frames, plan.P, v_pad(d_serve), batch=8),
    }


def main() -> int:
    for name, b in products().items():
        print(f"{name}: {b['shape']}; bytes {b['bytes_us']:.2f} µs, fp32 "
              f"{b['fp32_us']:.2f} µs, 3xTF32 {b['tf32x3_us']:.2f} µs "
              "(H100 SXM peaks: 3.35 TB/s, 67 TFLOP/s fp32, 495 TFLOP/s TF32)",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
