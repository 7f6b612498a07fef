"""The routed rfft kernel against the torch butterfly and torch.fft.rfft.

    python -m dsp_audio_project_tpu_torch.scripts.rfft_sweep [N ...]

Counterpart of the repo's ``scripts/rfft_sweep.py`` (default N: 131072,
262144, 524288; about 2M samples a batch).  For each N, the device time
(``utils/benchmarking.measure_device``: ten calls in a row behind a spin
kernel, the median of five passes) of |rfft| of the batch
through the kernel ``ops/fft._rfft_kernel_plan`` routes it to (K2 up to
8192, K7 from 16384 to 524288, K8 at 1048576), through the torch butterfly
(``rfft_magnitude(engine="jnp")``) and through ``torch.fft.rfft(x).abs()``,
the library call computing the same function (timed here, used nowhere in
the port).  The kernel's output is held against float64 ``np.fft.rfft``:
max abs error <= 1e-5 * max|X|, else the run raises.  Needs the card.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.fft import _rfft_kernel_plan, rfft_magnitude
from ..utils.benchmarking import measure_device
from ..utils.device import default_device

DEFAULT_SIZES = (131072, 262144, 524288)
REL_BOUND = 1e-5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_ms(fn, *args) -> float:
    return measure_device(fn, *args) * 1e3


def run(sizes=DEFAULT_SIZES) -> list:
    """[(N, rows, kernel kind or None, kernel ms, butterfly ms, library
    ms, rel err)]: device ms a call on (rows, N) float32."""
    dev = default_device("rfft_sweep")
    log(f"device: {torch.cuda.get_device_name(0)}")
    rng = np.random.default_rng(0)
    out = []
    for n in sizes:
        rows = max(2, (1 << 21) // n)
        x_host = rng.standard_normal((rows, n)).astype(np.float32)
        x = torch.as_tensor(x_host, device=dev)
        plan = _rfft_kernel_plan(n)
        t_bf = device_ms(rfft_magnitude, x, "jnp")
        t_lib = device_ms(lambda v: torch.fft.rfft(v).abs(), x)
        line = (f"N={n} rows={rows}: butterfly {t_bf:.4f} ms, "
                f"torch.fft.rfft(x).abs() {t_lib:.4f} ms")
        t_k = rel = None
        if plan is not None:
            t_k = device_ms(rfft_magnitude, x, "pallas")
            want = np.abs(np.fft.rfft(x_host.astype(np.float64), axis=-1))
            got = rfft_magnitude(x, engine="pallas").cpu().numpy()
            rel = float(np.max(np.abs(got - want)) / np.max(want))
            line += (f", kernel {plan[0]} {t_k:.4f} ms ({t_bf / t_k:.2f}x "
                     f"the butterfly, {t_lib / t_k:.2f}x the library; "
                     f"max abs err {rel:.1e} x max|X|)")
            if not rel <= REL_BOUND:
                raise RuntimeError(f"the {plan[0]} kernel at N={n} is off "
                                   f"by {rel:.1e} x max|X|")
        log(line)
        out.append((n, rows, None if plan is None else plan[0], t_k, t_bf,
                    t_lib, rel))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run([int(a) for a in argv] or DEFAULT_SIZES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
