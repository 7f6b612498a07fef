"""Every UI configuration through the chain on the card, gated against the
oracle.

    python -m dsp_audio_project_tpu_torch.scripts.config_matrix [seconds]

Counterpart of the repo's ``scripts/config_matrix.py``: every (L, M) in
[1, 8]^2 the UI reaches, plus the serving 160/147, with the mixed gain
vector, and the all-flat and +/-15 dB extreme vectors on a six-pair subset
and on 160/147: 79 configurations.  Each runs through ``AudioPipeline``'s
call (``pipe(x, fs)``), and through ``forward_cat`` where
``cat_supported``; each z must reach >= 60 dB against
``oracle.pipeline_oracle(engine="fast")``, else the run raises.  The route
printed is the one the call took, from the pipeline's own rule
(``AudioPipeline.call_route``): the frames path, or the flat ``_forward``
(``resample`` on the frames kernel, then ``equalize``).
``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import itertools
import sys
import time

import numpy as np

from ..config import EQConfig, KernelConfig, PipelineConfig, SRCConfig
from ..models.chain import AudioPipeline
from ..oracle import pipeline_oracle, snr_db
from ..utils.device import as_input

FS = 44100
MIX = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
       "Brilliance": 4}
FLAT = {}
EXTREME = {"Sub-Bass": 15, "Bass": -15, "Low Mids": 15, "High Mids": -15,
           "Presence": 15, "Brilliance": -15}
SUBSET = {(1, 1), (8, 1), (1, 8), (3, 2), (7, 5), (5, 7), (160, 147)}
GATE_DB = 60.0


def log(msg: str) -> None:
    print(msg, flush=True)


def configurations() -> list:
    """[(L, M, gain set name, gains)]: the 79 configurations."""
    out = []
    for L, M in list(itertools.product(range(1, 9), range(1, 9))) + [
            (160, 147)]:
        sets = [("mix", MIX)]
        if (L, M) in SUBSET:
            sets += [("flat", FLAT), ("extreme", EXTREME)]
        out += [(L, M, name, gains) for name, gains in sets]
    return out


def make_signal(n: int) -> np.ndarray:
    rng = np.random.default_rng(9)
    t = np.arange(n) / FS
    x = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 40 * t)
         + 0.2 * rng.standard_normal(n))
    return (x / np.max(np.abs(x))).astype(np.float32)


def run(seconds: float = 1.0, device=None) -> list:
    """Every configuration at ``seconds`` a signal; returns [(L, M, gain set,
    route, snr, cat snr or None)].  Raises below the gate."""
    n = int(seconds * FS)
    x_host = make_signal(n)
    x = as_input(x_host, device, "config_matrix")
    rows = []
    worst = (float("inf"), None)
    t_start = time.perf_counter()
    for L, M, gname, gains in configurations():
        cfg = PipelineConfig(
            src=SRCConfig(L=L, M=M), eq=EQConfig.from_gains(gains),
            kernels=KernelConfig(eq_fast=True, src_fast=True),
        )
        pipe = AudioPipeline(cfg, device=x.device)
        n_out = cfg.src.output_length(n)
        t0 = time.perf_counter()
        z = pipe(x, FS).output.cpu().numpy()
        want, _ = pipeline_oracle(x_host, FS, cfg.src, cfg.eq, engine="fast")
        q = snr_db(want, z)
        qc = None
        if pipe.cat_supported(n, FS):
            zc = pipe.forward_cat(x, FS).reshape(-1)[:n_out].cpu().numpy()
            qc = snr_db(want, zc)
        path = pipe.call_route(n)
        rows.append((L, M, gname, path, q, qc))
        cat_note = "" if qc is None else f"  cat={qc:6.1f} dB"
        log(f"L={L:3d} M={M:3d} gains={gname:7s} path={path:6s} "
            f"snr={q:6.1f} dB{cat_note}  ({time.perf_counter() - t0:.2f} s)")
        for what, s in (("call", q), ("cat", qc)):
            if s is None:
                continue
            if s < worst[0]:
                worst = (s, (L, M, gname, what))
            if not s >= GATE_DB:
                raise RuntimeError(f"{what} snr {s:.1f} dB below the "
                                   f"{GATE_DB:.0f} dB gate at {(L, M, gname)}")
    log(f"ALL {len(rows)} configs >= {GATE_DB:.0f} dB on {x.device}; worst "
        f"{worst[0]:.1f} dB at {worst[1]}  (total "
        f"{time.perf_counter() - t_start:.1f} s)")
    return rows


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(float(argv[0]) if argv else 1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
