"""Sample-rate conversion as a polyphase frame matmul (host plan + torch rows).

The reference converts rate by zero-stuffing to the full L*N rate, running a
40*max(L,M)+1-tap sinc-Blackman LPF with centered 'same' alignment and
decimating by M (dsp_core.py:133-173).  With T taps (odd) and C = T//2 the
output is exactly

    y[n] = sum_q x[q] * h[n*M + C - L*q]                      (*)

Grouping outputs by phase class c = n mod P (P = L/gcd(L,M)) turns (*) into
one dense product: frame k is the strided window x[k*s + lo : k*s + lo + W]
(s = M/gcd(L,M)) and y[k*P + c] = frame_k @ G[:, c], with G a host-built
(W, P) operator.  ``make_plan`` is a numpy copy of the JAX package's planner
(``dsp_audio_project_tpu/ops/src.py``), held bit-for-bit equal by the tests.
``resample`` is the stand-alone SRC: its frames run through the frames
kernel (kernels/fir_class.fir_frames_kernel) for every stride s (the JAX
package's split into shifted matmuls for s >= 8 and a gather below is a
TPU gather cost, not carried).  ``resample_rows`` computes the few rows the
y spectrum needs.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SRCConfig
from ..design.sinc import lowpass_sinc
from ..kernels.fir_class import fir_frames_kernel, plan_operator
from ..utils.device import as_input


# eq=False: identity hash (instances are lru_cache singletons per config;
# the ndarray field would otherwise break hashing in downstream caches).
@dataclasses.dataclass(frozen=True, eq=False)
class PolyphasePlan:
    """Host-side geometry + operator for one (L, M, taps) configuration.

    Attributes:
      G:  (W, P) float64 operator matrix (cast to f32 at use).
      lo: frame offset — frame k covers x[k*s + lo : k*s + lo + W].
      s:  frame stride in input samples.
      P:  number of phase classes (outputs per frame).
      W:  frame width.
      taps: FIR length T (odd).
      halo_left/halo_right: input samples a time-shard needs from its
        neighbors for seamless overlap-save processing (derived from lo/W).
    """

    G: np.ndarray
    lo: int
    s: int
    P: int
    W: int
    taps: int
    L: int
    M: int

    @property
    def halo_left(self) -> int:
        return max(0, -self.lo)

    @property
    def halo_right(self) -> int:
        return max(0, self.lo + self.W - 1)


@functools.lru_cache(maxsize=None)
def make_plan(
    L: int, M: int, taps_rule_factor: int = 40, center: int | None = None
) -> PolyphasePlan:
    """``center`` is the 'same'-mode alignment offset.  numpy's 'same' takes
    the middle max(len(a), len(v)) of the full convolution, i.e. offset
    (min(len(a), len(v)) - 1) // 2 — for the common case of signals longer
    than the filter that is T//2; short signals pass their own center."""
    cfg = SRCConfig(L=L, M=M, taps_rule_factor=taps_rule_factor)
    T = cfg.num_taps
    C = T // 2 if center is None else center
    h = lowpass_sinc(cfg.cutoff_norm, T) * L  # gain compensation, dsp_core.py:162

    g = math.gcd(L, M)
    P = L // g
    s = M // g

    # Per-class residue/base and branch taps.
    n_c = np.arange(P)
    phi = n_c * M + C
    r_c = phi % L
    b_c = phi // L
    Tb = int(np.ceil(T / L))  # max taps per polyphase branch

    lo = int(b_c.min()) - (Tb - 1)
    hi = int(b_c.max())
    W = hi - lo + 1

    G = np.zeros((W, P), dtype=np.float64)
    for c in range(P):
        for t in range(Tb):
            hidx = int(r_c[c]) + L * t
            if hidx < T:
                G[int(b_c[c]) - t - lo, c] = h[hidx]
    return PolyphasePlan(G=G, lo=lo, s=s, P=P, W=W, taps=T, L=L, M=M)


def resample(x, fs: int, cfg: SRCConfig, device=None):
    """L/M sample-rate conversion matching the reference bit-for-behavior.

    ``x``: (..., N) float32.  A tensor stays on its device; an array goes
    to the card (raising without one) unless ``device`` says otherwise
    (``device="cpu"`` for the CPU).  Returns (..., ceil(N*L/M)) and the new
    rate int(fs*L/M) (truncating, as dsp_core.py:172).  Bypass (L = M = 1)
    returns the input tensor as it came.
    """
    fs_out = fs if cfg.bypass else cfg.output_rate(fs)
    return _resample_jit(as_input(x, device, "resample"), cfg), fs_out


def _resample_jit(x: torch.Tensor, cfg: SRCConfig):
    """The device half of ``resample`` (the JAX package jits this one)."""
    if cfg.bypass:
        return x
    x = x.contiguous()
    n = x.shape[-1]
    n_up = n * cfg.L
    T = cfg.num_taps
    if n_up >= T:
        plan = make_plan(cfg.L, cfg.M, cfg.taps_rule_factor)
        n_out = cfg.output_length(n)
    else:
        # Signal shorter than the filter: numpy 'same' convolution returns
        # max(n_up, T) samples centered at (n_up - 1) // 2.
        plan = make_plan(cfg.L, cfg.M, cfg.taps_rule_factor, (n_up - 1) // 2)
        n_out = -(-T // cfg.M)
    return _resample_frames(x, plan, n, n_out)


def shifted_frames_matmul(
    x: torch.Tensor, plan: PolyphasePlan, num_frames: int, pad_left: int
) -> torch.Tensor:
    """(..., num_frames, P) frames of the resampled signal.

    After left-padding by ``pad_left`` (a negative value drops leading
    samples), index 0 of x is frame 0's window start.  The JAX package's
    J shifted MXU matmuls over s-sample groups; here one launch of the
    frames kernel.
    """
    x = x.to(torch.float32).contiguous()
    return fir_frames_kernel(x, plan_operator(plan, x.device), plan.s,
                             num_frames, pad_left)


def _resample_frames(
    x: torch.Tensor, plan: PolyphasePlan, n: int, n_out: int
) -> torch.Tensor:
    """y[k*P + c] = sum_w x[k*s + lo + w] G[w, c], flat and cropped to n_out."""
    num_frames = -(-n_out // plan.P)
    frames = shifted_frames_matmul(x, plan, num_frames, -plan.lo)
    return frames.reshape(x.shape[:-1] + (num_frames * plan.P,))[..., :n_out]


def resample_rows(
    x: torch.Tensor,
    plan: PolyphasePlan,
    r0: int,
    r1: int,
    G: torch.Tensor | None = None,
) -> torch.Tensor:
    """Frames [r0, r1) of the resampled signal, computed directly from x.

    A small (r1-r0, W) @ (W, P) float32 product over the strided input
    windows (``unfold``) — the cat chain uses it for the y spectrum's ~13
    frame rows, so the full resampled signal never exists.  Frame k covers
    x[k*s + lo : k*s + lo + W] with zero extension outside x.  ``G`` is the
    plan's operator as a float32 tensor on x's device (built from the plan
    when omitted).
    """
    s, W = plan.s, plan.W
    a = r0 * s + plan.lo          # window span in x coordinates
    b = (r1 - 1) * s + plan.lo + W
    n = x.shape[-1]
    seg = x[..., max(0, a): min(n, b)].to(torch.float32)
    seg = F.pad(seg, (max(0, -a), max(0, b - n)))
    win = seg.unfold(-1, W, s)     # (..., r1 - r0, W)
    if G is None:
        G = torch.as_tensor(plan.G, dtype=torch.float32, device=x.device)
    return win @ G
