"""K1 (the EQ-fused "cat" FIR) and the frames FIR (K3, K4, K6, E1): wrappers,
plain versions and the class predicates, over one CUDA kernel body.

The fused chain's first EQ step is a per-frame product with frame-independent
weights, frames @ [group_fir^T | group_in], so by distributivity it folds
into the SRC operator on the host:

    [y0 | inj][f] = (x_win[f] @ G) @ w_cat = x_win[f] @ G2,  G2 = G @ w_cat,

composed in float64 once per config (``cat_operator``, as
``dsp_audio_project_tpu/kernels/fir_class.py:_class_banks_cat`` does).  The
kernel (``csrc/fir_cat.cu``) then emits the EQ's zero-state output y0 and the
per-frame state injections inj directly; the resampled signal never exists
in device memory.

Replaces ``dsp_audio_project_tpu/kernels/fir_class.py:731
polyphase_fir_class_rect_cat``.  Differences from the TPU kernel, all layout
only: inj is emitted unpacked (B, F_pad, d) instead of the DPAD=16
class-major packing, and G2 is one (W, P+d) matrix instead of 128 rotated
banks.  The frame grid is the same (F_pad = Kp*128, Kp a multiple of 8), so
y0 and the EQ's block count match the JAX package exactly.

The frames FIR computes y frames = windows @ G, the same body with V = P
(``fir_frames_kernel``, launcher ``fir_frames_launch``).  The JAX package
stages that one function five ways for the TPU; the port keeps each entry
point and its contract (keywords, frame counts, ValueErrors) as a thin
wrapper over the one kernel:

* K3 ``polyphase_fir_class_rect_frames`` (``fir_class.py:928``) and K4
  ``polyphase_fir_class_frames`` (``:1042``): F_pad = Kp*128 frames with
  ``pad_frames``.  ``rect_supported`` is ``class_supported`` here: the
  rectangle is a VMEM limit that the CUDA kernel does not have;
* K6 ``polyphase_fir_class_flat`` (``:312``): the flat signal, which on a
  row-major device is the (F, P) frames viewed flat;
* E1 ``polyphase_fir`` (``experiments/fir.py:61``): the flat SRC cropped
  to n_out;
* K5 ``polyphase_fir_shear_frames`` lives in fir_shear.py.

The kernel runs its products on the tensor cores with a 3xTF32 split: each
operand v is hi = rna_tf32(v) plus lo = rna_tf32(v - hi), each 8-tap step's
a_lo b_hi + a_hi b_lo + a_hi b_hi goes into a fresh accumulator for a run of
``FRESH_TAPS`` = 16 taps, and each run's sum is added to the running one in
fp32 (the tensor core truncates its sum at the largest addend, so the
running sum never enters it).  That keeps the fp32 product's accuracy
(~135 dB against the fp32 plain version on the card, where one TF32 product
gives ~72 dB and the JAX package's bf16x3 ~108 dB), so it serves
src_fast=True and False alike; the wrappers take ``precision`` and ignore it.

Where a shape's 128-frame span of x fits in shared memory (every shape of
the main path), the launch takes the warpgroup body: a small kernel first
writes G's TF32 halves into scratch the wrapper allocates (``_halves``), in
the K-major layout wgmma reads, and ``fir_tf32_kernel`` then streams them
through a shared ring by bulk copies while two consumer warpgroups run
wgmma over 128 frames x every column, A built in registers from the span.
Wider strides take the older mma.sync body (``kernel_route`` says which).
At the serving shape the work is bound by bytes and by the three products
about equally (~55-57 us each on an H100); see the note in
``csrc/fir_cat.cu``.  ``tf32_split`` and ``fir_frames_3xtf32`` mirror that
arithmetic in plain torch for the CPU tests; nothing on the main path calls
them, and the plain versions (``fir_frames_plain``, ``fir_cat_plain``) stay
the fp32 product the card compares the kernel with.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

if TYPE_CHECKING:
    from ..ops.src import PolyphasePlan

NUM_CLASSES = 128   # frame-grid granule of the JAX kernel (F_pad = Kp * 128)

_LAUNCHERS = {
    "fir_cat_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int64]
    + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "fir_frames_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int64]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "fir_tf32_route": [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "fir_tf32_scratch_floats": [ctypes.c_int] * 3,
}
# The kernel's bodies by fir_tf32_route's code (csrc/fir_cat.cu).
BODIES = ("wgmma, two span buffers", "wgmma, one span buffer",
          "mma.sync, span at 32 frames", "mma.sync, streamed windows")
_g2_cache: dict = {}
_g_cache: dict = {}


def plan_operator(plan: PolyphasePlan, device,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plan's G as a (W, P) tensor of ``dtype`` on ``device`` (cached;
    float64 is G as designed)."""
    key = (id(plan), str(torch.device(device)), dtype)
    g = _g_cache.get(key)
    if g is None:
        g = torch.as_tensor(plan.G, device=device).to(dtype)
        _g_cache[key] = g
    return g


def cat_operator(G: np.ndarray, w_cat: np.ndarray) -> np.ndarray:
    """G2 = G @ w_cat, (W, P+d) float32, composed in float64 and cached.

    ``G`` is the plan's (W, P) operator, ``w_cat`` the EQ's (P, P+d)
    weight concat (ops/eq.eq_cat_weights).
    """
    G = np.ascontiguousarray(G, dtype=np.float64)
    w_cat = np.ascontiguousarray(w_cat, dtype=np.float64)
    key = (G.tobytes(), G.shape, w_cat.tobytes(), w_cat.shape)
    hit = _g2_cache.get(key)
    if hit is not None:
        return hit
    P = G.shape[1]
    if w_cat.shape[0] != P:
        raise ValueError(f"w_cat rows {w_cat.shape[0]} must equal P {P}")
    if w_cat.shape[1] <= P:
        raise ValueError(f"w_cat has no inj columns: shape {w_cat.shape}")
    g2 = (G @ w_cat).astype(np.float32)
    _g2_cache[key] = g2
    return g2


def frame_grid(n_out: int, P: int, num_frames: int | None = None) -> int:
    """F_pad: the JAX kernel's padded frame count (Kp*128, Kp % 8 == 0)."""
    if num_frames is None:
        num_frames = -(-n_out // P)
    Kp = 8 * -(-(-(-num_frames // NUM_CLASSES)) // 8)
    return Kp * NUM_CLASSES


def fir_frames_plain(x: torch.Tensor, g: torch.Tensor, s: int, f_pad: int,
                     pad_left: int) -> torch.Tensor:
    """Plain torch version of the frames kernel: unfold windows @ G in fp32.

    ``x`` (B, n) float32, ``g`` (W, V) float32, ``pad_left`` >= 0.  Returns
    (B, f_pad, V): frame f is x_pad[f*s : f*s + W] @ g.
    """
    W = g.shape[0]
    n = x.shape[-1]
    if f_pad == 0:
        return x.new_zeros((x.shape[0], 0, g.shape[1]))
    total = (f_pad - 1) * s + W
    xp = F.pad(x, (pad_left, max(0, total - pad_left - n)))[..., :total]
    return xp.unfold(-1, W, s) @ g


def _tf32_rna(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest on the 13 dropped mantissa bits, ties away from zero (the
    magnitude's bit pattern plus 0x1000, then truncated); inf and NaN pass."""
    b = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = b & 0x7FFFFFFF
    r = torch.where(mag >= 0x7F800000, b,
                    ((mag + 0x1000) & 0xFFFFE000) | (b & 0x80000000))
    return (r - ((r >> 31) << 32)).to(torch.int32).view(torch.float32)


def tf32_split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of float32 ``t`` as the kernel splits an operand:
    hi = rna_tf32(t), lo = rna_tf32(t - hi); hi + lo is t to ~2^-21
    relative (for normal t whose lo is normal too)."""
    hi = _tf32_rna(t)
    return hi, _tf32_rna(t - hi)


FRESH_TAPS = 16   # taps a fresh accumulator takes in csrc/fir_cat.cu


def fir_frames_3xtf32(x: torch.Tensor, g: torch.Tensor, s: int, f_pad: int,
                      pad_left: int, run: int = FRESH_TAPS) -> torch.Tensor:
    """The kernel's arithmetic in plain torch, in its order: the taps in
    runs of ``run`` (a multiple of 8; the last run padded with zero taps),
    each 8-tap step's x_lo g_hi + x_hi g_lo + x_hi g_hi (each product exact
    in fp32) summed into the run's fresh fp32 sum, and each run's sum added
    to the running one.  (The tensor core's own sum inside a run truncates
    at its largest addend; fp32 sums stand in for it.)  For the CPU tests
    only."""
    if run % 8 or run <= 0:
        raise ValueError(f"run must be a positive multiple of 8, got {run}")
    W, V = g.shape
    wp = -(-W // run) * run
    xh, xl = tf32_split(x)
    gh, gl = (F.pad(t, (0, 0, 0, wp - W)) for t in tf32_split(g))
    if f_pad == 0:
        return x.new_zeros((x.shape[0], 0, V))
    total = (f_pad - 1) * s + wp

    def windows(t):
        n = t.shape[-1]
        tp = F.pad(t, (pad_left, max(0, total - pad_left - n)))
        return tp[..., :total].unfold(-1, wp, s)

    wh, wl = windows(xh), windows(xl)
    acc = None
    for r0 in range(0, wp, run):
        fresh = None
        for k in range(r0, r0 + run, 8):
            ks = slice(k, k + 8)
            step = ((wl[..., ks] @ gh[ks] + wh[..., ks] @ gl[ks])
                    + wh[..., ks] @ gh[ks])
            fresh = step if fresh is None else fresh + step
        acc = fresh if acc is None else acc + fresh
    return acc


def fir_cat_plain(x: torch.Tensor, g2: torch.Tensor, P: int, s: int,
                  f_pad: int, pad_left: int):
    """Plain torch version of K1: the frames product with G2, split.

    ``x`` (B, n) float32, ``g2`` (W, P+d) float32.  Returns (y0, inj) with
    shapes (B, f_pad, P) and (B, f_pad, d).
    """
    cat = fir_frames_plain(x, g2, s, f_pad, pad_left)     # (B, f_pad, P+d)
    return cat[..., :P].contiguous(), cat[..., P:].contiguous()


def _check_signal(x) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError(f"x must be a float32 tensor, got {getattr(x, 'dtype', type(x))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"x must be (..., n) with n > 0, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _rows(x: torch.Tensor, pad_left: int):
    """(B, n) rows of x and a pad_left >= 0 (a negative one drops leads)."""
    x2 = x.reshape(-1, x.shape[-1])
    if pad_left < 0:
        return x2[:, -pad_left:].contiguous(), 0
    return x2, pad_left


@functools.lru_cache(maxsize=None)
def _scratch_floats(device_index: int, W: int, V: int, s: int) -> int:
    lib = _build.load("fir_cat", _LAUNCHERS)
    with torch.cuda.device(device_index):
        return int(lib.fir_tf32_scratch_floats(W, V, s))


def kernel_route(W: int, V: int, s: int, device=None) -> dict:
    """Which body of ``csrc/fir_cat.cu`` a launch at (W taps, V columns,
    stride s) takes on ``device`` (a card): ``body`` (one of ``BODIES``),
    and for the warpgroup body its column block width ``N``, column blocks
    ``ncb``, span buffers ``nspan`` and shared bytes ``smem``.  The choice
    is by shape only."""
    lib = _build.load("fir_cat", _LAUNCHERS)
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(torch.device("cuda") if device is None else device):
        code = lib.fir_tf32_route(W, V, s, info)
    return {"body": BODIES[code], "code": code, "N": info[0],
            "ncb": info[1], "nspan": info[2], "smem": info[3]}


def _halves(x: torch.Tensor, W: int, V: int, s: int):
    """Scratch for G's TF32 halves, which the launch writes before the
    warpgroup body reads them: (float32 tensor, floats), or (None, 0)
    where the shape takes the mma.sync body."""
    nf = _scratch_floats(x.device.index if x.device.index is not None
                         else torch.cuda.current_device(), W, V, s)
    if nf == 0:
        return None, 0
    return torch.empty(nf, dtype=torch.float32, device=x.device), nf


def _launch(x, g2, y0, inj, n, f_pad, W, V, P, s, pad_left):
    lib = _build.load("fir_cat", _LAUNCHERS)
    planes, nf = _halves(x, W, V, s)
    with torch.cuda.device(x.device):
        err = lib.fir_cat_launch(
            x.data_ptr(), g2.data_ptr(), y0.data_ptr(), inj.data_ptr(),
            0 if planes is None else planes.data_ptr(), nf,
            x.shape[0], n, f_pad, W, V, P, s, pad_left,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "fir_cat_launch")


def polyphase_fir_class_rect_cat(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    w_cat: np.ndarray | None,
    *,
    num_frames: int | None = None,
    pad_left: int | None = None,
    g2: torch.Tensor | None = None,
):
    """SRC with the EQ's weight-concat product folded in -> (y0, inj).

    ``x`` (..., n) float32, contiguous.  ``w_cat`` = [group_fir^T |
    group_in] (P, P+d) float64 (ops/eq.eq_cat_weights); or pass the
    composed operator ``g2`` (W, P+d) float32 on x's device instead.
    Returns y0 (..., F_pad, P) and inj (..., F_pad, d) float32, F_pad as in
    ``frame_grid``.  Frame f reads x_pad[f*s : f*s + W] with x_pad =
    zeros(pad_left) ++ x ++ zeros; ``pad_left`` defaults to -plan.lo and
    ``num_frames`` to ceil(n_out / P) (both as in the JAX signature, for
    shards and streaming).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel;
    anything else raises.
    """
    _check_signal(x)
    lead = x.shape[:-1]
    if pad_left is None:
        pad_left = max(0, -plan.lo)
    x2, pad_left = _rows(x, pad_left)
    n = x2.shape[-1]
    P, s, W = plan.P, plan.s, plan.W
    f_pad = frame_grid(n_out, P, num_frames)
    if g2 is None:
        if w_cat is None:
            raise ValueError("pass w_cat (host fold) or g2 (composed operator)")
        g2 = torch.as_tensor(cat_operator(plan.G, w_cat), device=x.device)
    if (g2.dtype != torch.float32 or g2.device != x.device
            or g2.ndim != 2 or g2.shape[0] != W or g2.shape[1] <= P
            or not g2.is_contiguous()):
        raise ValueError(
            f"g2 must be a contiguous float32 (W={W}, >P={P}) tensor on "
            f"{x.device}, got {g2.dtype} {tuple(g2.shape)} on {g2.device}"
        )
    V = g2.shape[1]
    if x.device.type == "cpu":
        y0, inj = fir_cat_plain(x2, g2, P, s, f_pad, pad_left)
    else:
        B = x2.shape[0]
        y0 = torch.empty((B, f_pad, P), dtype=torch.float32, device=x.device)
        inj = torch.empty((B, f_pad, V - P), dtype=torch.float32,
                          device=x.device)
        _launch(x2, g2, y0, inj, n, f_pad, W, V, P, s, pad_left)
        polyphase_fir_class_rect_cat.launches += 1
    return (y0.reshape(lead + (f_pad, P)),
            inj.reshape(lead + (f_pad, V - P)))


polyphase_fir_class_rect_cat.launches = 0


# ---- the frames FIR (K3, K4, K6, E1; K5 in fir_shear.py) -------------------


def _launch_frames(x, g, y, n, f_out, W, P, s, pad_left):
    lib = _build.load("fir_cat", _LAUNCHERS)
    planes, nf = _halves(x, W, P, s)
    with torch.cuda.device(x.device):
        err = lib.fir_frames_launch(
            x.data_ptr(), g.data_ptr(), y.data_ptr(),
            0 if planes is None else planes.data_ptr(), nf,
            x.shape[0], n, f_out, W, P, s, pad_left,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, err, "fir_frames_launch")


def fir_frames_kernel(x: torch.Tensor, g: torch.Tensor, s: int,
                      num_frames: int, pad_left: int) -> torch.Tensor:
    """y (..., num_frames, P): frame f = x_pad[f*s : f*s + W] @ g.

    The wrapper of the frames kernel that every frames entry point calls.
    ``x`` (..., n) float32 contiguous; ``g`` (W, P) float32 contiguous on
    x's device; x_pad = zeros(pad_left) ++ x ++ zeros (a negative
    ``pad_left`` drops that many leading samples instead).  A CPU tensor
    runs the plain version; a CUDA tensor launches the kernel; anything
    else raises.
    """
    _check_signal(x)
    if (not isinstance(g, torch.Tensor) or g.dtype != torch.float32
            or g.device != x.device or g.ndim != 2 or not g.is_contiguous()):
        raise ValueError(
            f"g must be a contiguous float32 (W, P) tensor on {x.device}, "
            f"got {getattr(g, 'dtype', type(g))} {tuple(getattr(g, 'shape', ()))}"
        )
    if s < 1 or num_frames < 0:
        raise ValueError(f"need s >= 1 and num_frames >= 0, got {s}, {num_frames}")
    lead = x.shape[:-1]
    x2, pad_left = _rows(x, pad_left)
    W, P = g.shape
    if x.device.type == "cpu":
        y = fir_frames_plain(x2, g, s, num_frames, pad_left)
    else:
        B = x2.shape[0]
        y = torch.empty((B, num_frames, P), dtype=torch.float32,
                        device=x.device)
        if B and num_frames:
            _launch_frames(x2, g, y, x2.shape[-1], num_frames, W, P, s,
                           pad_left)
            fir_frames_kernel.launches += 1
    return y.reshape(lead + (num_frames, P))


fir_frames_kernel.launches = 0


def counts_frames_launches(entry):
    """``entry`` (an entry point that runs the frames kernel: K4-K6, E1,
    E3-E5) with a ``launches`` count of its launches of that kernel."""
    @functools.wraps(entry)
    def counted(*args, **kwargs):
        before = fir_frames_kernel.launches
        y = entry(*args, **kwargs)
        counted.launches += fir_frames_kernel.launches - before
        return y

    counted.launches = 0
    return counted


def class_supported(plan: PolyphasePlan) -> bool:
    """The JAX class kernels' envelope (wide stride, one super-group)."""
    return plan.s >= 8 and plan.W <= 128 * plan.s


def rect_supported(plan: PolyphasePlan) -> bool:
    """``class_supported``: the JAX rect kernel's extra row-rectangle test
    is a VMEM fit that the CUDA kernel does not have."""
    return class_supported(plan)


def class_flat_supported(plan: PolyphasePlan) -> bool:
    """The JAX flat class kernel's envelope: every class's 256-wide MXU
    result must stay lane-aligned in its block (kept for the contract)."""
    P = plan.P
    if not class_supported(plan):
        return False
    if P == 128:
        return True
    return P % 16 == 0 and 128 < P <= 128 + math.gcd(P, 128)


def _check_class(plan: PolyphasePlan) -> None:
    if plan.s < 8:
        raise ValueError("class kernels target the wide-stride regime s>=8")
    if plan.W > 128 * plan.s:
        raise ValueError(f"frame width {plan.W} exceeds one super-group "
                         f"{128 * plan.s}")


def _frames(x, plan, f_out, pad_left, g):
    """The frames kernel for a plan: f_out frames, default pad_left/G."""
    if pad_left is None:
        pad_left = max(0, -plan.lo)
    if g is None:
        g = plan_operator(plan, x.device)
    return fir_frames_kernel(x, g, plan.s, f_out, pad_left)


def polyphase_fir_class_rect_frames(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    precision=None,
    pad_frames: bool = False,
    num_frames: int | None = None,
    pad_left: int | None = None,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """Resample (..., N) -> frames (..., ceil(n_out/P), P) (K3).

    frames.reshape(..., -1)[..., :n_out] is ops/src.resample's flat output.
    ``pad_frames=True`` returns F_pad = Kp*128 frames (``frame_grid``; the
    tail frames hold convolution of the zero padding).  ``num_frames``
    overrides ceil(n_out/P) and ``pad_left`` the zero extension -plan.lo,
    for shards whose input carries its halo.  ``g``: the plan's G as a
    float32 tensor on x's device (cached from the plan when omitted).
    Requires s >= 8 and W <= 128*s, as the JAX kernel does.
    """
    _check_class(plan)
    if num_frames is None:
        num_frames = -(-n_out // plan.P)
    f_out = frame_grid(n_out, plan.P, num_frames) if pad_frames else num_frames
    return _frames(x, plan, f_out, pad_left, g)


@counts_frames_launches
def polyphase_fir_class_frames(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    precision=None,
    pad_frames: bool = False,
    num_frames: int | None = None,
    pad_left: int | None = None,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4: the same contract and output as K3 (the TPU's BlockSpec staging
    of the same function); see ``polyphase_fir_class_rect_frames``.
    ``launches`` counts its launches of the frames kernel."""
    return polyphase_fir_class_rect_frames(
        x, plan, n_out, precision=precision, pad_frames=pad_frames,
        num_frames=num_frames, pad_left=pad_left, g=g,
    )


@counts_frames_launches
def polyphase_fir_class_flat(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    precision=None,
    pad_out: bool = False,
    num_frames: int | None = None,
    pad_left: int | None = None,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """Resample (..., N) -> flat (..., n_out) (K6).

    The frames kernel's (F, P) output viewed flat: the same samples as
    K3's frames.reshape(..., -1)[..., :n_out].  ``pad_out=True`` returns
    the whole (..., F_pad*P) buffer.  Requires ``class_flat_supported``.
    ``launches`` counts its launches of the frames kernel.
    """
    if not class_flat_supported(plan):
        raise ValueError("plan geometry unsupported by the flat class kernel")
    P = plan.P
    f_pad = frame_grid(n_out, P, num_frames)
    f_out = f_pad if pad_out else min(f_pad, -(-n_out // P))
    y = _frames(x, plan, f_out, pad_left, g)
    flat = y.reshape(y.shape[:-2] + (f_out * P,))
    return flat if pad_out else flat[..., :n_out]


@counts_frames_launches
def polyphase_fir(
    x: torch.Tensor,
    plan: PolyphasePlan,
    n_out: int,
    *,
    frame_tile: int | None = None,
    g: torch.Tensor | None = None,
) -> torch.Tensor:
    """Resample (..., N) -> (..., n_out) (E1, ``fir_path='pallas'``).

    ceil(n_out/P) frames through the frames kernel, viewed flat and cropped
    to n_out.  ``frame_tile`` is the TPU kernel's frame tile; it is
    accepted and ignored.  ``launches`` counts its launches of the frames
    kernel.
    """
    f_out = -(-n_out // plan.P)
    y = _frames(x, plan, f_out, None, g)
    return y.reshape(y.shape[:-2] + (f_out * plan.P,))[..., :n_out]
