"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports no JAX, so it also runs on a GPU host that
has none:

    python -m pytest tests/test_torch_gpu.py -q --noconftest

Tolerances: > 120 dB for K1 and the frames kernel (3xTF32 tensor-core
products, ~135-140 dB against float64, vs cuBLAS fp32; sums of <= 496
terms in different orders), at the plans 160/147, 441/480, 320/441 and 3/2
and at the edges of the kernel's geometry (batch 1 and 3, 1, 127 and
18,433 frames, pad_left 0 and 500, a view at an odd float offset, a stride
too wide for the span in shared memory, s = 3 through ``pt.resample`` on a
strided view) and at the main path's shapes with the body each takes (the
serving 8 x 60 s, V = 172, the stream's FL 12288 step, a 1x8 shard's row,
batch 1 at an odd n, 160/1001's streamed windows), > 120 dB for K9 (d <= 12
products and one add, in another order) and > 110 dB for K2 (fp32,
different orders; small bins carry the relative error); the cat and frames
chains on the card vs on the CPU (plain versions): > 110 dB for z, y and
the spectra.  K2 complex, K7 and K8 vs their plain versions and float64
numpy: max abs error < 1e-5 * max|X| (fp32 radix FFTs, ~2e-7 against
float64), also at row counts that leave a block part empty, on a view at
an odd float offset, and K2 complex at the STFT's 41344 rows against
torch.fft.rfft.  E6 at every N from 4 to 65536 (the two-pass kernel above
32768): vs its plain version, and vs float64 at >= 135 dB and max abs
error < 1e-5 * max|X|.  The analysis routes each launch their kernel, and
a kernel that cannot be built raises, for every planned rfft size, the
FIR launchers and E6.  Dynamic gains: both dynamic forwards on the card
vs on the CPU, for each builder (> 110 dB; the cat path >= 110 dB against
the frames path), K1 at V = 172 and K9 at d = 12 vs plain (> 120 dB), and
a gain change inside one captured CUDA graph (bit for bit against the
eager call, or >= 130 dB where a captured product takes another cuBLAS
algorithm).  The device gain builder (``kernels/eq_design``: the
design kernel and the expand, a programmatic dependent launch) against
its plain version for five gain sets at five geometries (the slider's U, G, K =
160, 128, 144; no dense carry at K = 1 and K d > 2048), at three and five
bands (d % 4 != 0, the 8-byte stores) and at the edges U = 128 and 256,
G = 1, K = 129: every table within one float32 ulp of its largest
magnitude, two calls bit for bit; a call is those two kernels in the
profiler;
one capture replayed for two gain vectors equal to the eager call, and
one replayed 100 times with alternating vectors, each replay bit for bit
against the eager call; two builders on two streams at once, each equal
to its eager call; ``forward_frames_dynamic`` >= 120 dB against the same
forward on the plain version's operators, and a build failure raises; a
60 s upload at one group a block (K = 18,432) builds bit for bit.  The
state solve (``kernels/group_states``): the zero-seed solve and the entry
kernel against the dense product and the einsum at the main paths' shapes
(the serve cell's, the frames route's column slice, the slider's d = 12, a
stream step, G = 1 at K = 18,432, d = 2) and past one tile of groups, >
120 dB and max abs err <= 1e-5 * max|ref|, two launches bit for bit; the
carry route's ends and solve kernels against the dense product, the
carry's product against ``carry_w`` and the einsum at those shapes that
have a carry triangle, with and without an incoming state, at ragged G,
K = 1 and a carry over many blocks, by ``states_agree``; its two launches
are the cat route's whole solve (no other kernel, no cuBLAS) and replay
from a CUDA graph bit for bit; at config_matrix's P = 1 plans, where the
dense float32 product is itself below 120 dB against float64, >= 100 dB
against the float64 product (``states_agree``); the cat route's solve
captured in a CUDA graph and replayed; a build failure raises.
Streaming: each route of ``ShardedStreamProcessor`` on the
card vs the same processor on the CPU (> 110 dB), its kernels launched and
its step captured once; the graph replay bit for bit against the eager
step; resume bit for bit; ``set_gains`` with no re-capture (> 110 dB vs
the CPU); ``StreamProcessor`` in 100 ms chunks vs the CPU (> 110 dB).
Sharding: ``run_sharded`` (plain, fused, cat) on virtual 1x4 and 2x2
meshes of cuda:0 vs the same mesh on the CPU and vs the card at 1x1 (>
110 dB), a launch a shard; the sharded stream on those meshes: one
capture covering every shard, the replays bit for bit against the eager
step and a resumed checkpoint, > 110 dB against the CPU.  Several cards
(each test decides for itself and skips with fewer than two, or four for
2x2): ``run_sharded`` on each route at 1xN, Nx1 and 2x2 over real cards,
>= 110 dB against the card at 1x1; the stream there (eager steps) >= 110
dB against the one-shot z, resumed bit for bit; ``pod_scaling`` in one
process a card on NCCL (world = device_count, also one).  The surfaces:
the native codec built into ``_build/`` and equal to the numpy codec; the
CLI one-shot at 160/147 on the card (the frames kernel, K9 and K2
launched) within 1 LSB of its ``--device cpu`` run, spectra > 110 dB; the
telephone ``Chain`` on the card vs ``device="cpu"`` > 110 dB.  utils/:
``measure`` gives ``forward_cat`` a positive time; ``measure_device``
reads about its profiled kernel time and refuses a function that syncs;
``profile_device_ops`` lists K1's and K9's kernels and the ``src_eq_cat``
span, and 200 one-call profiles of K7 each hold both kernels; the cat chain's
``roofline_fraction`` lies in (0, 1.05]; a forward with its spans replays
from a CUDA graph bit for bit; the bench's correctness section passes at
8 x 60 s.  The compiled forwards (``AudioPipeline.jit_forward_*``, the
explicit route's ``jit_forward`` too): each replay bit for bit against the
eager forward, held results unchanged by later calls (a second slot, then
a copy), a released slot replayed without a capture; a rate switch A -> B
-> A; one entry at K > 512 IIR blocks (the carry scan); a capture that
fails raises; replayed kernels show in a device profile.
"""
from __future__ import annotations

import functools
import importlib

import numpy as np
import pytest
import torch

import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu_torch.kernels import (
    launch_counts, reset_launch_counts,
)
from dsp_audio_project_tpu_torch.kernels import fir_frames
from dsp_audio_project_tpu_torch.kernels.eq_finish import (
    eq_finish, eq_finish_plain,
)
from dsp_audio_project_tpu_torch.kernels.fir_class import (
    cat_operator, fir_cat_plain, fir_frames_kernel, fir_frames_plain,
    plan_operator, polyphase_fir, polyphase_fir_class_flat,
    polyphase_fir_class_rect_cat,
)
from dsp_audio_project_tpu_torch.kernels import _build
from dsp_audio_project_tpu_torch.kernels import rfft_two_pass as two_pass
from dsp_audio_project_tpu_torch.kernels.rfft import (
    _device_tables, rfft_four_step_complex, rfft_four_step_magnitude,
    rfft_four_step_plain,
)
from dsp_audio_project_tpu_torch.ops.eq import (
    eq_cat_weights, make_block_operators,
)
from dsp_audio_project_tpu_torch.ops.fft import (
    _four_step_kernel_n1, _rfft_kernel_dispatch, _rfft_kernel_plan,
    rfft_magnitude,
)
from dsp_audio_project_tpu_torch.ops.src import make_plan
from dsp_audio_project_tpu_torch.oracle import snr_db
from dsp_audio_project_tpu_torch.utils.profiling import tensors

pytestmark = pytest.mark.gpu

FS = 44100
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def make_x(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal((batch, n))
    return (x / np.abs(x).max()).astype(np.float32)


def host(t):
    return t.cpu().numpy().ravel()


@pytest.mark.parametrize("L,M", [(160, 147), (441, 480), (320, 441), (3, 2)])
def test_fir_cat_kernel_matches_plain(cuda, L, M):
    plan = make_plan(L, M)
    fs_out = pt.SRCConfig(L=L, M=M).output_rate(FS)
    bands = pt.EQConfig.from_gains(GAINS).active_bands(fs_out)
    ops = make_block_operators(bands, fs_out, 1.0, 128 * plan.P, plan.P)
    g2 = torch.as_tensor(cat_operator(plan.G, eq_cat_weights(ops)),
                         device=cuda)
    x = torch.as_tensor(make_x(2, 2 * FS, seed=5), device=cuda)
    n_out = pt.SRCConfig(L=L, M=M).output_length(x.shape[-1])
    before = polyphase_fir_class_rect_cat.launches
    y0, inj = polyphase_fir_class_rect_cat(x, plan, n_out, None, g2=g2)
    assert polyphase_fir_class_rect_cat.launches == before + 1
    y0r, injr = fir_cat_plain(x, g2, plan.P, plan.s, y0.shape[1], -plan.lo)
    torch.cuda.synchronize()
    assert snr_db(host(y0r), host(y0)) > 120
    assert snr_db(host(injr), host(inj)) > 120


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
def test_rfft_kernel_matches_plain(cuda, n):
    n1 = _four_step_kernel_n1(n)
    x = torch.as_tensor(make_x(24, n, seed=n), device=cuda)
    before = rfft_four_step_magnitude.launches
    got = rfft_four_step_magnitude(x, n1=n1)
    assert rfft_four_step_magnitude.launches == before + 1
    ref = rfft_four_step_plain(x, *_device_tables(n, cuda))
    torch.cuda.synchronize()
    assert snr_db(host(ref), host(got)) > 110
    exact = np.abs(np.fft.rfft(x.cpu().double().numpy()))
    assert snr_db(exact.ravel(), host(got)) > 110


def rel_err(want, got) -> float:
    want = np.asarray(want)
    return float(np.abs(want - np.asarray(got)).max() / np.abs(want).max())


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
def test_rfft_complex_kernel_matches_plain(cuda, n):
    n1 = _four_step_kernel_n1(n)
    x = torch.as_tensor(make_x(24, n, seed=n + 1), device=cuda)
    before = rfft_four_step_complex.launches
    got = rfft_four_step_complex(x, n1=n1)
    assert rfft_four_step_complex.launches == before + 1
    ref = rfft_four_step_plain(x, *_device_tables(n, cuda), magnitude=False)
    torch.cuda.synchronize()
    assert got.dtype == torch.complex64 and got.shape == ref.shape
    assert rel_err(ref.cpu().numpy(), got.cpu().numpy()) < 1e-5
    exact = np.fft.rfft(x.cpu().double().numpy())
    assert rel_err(exact, got.cpu().numpy()) < 1e-5


@pytest.mark.parametrize("n", [16384, 32768, 65536, 131072, 262144, 524288,
                               1048576])
def test_two_pass_kernels_match_plain(cuda, n):
    wrapper = (two_pass.rfft_two_level if n == 1048576
               else two_pass.rfft_four_step_tall)
    x = torch.as_tensor(make_x(2, n, seed=n), device=cuda)
    tables = two_pass._device_tables(n, cuda)
    exact = np.fft.rfft(x.cpu().double().numpy())
    for magnitude in (False, True):
        before = wrapper.launches
        got = wrapper(x, magnitude=magnitude)
        assert wrapper.launches == before + 1
        ref = two_pass.rfft_two_pass_plain(x, *tables, magnitude)
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (2, n // 2 + 1)
        assert rel_err(ref.cpu().numpy(), got.cpu().numpy()) < 1e-5
        want = np.abs(exact) if magnitude else exact
        assert rel_err(want, got.cpu().numpy()) < 1e-5


def rfft_wrapper(n, magnitude):
    """The planned kernel's wrapper for N, as a one-argument call."""
    if n <= 8192:
        fn = rfft_four_step_magnitude if magnitude else rfft_four_step_complex
        return fn, lambda x: fn(x, n1=_four_step_kernel_n1(n))
    fn = (two_pass.rfft_two_level if n == 1048576
          else two_pass.rfft_four_step_tall)
    return fn, lambda x: fn(x, magnitude=magnitude)


def check_rfft(x, got, magnitude):
    """got vs the plain version and float64 numpy: max abs error < 1e-5 *
    max|X| for both."""
    n = x.shape[-1]
    plain = (rfft_four_step_plain if n <= 8192
             else two_pass.rfft_two_pass_plain)
    tables = (_device_tables if n <= 8192 else two_pass._device_tables)(
        n, x.device)
    ref = plain(x.reshape(-1, n).contiguous(), *tables, magnitude)
    exact = np.fft.rfft(x.reshape(-1, n).cpu().double().numpy())
    got = got.reshape(-1, n // 2 + 1).cpu().numpy()
    assert rel_err(ref.cpu().numpy(), got) < 1e-5
    assert rel_err(np.abs(exact) if magnitude else exact, got) < 1e-5


@pytest.mark.parametrize("n,rows", [(256, 1), (256, 37), (2048, 1),
                                    (2048, 3), (2048, 24), (2048, 7),
                                    (8192, 3), (16384, 3), (32768, 1),
                                    (65536, 3), (1048576, 1)])
def test_rfft_kernels_at_row_counts(cuda, n, rows):
    """Row counts 1, 3 and 24, and ones that are not a multiple of the rows
    a block holds (32 at N = 256, 4 at 2048), for each planned kernel."""
    x = torch.as_tensor(make_x(rows, n, seed=n + rows), device=cuda)
    for magnitude in (True, False):
        fn, call = rfft_wrapper(n, magnitude)
        before = fn.launches
        got = call(x)
        assert fn.launches == before + 1
        torch.cuda.synchronize()
        assert got.shape == (rows, n // 2 + 1)
        check_rfft(x, got, magnitude)


@pytest.mark.parametrize("n", [256, 2048, 16384, 65536])
def test_rfft_kernels_take_a_view_at_an_odd_offset(cuda, n):
    """A contiguous view that starts one float into its storage (so not
    8-byte aligned) gives the same spectrum."""
    buf = torch.empty(2 * n + 1, device=cuda)
    x = buf[1:].view(2, n)
    x.copy_(torch.as_tensor(make_x(2, n, seed=n), device=cuda))
    assert x.data_ptr() % 8 == 4
    for magnitude in (True, False):
        got = rfft_wrapper(n, magnitude)[1](x)
        torch.cuda.synchronize()
        check_rfft(x, got, magnitude)


def test_k2_complex_at_the_stft_shape(cuda):
    """The STFT's 41344 rows of 2048 against torch.fft.rfft (max abs error
    <= 1e-5 * max|X|)."""
    rng = np.random.default_rng(41344)
    x = torch.as_tensor(rng.standard_normal((41344, 2048)).astype(np.float32),
                        device=cuda)
    got = rfft_four_step_complex(x, n1=16)
    want = torch.fft.rfft(x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= 1e-5, err


def test_unplanned_sizes_run_the_butterfly(cuda):
    for n in (128, 2097152):
        assert _rfft_kernel_plan(n) is None
        x = torch.as_tensor(make_x(1, n, seed=3), device=cuda)
        reset_launch_counts()
        got = rfft_magnitude(x)
        torch.cuda.synchronize()
        assert launch_counts() == dict.fromkeys(launch_counts(), 0)
        exact = np.abs(np.fft.rfft(x.cpu().double().numpy()))
        assert rel_err(exact, got.cpu().numpy()) < 1e-5


def test_planned_sizes_raise_when_the_kernel_cannot_build(cuda, monkeypatch):
    def refuse(name, launchers):
        raise RuntimeError(f"build of {name} refused")

    monkeypatch.setattr(_build, "load", refuse)
    for n in (256, 2048, 8192, 16384, 524288, 1048576):
        x = torch.zeros(2, n, device=cuda)
        for magnitude in (True, False):
            with pytest.raises(RuntimeError, match="refused"):
                _rfft_kernel_dispatch(x, _rfft_kernel_plan(n), magnitude)
        with pytest.raises(RuntimeError, match="refused"):
            rfft_magnitude(x)


def test_fir_and_e6_raise_when_the_kernel_cannot_build(cuda, monkeypatch):
    from dsp_audio_project_tpu_torch.kernels.experiments import rfft_butterfly as rb

    def refuse(name, launchers):
        raise RuntimeError(f"build of {name} refused")

    monkeypatch.setattr(_build, "load", refuse)
    plan = make_plan(160, 147)
    x = torch.zeros(2, 4000, device=cuda)
    with pytest.raises(RuntimeError, match="refused"):
        fir_frames_kernel(x, plan_operator(plan, cuda), plan.s, 8, -plan.lo)
    with pytest.raises(RuntimeError, match="refused"):
        polyphase_fir_class_rect_cat(x, plan, 4354, None,
                                     g2=cat_g2(plan, cuda))
    for n in (4, 2048, 32768):
        with pytest.raises(RuntimeError, match="refused"):
            rb.rfft_butterfly(torch.zeros(2, n, device=cuda))


@pytest.mark.parametrize("route", ["stft", "spectrogram", "with_spectra",
                                   "magnitude_spectrum"])
def test_analysis_routes_launch_their_kernel(cuda, route):
    """Each analysis route on numpy input (so on the card by default)
    launches its kernel, and agrees with the same call on the CPU."""
    x = make_x(2, FS * 3, seed=12)
    if route == "stft":
        name, want = "rfft_four_step_complex", 1

        def fn(**kw):
            return pt.stft(x, nfft=2048, hop=512, **kw)
    elif route == "spectrogram":
        name, want = "rfft_four_step_tall", 1

        def fn(**kw):
            return pt.spectrogram(x, nfft=16384, hop=4096, **kw)
    elif route == "with_spectra":
        name, want = "rfft_four_step_tall", 3
        cfg = pt.PipelineConfig(
            src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
            spectrum=pt.SpectrumConfig(nfft=32768))

        def fn(**kw):
            out = pt.AudioPipeline(cfg, **kw)(x, FS, with_spectra=True)
            return out.spectra["output"][1]
    else:
        name, want = "rfft_two_level", 1
        x = make_x(2, 1 << 20, seed=13)

        def fn(**kw):
            return pt.magnitude_spectrum(
                x, FS, pt.SpectrumConfig(nfft=1 << 20, analysis_limit=0),
                **kw)[1]
    reset_launch_counts()
    got = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts[name] == want, counts
    assert got.device.type == "cuda"
    ref = fn(device="cpu")
    assert rel_err(ref.numpy(), got.cpu().numpy()) < 1e-5


def test_chain_on_card_matches_cpu(cuda):
    x = make_x(2, FS, seed=4)
    cfg = pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(src_fast=True, eq_fast=True),
    )
    cpu = pt.AudioPipeline(cfg, device="cpu")
    z_cpu, m_cpu = cpu.forward_cat_spectra(x, FS)
    pipe = pt.AudioPipeline(cfg, device=cuda)
    reset_launch_counts()
    z, m = pipe.forward_cat_spectra(x, FS)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["polyphase_fir_class_rect_cat"] == 1
    assert counts["eq_finish"] == 1
    assert counts["rfft_four_step_magnitude"] == 1
    assert counts["fir_frames_kernel"] == 0
    assert z.device.type == "cuda"
    assert snr_db(host(z_cpu), host(z)) > 110
    for a, b in zip(m_cpu, m):
        assert snr_db(host(a), host(b)) > 110


@pytest.mark.parametrize("L,M", [(160, 147), (441, 480), (320, 441), (3, 2)])
def test_frames_kernel_matches_plain(cuda, L, M):
    plan = make_plan(L, M)
    g = plan_operator(plan, cuda)
    x = torch.as_tensor(make_x(2, 2 * FS, seed=6), device=cuda)
    n_out = pt.SRCConfig(L=L, M=M).output_length(x.shape[-1])
    f = -(-n_out // plan.P)
    before = fir_frames_kernel.launches
    y = fir_frames_kernel(x, g, plan.s, f, -plan.lo)
    assert fir_frames_kernel.launches == before + 1
    ref = fir_frames_plain(x, g, plan.s, f, -plan.lo)
    torch.cuda.synchronize()
    assert y.shape == ref.shape == (2, f, plan.P)
    assert snr_db(host(ref), host(y)) > 120



def cat_g2(plan, device, d=10):
    """G2 = G @ [I | w] with a seeded (P, d) w: K1's operator shape at any
    plan, including those whose output rate leaves no EQ band active."""
    w = 0.1 * np.random.default_rng(plan.P).standard_normal((plan.P, d))
    return torch.as_tensor(cat_operator(plan.G, np.hstack([np.eye(plan.P), w])),
                           device=device)


# (batch, n, frames, pad_left or None for -plan.lo, float offset of x, L/M)
FIR_EDGES = {
    "batch 1": (1, 20000, None, None, 0, (160, 147)),
    "batch 3": (3, 20000, None, None, 0, (160, 147)),
    "1 frame": (2, 20000, 1, None, 0, (160, 147)),
    "127 frames": (2, 20000, 127, None, 0, (160, 147)),
    "18433 frames": (1, 2 * FS * 30, 18433, None, 0, (160, 147)),
    "pad_left 0": (2, 20000, None, 0, 0, (160, 147)),
    "pad_left 500": (2, 20000, None, 500, 0, (160, 147)),
    "odd float offset": (2, 20000, None, None, 3, (160, 147)),
    "441/480 at an offset": (3, 20000, None, None, 1, (441, 480)),
    "streamed windows (160/1001)": (2, 200000, None, None, 1, (160, 1001)),
}


@pytest.mark.parametrize("case", list(FIR_EDGES))
def test_fir_kernels_at_edge_geometries(cuda, case):
    """Both launchers (frames: G; cat: G2 split into y0 | inj) against their
    plain versions at the edges of the tiling: ragged frame blocks, batch
    rows, zero padding on both sides, x at an address that is not 16-byte
    aligned, and a stride too wide for the span in shared memory (the
    streamed-window path)."""
    batch, n, frames, pad_left, offset, (L, M) = FIR_EDGES[case]
    plan = make_plan(L, M)
    buf = torch.as_tensor(make_x(1, batch * n + offset, seed=len(case))[0],
                          device=cuda)
    x = buf[offset:].view(batch, n)              # contiguous, maybe misaligned
    if frames is None:
        frames = -(-pt.SRCConfig(L=L, M=M).output_length(n) // plan.P)
    if pad_left is None:
        pad_left = -plan.lo
    g = plan_operator(plan, cuda)
    y = fir_frames_kernel(x, g, plan.s, frames, pad_left)
    ref = fir_frames_plain(x, g, plan.s, frames, pad_left)
    torch.cuda.synchronize()
    assert y.shape == ref.shape == (batch, frames, plan.P)
    assert snr_db(host(ref), host(y)) > 120
    g2 = cat_g2(plan, cuda)
    y0, inj = polyphase_fir_class_rect_cat(x, plan, 0, None, g2=g2,
                                           num_frames=frames,
                                           pad_left=pad_left)
    y0r, injr = fir_cat_plain(x, g2, plan.P, plan.s, y0.shape[-2], pad_left)
    torch.cuda.synchronize()
    assert snr_db(host(y0r), host(y0)) > 120
    assert snr_db(host(injr), host(inj)) > 120


# The main path's FIR shapes and the body each must take (kernel_route's
# code: 0 the wgmma body with two span buffers, 3 the mma.sync body's
# streamed windows): (batch, n, frames or None for ceil(n_out / P),
# pad_left or None for -plan.lo, L/M, inj columns d, body).  "shard": an
# interior row of the 1x8 sharded chain at 8 x 60 s, from its shard plan.
FIR_BODY_SHAPES = {
    "serving 8 x 60 s": (8, 60 * FS, None, None, (160, 147), 10, 0),
    "dynamic V = 172": (8, 60 * FS, None, None, (160, 147), 12, 0),
    "stream step FL 12288, pad_left 0": (8, 12288 * 147 + 40, 12288, 0,
                                         (160, 147), 10, 0),
    "1x8 sharded interior row": ("shard", None, None, None, (160, 147), 10, 0),
    "batch 1, odd n": (1, 20001, None, None, (160, 147), 10, 0),
    "streamed windows (160/1001)": (2, 200000, None, None, (160, 1001), 10, 3),
}


@pytest.mark.parametrize("case", list(FIR_BODY_SHAPES))
def test_fir_bodies_at_the_paths_shapes(cuda, case):
    """K1 and the frames kernel at the shapes the main path gives them:
    each takes the body the shape calls for (printed) and holds against
    its plain version at > 120 dB."""
    from dsp_audio_project_tpu_torch.kernels.fir_class import kernel_route
    from dsp_audio_project_tpu_torch.parallel import pipeline as tpipe

    batch, n, frames, pad_left, (L, M), d, code = FIR_BODY_SHAPES[case]
    plan = make_plan(L, M)
    if batch == "shard":
        sp, _ = tpipe._plan_shards(60 * FS, 8, 1, 8, pt.SRCConfig(L=L, M=M),
                                   8192)
        batch, n = 8, sp.halo_left + sp.n_in_local + sp.halo_right
        frames, pad_left = sp.frames_local, -(plan.lo + sp.halo_left)
    if frames is None:
        frames = -(-pt.SRCConfig(L=L, M=M).output_length(n) // plan.P)
    if pad_left is None:
        pad_left = -plan.lo
    x = torch.as_tensor(make_x(batch, n, seed=len(case)), device=cuda)
    g2 = cat_g2(plan, cuda, d)
    for V in (plan.P + d, plan.P):
        route = kernel_route(plan.W, V, plan.s)
        print(f"{case}: V = {V} takes the {route['body']} body")
        assert route["code"] == code, route
    y0, inj = polyphase_fir_class_rect_cat(x, plan, 0, None, g2=g2,
                                           num_frames=frames,
                                           pad_left=pad_left)
    y0r, injr = fir_cat_plain(x, g2, plan.P, plan.s, y0.shape[-2], pad_left)
    g = plan_operator(plan, cuda)
    y = fir_frames_kernel(x, g, plan.s, frames, pad_left)
    ref = fir_frames_plain(x, g, plan.s, frames, pad_left)
    torch.cuda.synchronize()
    assert snr_db(host(y0r), host(y0)) > 120
    assert snr_db(host(injr), host(inj)) > 120
    assert y.shape == ref.shape == (batch, frames, plan.P)
    assert snr_db(host(ref), host(y)) > 120


def test_resample_s3_on_a_strided_view(cuda):
    """s = 3 (10/3) through ``pt.resample``, which makes a strided view
    contiguous before the frames kernel: vs the same call on the CPU."""
    cfg = pt.SRCConfig(L=10, M=3)
    wide = torch.as_tensor(make_x(2, 2 * FS, seed=21), device=cuda)
    x = wide[:, ::2]
    assert not x.is_contiguous()
    before = fir_frames_kernel.launches
    y, fs_out = pt.resample(x, FS, cfg)
    assert fir_frames_kernel.launches == before + 1
    y_cpu, _ = pt.resample(x.cpu(), FS, cfg)
    torch.cuda.synchronize()
    assert fs_out == cfg.output_rate(FS) and y.shape == y_cpu.shape
    assert snr_db(host(y_cpu), host(y)) > 120

def test_frames_routes_launch_the_kernel(cuda):
    plan = make_plan(160, 147)
    x = torch.as_tensor(make_x(2, FS // 4, seed=8), device=cuda)
    n_out = pt.SRCConfig(L=160, M=147).output_length(x.shape[-1])
    want = fir_frames_plain(x, plan_operator(plan, cuda), plan.s,
                            -(-n_out // plan.P), -plan.lo)
    want_flat = want.reshape(2, -1)[:, :n_out]
    for route in ("rect", "class", "shear", "flat", "pallas"):
        before = fir_frames_kernel.launches
        if route == "flat":
            got = polyphase_fir_class_flat(x, plan, n_out)
            ref = want_flat
        elif route == "pallas":
            got = polyphase_fir(x, plan, n_out)
            ref = want_flat
        else:
            got = fir_frames(x, plan, n_out, kernel=route)
            ref = want
        assert fir_frames_kernel.launches == before + 1, route
        torch.cuda.synchronize()
        assert snr_db(host(ref), host(got)) > 120, route


@pytest.mark.parametrize("U,d,ldy", [(160, 10, 160), (160, 10, 172),
                                     (441, 10, 441), (128, 12, 140),
                                     (3, 2, 7)])
def test_eq_finish_kernel_matches_plain(cuda, U, d, ldy):
    rng = np.random.default_rng(U + ldy)
    wide = torch.as_tensor(
        (0.6 * rng.standard_normal((2, 300, ldy))).astype(np.float32),
        device=cuda)
    y0 = wide[..., :U]                      # a column slice when ldy > U
    st = torch.as_tensor(rng.standard_normal((2, 300, d)).astype(np.float32),
                         device=cuda)
    gout = torch.as_tensor(
        (0.2 * rng.standard_normal((d, U))).astype(np.float32), device=cuda)
    before = eq_finish.launches
    z = eq_finish(y0, st, gout)
    assert eq_finish.launches == before + 1
    ref = eq_finish_plain(y0, st, gout)
    torch.cuda.synchronize()
    assert z.shape == ref.shape and z.is_contiguous()
    assert snr_db(host(ref), host(z)) > 120
    assert float((z - ref).abs().max()) <= 1e-6


def test_frames_chain_on_card_matches_cpu(cuda):
    x = make_x(2, FS, seed=9)
    cfg = pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
    )
    out_cpu = pt.AudioPipeline(cfg, device="cpu")(x, FS, with_spectra=True)
    pipe = pt.AudioPipeline(cfg)            # the card by default
    assert pipe.device.type == "cuda"
    reset_launch_counts()
    out = pipe(x, FS, with_spectra=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fir_frames_kernel"] == 1
    assert counts["eq_finish"] == 1
    assert counts["rfft_four_step_magnitude"] == 3
    assert counts["polyphase_fir_class_rect_cat"] == 0
    for a, b in ((out_cpu.output, out.output),
                 (out_cpu.resampled, out.resampled)):
        assert b.device.type == "cuda"
        assert snr_db(host(a), host(b)) > 110
    for k in ("input", "resampled", "output"):
        assert snr_db(host(out_cpu.spectra[k][1]),
                      host(out.spectra[k][1])) > 110
    zf_cpu, _ = pt.AudioPipeline(cfg, device="cpu").forward_flat(x, FS)
    zf, _ = pipe.forward_flat(x, FS)
    assert snr_db(host(zf_cpu), host(zf)) > 110


# ---- E2-E7 (kernels/experiments) --------------------------------------------


def block_ops(gains, block, unroll=16, fs=48000):
    cfg = pt.EQConfig.from_gains(gains)
    return make_block_operators(cfg.active_bands(fs), fs, cfg.q, block,
                                unroll), cfg


@pytest.mark.parametrize("gains,K,block", [
    (GAINS, 37, 128),             # d = 10, a ragged K, the 16-byte path
    ({"Bass": 5}, 5, 130),        # d = 2, B % 4 != 0: the scalar path
    ({**GAINS, "Low Mids": 2}, 9, 256),   # d = 12, all six bands
])
def test_iir_block_kernels_match_plain(cuda, gains, K, block):
    """E2a and E2b vs their plain versions: > 110 dB and max abs error
    <= 1e-5 * max|ref| (float32 steps summed in another order)."""
    from dsp_audio_project_tpu_torch.kernels.experiments import iir

    ops, _ = block_ops(gains, block)
    xb = torch.as_tensor(make_x(2, K * block, seed=K).reshape(2, K, block),
                         device=cuda)
    consts = iir.device_tables(iir._plain_consts, ops, device=cuda)
    before = (iir.block_end_states.launches, iir.block_apply.launches)
    e = iir.block_end_states(xb, ops)
    e_ref = iir.block_end_states_plain(xb, *consts[:2])
    sigma = torch.as_tensor(
        np.random.default_rng(K).standard_normal(e.shape).astype(np.float32),
        device=cuda)
    y = iir.block_apply(xb, sigma, ops)
    y_ref = iir.block_apply_plain(xb, sigma, *consts)
    torch.cuda.synchronize()
    assert (iir.block_end_states.launches, iir.block_apply.launches) == (
        before[0] + 1, before[1] + 1)
    for got, ref in ((e, e_ref), (y, y_ref)):
        assert got.shape == ref.shape
        assert snr_db(host(ref), host(got)) > 110
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_equalize_pallas_on_card_matches_cpu(cuda):
    from dsp_audio_project_tpu_torch.ops.eq import equalize_pallas

    cfg = pt.EQConfig.from_gains(GAINS)
    x = make_x(2, 20000, seed=14)
    reset_launch_counts()
    z = equalize_pallas(x, 48000, cfg, block=1024)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["block_end_states"] == counts["block_apply"] == 1
    assert z.device.type == "cuda"
    ref = equalize_pallas(x, 48000, cfg, block=1024, device="cpu")
    assert snr_db(host(ref), host(z)) > 110


@pytest.mark.parametrize("block,unroll,sb,rows", [(1024, 64, 2, 3),
                                                  (8192, 128, 10, 2)])
def test_iir_seq_kernel_matches_plain(cuda, block, unroll, sb, rows):
    """E7 vs its plain version, at a small block and at the serving tables
    (block 8192, unroll 128; the kernel groups at 128): > 110 dB."""
    from dsp_audio_project_tpu_torch.kernels.experiments import iir_seq

    ops, _ = block_ops(GAINS, block, unroll)
    x = torch.as_tensor(make_x(rows, 2 * sb * block, seed=block), device=cuda)
    before = iir_seq.equalize_seq_flat.launches
    y = iir_seq.equalize_seq_flat(x, ops, super_blocks=sb)
    assert iir_seq.equalize_seq_flat.launches == before + 1
    tables = iir_seq.device_tables(iir_seq._seq_tables, ops, device=cuda)
    ref = iir_seq.equalize_seq_plain(
        x.reshape(rows, -1, block // unroll, unroll), *tables)
    torch.cuda.synchronize()
    assert snr_db(host(ref), host(y)) > 110


def _seq_plain(x, ops, block, unroll, cuda):
    from dsp_audio_project_tpu_torch.kernels.experiments import iir_seq

    tables = iir_seq.device_tables(iir_seq._seq_tables, ops, device=cuda)
    return iir_seq.equalize_seq_plain(
        x.reshape(x.shape[0], -1, block // unroll, unroll), *tables).reshape(
            x.shape)


@pytest.mark.parametrize("rows,K", [(1, 1), (1, 15), (8, 3), (8, 360),
                                    (33, 17), (33, 100)])
def test_iir_seq_lookback_across_waves(cuda, rows, K):
    """E7 at block 1024 with 1, 8 and 33 rows and K from 1 to 360: the
    look-back's window edge (k < W), and tiles spread over many waves of
    the persistent grid.  > 120 dB and max abs error <= 1e-5 * max|ref|
    against the plain version."""
    from dsp_audio_project_tpu_torch.kernels.experiments import iir_seq

    block, unroll = 1024, 64
    ops, _ = block_ops(GAINS, block, unroll)
    x = torch.as_tensor(make_x(rows, K * block, seed=rows * 1000 + K),
                        device=cuda)
    y = iir_seq.equalize_seq_flat(x, ops, super_blocks=1)
    ref = _seq_plain(x, ops, block, unroll, cuda)
    torch.cuda.synchronize()
    assert snr_db(host(ref), host(y)) > 120
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_iir_seq_is_bitwise_repeatable(cuda):
    """Two runs of E7 on one input are bitwise equal: the look-back sums a
    fixed window, the same terms in the same order whatever the timing."""
    from dsp_audio_project_tpu_torch.kernels.experiments import iir_seq

    block, unroll = 8192, 128
    ops, _ = block_ops(GAINS, block, unroll)
    x = torch.as_tensor(make_x(8, 40 * block, seed=3), device=cuda)
    first = iir_seq.equalize_seq_flat(x, ops, super_blocks=10)
    for _ in range(3):
        assert torch.equal(iir_seq.equalize_seq_flat(x, ops, super_blocks=10),
                           first)


@pytest.mark.parametrize("n,offset", [(20000, 0), (12345, 3), (8192, 1)])
def test_equalize_pallas_on_strided_rows(cuda, n, offset):
    """``equalize_pallas`` on a row view at an odd offset and lengths
    that are not multiples of the block or of 4: E2a and E2b read zeros
    past n and write the clipped output cropped to n (no pad or clip
    pass); > 110 dB against the CPU, |z| <= 1."""
    from dsp_audio_project_tpu_torch.ops.eq import equalize_pallas

    cfg = pt.EQConfig.from_gains(GAINS)
    big = torch.as_tensor(1.3 * make_x(3, n + 8, seed=n), device=cuda)
    x = big[:, offset:offset + n]
    reset_launch_counts()
    z = equalize_pallas(x, 48000, cfg, block=1024)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["block_end_states"] == counts["block_apply"] == 1
    ref = equalize_pallas(x.cpu(), 48000, cfg, block=1024)
    assert z.shape == (3, n)
    assert snr_db(host(ref), host(z)) > 110
    assert float(z.abs().max()) <= 1.0


@pytest.mark.parametrize("n", [1 << k for k in range(2, 17)])
def test_rfft_butterfly_matches_plain(cuda, n):
    """E6 vs its plain version and float64 numpy: max abs error < 1e-5 *
    max|X| and >= 135 dB against float64; above N = 32768 the two-pass
    kernel (K7) runs instead."""
    from dsp_audio_project_tpu_torch.kernels.experiments import rfft_butterfly as rb

    x = torch.as_tensor(make_x(3, n, seed=n), device=cuda)
    reset_launch_counts()
    got = rb.rfft_butterfly(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    if n > rb.MAX_N:
        assert counts["rfft_butterfly"] == 0
        assert counts["rfft_four_step_tall"] == 1
    else:
        assert counts["rfft_butterfly"] == 1
        ref = rb.rfft_butterfly_plain(x, *rb.radix_device_tables(n, cuda))
        assert rel_err(ref.cpu().numpy(), got.cpu().numpy()) < 1e-5
    assert got.dtype == torch.complex64 and got.shape == (3, n // 2 + 1)
    exact = np.fft.rfft(x.cpu().double().numpy())
    assert rel_err(exact, got.cpu().numpy()) < 1e-5
    as_real = torch.view_as_real(got.cpu()).numpy().ravel()
    assert snr_db(np.stack([exact.real, exact.imag], -1).ravel(), as_real) >= 135


def test_fir_experiments_launch_the_frames_kernel(cuda):
    from dsp_audio_project_tpu_torch.kernels.experiments import (
        polyphase_fir_dma, polyphase_fir_rect_rowdma,
        polyphase_fir_rect_splitbank,
    )

    plan = make_plan(160, 147)
    x = torch.as_tensor(make_x(2, FS // 4, seed=15), device=cuda)
    n_out = pt.SRCConfig(L=160, M=147).output_length(x.shape[-1])
    want = fir_frames_plain(x, plan_operator(plan, cuda), plan.s,
                            -(-n_out // plan.P), -plan.lo)
    for fn, ref in ((polyphase_fir_dma, want.reshape(2, -1)[:, :n_out]),
                    (polyphase_fir_rect_splitbank, want),
                    (polyphase_fir_rect_rowdma, want)):
        reset_launch_counts()
        got = fn(x, plan, n_out)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts[fn.__name__] == counts["fir_frames_kernel"] == 1
        assert snr_db(host(ref), host(got)) > 120, fn.__name__


def test_explicit_pipeline_on_card_matches_cpu(cuda):
    """fir_path='pallas', iir_path='pallas' at the default block 8192:
    the frames kernel (E1), E2a, E2b and K2 launch; z, y and the spectra
    > 110 dB against the same call on the CPU."""
    x = make_x(2, FS, seed=16)
    cfg = pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(fir_path="pallas", iir_path="pallas"))
    out_cpu = pt.AudioPipeline(cfg, device="cpu")(x, FS, with_spectra=True)
    reset_launch_counts()
    out = pt.AudioPipeline(cfg)(x, FS, with_spectra=True)
    torch.cuda.synchronize()
    counts = launch_counts()
    for name, want in (("fir_frames_kernel", 1), ("block_end_states", 1),
                       ("block_apply", 1), ("rfft_four_step_magnitude", 3)):
        assert counts[name] == want, counts
    for a, b in ((out_cpu.output, out.output),
                 (out_cpu.resampled, out.resampled),
                 *((out_cpu.spectra[k][1], out.spectra[k][1])
                   for k in ("input", "resampled", "output"))):
        assert snr_db(host(a), host(b)) > 110


# ---- dynamic gains (ops/eq_dynamic.py) -------------------------------------

DYN_GAINS = ((6.0, -3.0, 0.0, 12.0, -15.0, 4.0),
             (-15.0, -14.0, -13.0, -12.5, -3.0, 0.0))


def dyn_pipe(device=None):
    return pt.AudioPipeline(pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig()), device=device)


@pytest.mark.parametrize("builder", ["host", "traced"])
def test_dynamic_forwards_on_card_match_cpu(cuda, builder):
    """forward_cat_dynamic_ops launches K1 and K9, forward_frames_dynamic_ops
    the frames kernel and K9; both > 110 dB against the same forwards on a
    CPU copy, for each builder, and the cat path >= 110 dB against the
    frames path."""
    x = make_x(2, FS // 2, seed=21)
    n = x.shape[-1]
    pipe, cpu = dyn_pipe(), dyn_pipe("cpu")
    for gains in DYN_GAINS:
        g = torch.tensor(gains) if builder == "traced" else np.asarray(gains)
        ops = pipe.dynamic_eq_operators(g, FS, n, builder=builder)
        ops_c = cpu.dynamic_eq_operators(g, FS, n, builder=builder)
        assert ops.toe.device.type == "cuda"
        reset_launch_counts()
        zc = pipe.forward_cat_dynamic_ops(x, ops, pipe.dynamic_cat_tables(ops),
                                          FS)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["polyphase_fir_class_rect_cat"] == 1
        assert counts["eq_finish"] == 1
        reset_launch_counts()
        zf, yf = pipe.forward_frames_dynamic_ops(x, ops, FS)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["fir_frames_kernel"] == 1 and counts["eq_finish"] == 1
        zc_c = cpu.forward_cat_dynamic_ops(
            torch.as_tensor(x), ops_c, cpu.dynamic_cat_tables(ops_c), FS)
        zf_c, yf_c = cpu.forward_frames_dynamic_ops(torch.as_tensor(x), ops_c,
                                                    FS)
        for a, b in ((zc_c, zc), (zf_c, zf), (yf_c, yf)):
            assert snr_db(host(a), host(b)) > 110
        assert snr_db(host(zf), host(zc)) >= 110


def test_fir_cat_and_eq_finish_at_dynamic_widths(cuda):
    """K1 at V = P + 12 = 172 and K9 at d = 12 (the dynamic path's six
    bands) against their plain versions: > 120 dB."""
    pipe = dyn_pipe()
    plan = make_plan(160, 147)
    x = torch.as_tensor(make_x(3, FS, seed=22), device=cuda)
    n_out = pt.SRCConfig(L=160, M=147).output_length(x.shape[-1])
    ops = pipe.dynamic_eq_operators(torch.tensor(DYN_GAINS[0]), FS,
                                    x.shape[-1])
    g2 = pipe.dynamic_cat_tables(ops).g2
    assert g2.shape == (plan.W, 172)
    y0, inj = polyphase_fir_class_rect_cat(x, plan, n_out, None, g2=g2)
    y0r, injr = fir_cat_plain(x, g2, plan.P, plan.s, y0.shape[1], -plan.lo)
    torch.cuda.synchronize()
    assert inj.shape[-1] == 12
    assert snr_db(host(y0r), host(y0)) > 120
    assert snr_db(host(injr), host(inj)) > 120
    rng = np.random.default_rng(23)
    st = torch.as_tensor(rng.standard_normal(y0.shape[:-1] + (12,)).astype(
        np.float32), device=cuda)
    z = eq_finish(y0, st, ops.group_out)
    ref = eq_finish_plain(y0, st, ops.group_out)
    torch.cuda.synchronize()
    assert snr_db(host(ref), host(z)) > 120


def test_gain_change_in_cuda_graphs(cuda):
    """Two captured graphs: (a) the gain change, the device builder and the
    cat table from a gains buffer; (b) the cat forward on an input buffer.
    Replayed with g1, then with g2 copied into the buffer: each output
    equals the eager call bit for bit (or >= 130 dB where a captured
    product took another cuBLAS algorithm), agrees with the CPU (> 110 dB),
    and no host design or table cache moves between the replays."""
    from dsp_audio_project_tpu_torch.ops import eq as teq

    pipe, cpu = dyn_pipe(), dyn_pipe("cpu")
    x = torch.as_tensor(make_x(2, FS // 2, seed=24), device=cuda)
    n = x.shape[-1]
    gains = torch.tensor(DYN_GAINS[0], device=cuda)

    def change():
        ops = pipe.dynamic_eq_operators(gains, FS, n)
        return ops, pipe.dynamic_cat_tables(ops)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):                  # builds, attributes, geometry
            ops, tabs = change()
            pipe.forward_cat_dynamic_ops(x, ops, tabs, FS)
    torch.cuda.current_stream().wait_stream(side)
    graph_a, graph_b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph_a):
        ops_s, tabs_s = change()
    reset_launch_counts()
    with torch.cuda.graph(graph_b):
        z_s = pipe.forward_cat_dynamic_ops(x, ops_s, tabs_s, FS)
    counts = launch_counts()
    assert counts["polyphase_fir_class_rect_cat"] == 1
    assert counts["eq_finish"] == 1
    caches = (teq.make_block_operators.cache_info(), len(teq._device_tables))
    for g in DYN_GAINS:
        gains.copy_(torch.tensor(g))
        graph_a.replay()
        graph_b.replay()
        torch.cuda.synchronize()
        got = z_s.clone()
        ops, tabs = change()
        eager = pipe.forward_cat_dynamic_ops(x, ops, tabs, FS)
        torch.cuda.synchronize()
        assert torch.equal(got, eager) or snr_db(host(eager), host(got)) >= 130
        ops_c = cpu.dynamic_eq_operators(torch.tensor(g), FS, n)
        want = cpu.forward_cat_dynamic_ops(x.cpu(), ops_c,
                                           cpu.dynamic_cat_tables(ops_c), FS)
        assert snr_db(host(want), host(got)) > 110
    assert caches == (teq.make_block_operators.cache_info(),
                      len(teq._device_tables))


# ---- the device gain builder (kernels/eq_design.py) ------------------------

# tests/test_torch_eq_dynamic.py's gain sets: complex poles, all +15,
# real poles, all zero, below the 0.1 dB threshold.
DESIGN_GAINS = ((6.0, -3.0, 0.0, 12.0, -15.0, 4.0), (15.0,) * 6,
                (-15.0, -14.0, -13.0, -12.5, -3.0, 0.0), (0.0,) * 6,
                (0.05, -0.05, 0.0, 0.0, 0.0, 0.0))
# (U, G, K): the slider's 60 s at 160/147; a small one; 441/480's unroll
# (nine heads of A); no dense carry (K = 1, and K d > 2048).
DESIGN_GEOMETRIES = ((160, 128, 144), (160, 16, 4), (441, 32, 40),
                     (32, 8, 1), (32, 8, 171))


def design_inputs(gains, device, fs=48000):
    """The first len(gains) of the six bands' inputs."""
    from dsp_audio_project_tpu_torch.ops.eq_dynamic import _band_trig
    from dsp_audio_project_tpu_torch.utils.device import device_tables

    cfg = pt.EQConfig()
    centers = tuple(cfg.band_centers[:len(gains)])
    sin_w0, cos_w0 = device_tables(_band_trig, fs, centers,
                                   cfg.nyquist_safety, device=device)
    g = torch.tensor(gains, dtype=torch.float32, device=device)
    return g, sin_w0, cos_w0, cfg.q, cfg.bypass_threshold_db


@pytest.mark.parametrize("geometry", DESIGN_GEOMETRIES)
@pytest.mark.parametrize("gains", DESIGN_GAINS)
def test_eq_design_kernel_matches_plain(cuda, gains, geometry):
    """One call counted a call: every table within one float32 ulp of the
    plain table's largest magnitude (both in float64, summed in other
    orders), carry_w None where the plain version has none, and a second
    call bit for bit."""
    assert_design_matches_plain(design_inputs(gains, cuda) + geometry)


def assert_design_matches_plain(args):
    from dsp_audio_project_tpu_torch.kernels.eq_design import (
        dynamic_operators_plain, eq_design, ulp_error,
    )

    before = eq_design.launches
    got = eq_design(*args)
    again = eq_design(*args)
    want = dynamic_operators_plain(*args)
    torch.cuda.synchronize()
    assert eq_design.launches == before + 2
    for a, b, c in zip(got, want, again):
        if b is None:
            assert a is None and c is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        assert ulp_error(a, b) <= 1.0
        assert torch.equal(a, c)


# Three and five bands (d = 6, 10: d % 4 != 0, the 8-byte expand and zero
# stores) and the power-of-two edges: U = 128 and 256 (A's chain ends on a
# head), G = 1, K = 129 (R's largest exponent one bit past K = 128).
@pytest.mark.parametrize("gains,geometry", [
    ((6.0, -3.0, 12.0), (160, 128, 144)),
    ((-15.0, 9.0, 0.05), (160, 16, 129)),
    ((6.0, -3.0, 0.0, 12.0, -15.0), (160, 128, 144)),
    ((15.0, -14.0, 3.0, -12.5, 1.0), (441, 32, 40)),
    (DESIGN_GAINS[0], (128, 64, 4)),
    (DESIGN_GAINS[2], (256, 16, 8)),
    (DESIGN_GAINS[0], (160, 1, 144)),
    (DESIGN_GAINS[1], (160, 128, 129)),
])
def test_eq_design_kernel_matches_plain_at_the_edges(cuda, gains, geometry):
    assert_design_matches_plain(design_inputs(gains, cuda) + geometry)


def test_eq_design_is_two_kernels(cuda):
    """One call is the design kernel and the expand, one launch each as
    the launcher reports; each name carries f64.  The call is profiled in
    a child process: a profiler session in this one makes the later
    profiler tests lose records."""
    import json
    import pathlib
    import subprocess
    import sys
    import textwrap

    from dsp_audio_project_tpu_torch.kernels.eq_design import (
        cuda_layout, launch_grid,
    )

    child = textwrap.dedent("""
        import json, torch
        from torch.profiler import ProfilerActivity, profile
        import dsp_audio_project_tpu_torch as pt
        from dsp_audio_project_tpu_torch.kernels.eq_design import eq_design
        from dsp_audio_project_tpu_torch.ops.eq_dynamic import _band_trig
        from dsp_audio_project_tpu_torch.utils.deviceprof import device_rows
        cfg = pt.EQConfig()
        s, c = _band_trig(48000, cfg.band_centers, cfg.nyquist_safety)
        args = (torch.tensor([6.0, -3.0, 0.0, 12.0, -15.0, 4.0],
                             device="cuda"),
                torch.as_tensor(s, device="cuda"),
                torch.as_tensor(c, device="cuda"), cfg.q,
                cfg.bypass_threshold_db, 160, 128, 144)
        eq_design(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eq_design(*args)
            torch.cuda.synchronize()
        print(json.dumps([(name, count) for name, _, count
                          in device_rows(prof.key_averages())]))
    """)
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", child], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(rows) == 2, rows
    assert all("f64" in name and count == 1 for name, count in rows), rows
    names = " ".join(name for name, _ in rows)
    assert "eq_design_f64_kernel" in names and "eq_expand_f64_kernel" in names
    grid = launch_grid(6, 160, 128, 144)
    lay = cuda_layout(6, 160, 128, 144)
    assert grid["launches"] == 2 == lay["launches"]
    assert grid["power_blocks"] == lay["power_blocks"]
    assert grid["blocks"] > grid["power_blocks"]


def test_eq_design_in_a_cuda_graph(cuda):
    """One captured call replayed for two gain vectors copied into its
    buffer: each replay equal to the eager call bit for bit."""
    from dsp_audio_project_tpu_torch.kernels.eq_design import eq_design

    g, sin_w0, cos_w0, q, thr = design_inputs(DESIGN_GAINS[0], cuda)
    geometry = (160, 128, 144)

    def build():
        return eq_design(g, sin_w0, cos_w0, q, thr, *geometry)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        build()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = build()
    for gains in DESIGN_GAINS[1:3]:
        g.copy_(torch.tensor(gains))
        graph.replay()
        torch.cuda.synchronize()
        got = [t.clone() for t in outs]
        for a, b in zip(got, build()):
            assert torch.equal(a, b)


def test_eq_design_graph_replayed_100_times(cuda):
    """One captured call replayed 100 times, the gain vector alternating
    between two sets copied into its buffer: each replay bit for bit
    against the eager call for its vector."""
    from dsp_audio_project_tpu_torch.kernels.eq_design import eq_design

    g, sin_w0, cos_w0, q, thr = design_inputs(DESIGN_GAINS[0], cuda)
    geometry = (160, 128, 144)

    def build(gains):
        return eq_design(gains, sin_w0, cos_w0, q, thr, *geometry)

    vectors = (DESIGN_GAINS[0], DESIGN_GAINS[2])
    eager = [[t.clone() for t in build(torch.tensor(v, device=cuda))
              if t is not None] for v in vectors]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        build(g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [t for t in build(g) if t is not None]
    for i in range(100):
        g.copy_(torch.tensor(vectors[i % 2]))
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, eager[i % 2]):
            assert torch.equal(a, b), i


def test_eq_design_on_two_streams_at_once(cuda):
    """Two builders for two gain vectors enqueued on two streams with no
    order between them: each equal to its eager call bit for bit (they
    share no scratch, flag or table)."""
    from dsp_audio_project_tpu_torch.kernels.eq_design import eq_design

    geometry = (160, 128, 144)
    args = [design_inputs(v, cuda) for v in (DESIGN_GAINS[0],
                                              DESIGN_GAINS[1])]
    eager = [[t.clone() for t in eq_design(*a, *geometry) if t is not None]
             for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [None, None]
    for _ in range(3):
        start = torch.cuda.Event()
        start.record()
        for i, st in enumerate(streams):
            st.wait_event(start)
            with torch.cuda.stream(st):
                got[i] = [t for t in eq_design(*args[i], *geometry)
                          if t is not None]
        torch.cuda.synchronize()
        for outs, want in zip(got, eager):
            for a, b in zip(outs, want):
                assert torch.equal(a, b)


def test_forward_frames_dynamic_on_the_kernels_matches_plain_builder(cuda):
    """forward_frames_dynamic (the kernels build its operators) against
    the same forward on operators from the plain version: z >= 120 dB."""
    from dsp_audio_project_tpu_torch.kernels.eq_design import (
        dynamic_operators_plain, eq_design,
    )
    from dsp_audio_project_tpu_torch.ops.eq_dynamic import DynOperators

    pipe = dyn_pipe()
    x = torch.as_tensor(make_x(2, 3 * FS, seed=25), device=cuda)
    U, G, K = pipe.dynamic_eq_geometry(FS, x.shape[-1])
    for gains in DESIGN_GAINS:
        g, sin_w0, cos_w0, q, thr = design_inputs(gains, cuda)
        before = eq_design.launches
        z, _ = pipe.forward_frames_dynamic(x, g, FS)
        assert eq_design.launches == before + 1
        ops = DynOperators(*dynamic_operators_plain(g, sin_w0, cos_w0, q, thr,
                                                    U, G, K))
        want, _ = pipe.forward_frames_dynamic_ops(x, ops, FS)
        torch.cuda.synchronize()
        assert snr_db(host(want), host(z)) >= 120


def test_eq_design_raises_when_the_kernel_cannot_build(cuda, monkeypatch):
    from dsp_audio_project_tpu_torch.kernels.eq_design import eq_design

    def refuse(name, launchers):
        raise RuntimeError(f"build of {name} refused")

    monkeypatch.setattr(_build, "load", refuse)
    with pytest.raises(RuntimeError, match="refused"):
        eq_design(*design_inputs(DESIGN_GAINS[0], cuda), 160, 16, 4)
    with pytest.raises(ValueError, match="bands"):
        eq_design(torch.zeros(9, device=cuda),
                  torch.zeros(9, dtype=torch.float64, device=cuda),
                  torch.zeros(9, dtype=torch.float64, device=cuda),
                  1.0, 0.1, 160, 16, 4)


# ---- the state solve (kernels/group_states.py) -----------------------------

# The shapes the main paths give the state solve: (batch, K, G, d) and the
# table's source.
STATE_SHAPES = {
    "serve": ((8, 144, 128, 10), "static"),
    "slider": ((1, 144, 128, 12), "dynamic"),
    "stream step": ((8, 96, 128, 10), "static"),
    "one group a block": ((1, 18432, 1, 12), "dynamic"),
    "one band": ((2, 16, 128, 2), "one band"),
    "column slice": ((8, 144, 128, 10), "strided"),
}


def state_case(name, device):
    """(inj, toe, A^block) for a ``STATE_SHAPES`` entry: seeded normal
    injections, the port's own tables."""
    from dsp_audio_project_tpu_torch.ops.eq import block_tables

    (B, K, G, d), source = STATE_SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    fs_out = 48000
    if source == "dynamic":
        ops = pt.build_dynamic_operators(
            torch.tensor(DYN_GAINS[0], device=device), fs_out, pt.EQConfig(),
            160, G)
        toe, a_blk = ops.toe, ops.A_blk
    else:
        gains = {"Bass": 6} if source == "one band" else GAINS
        cfg = pt.EQConfig.from_gains(gains)
        ops = make_block_operators(cfg.active_bands(fs_out), fs_out, cfg.q,
                                   G * 160, 160)
        t = block_tables(ops, device, K)
        toe, a_blk = t["group_toeplitz"], t["state_corr"]
    width = 172 if source == "strided" else d
    inj = torch.as_tensor(rng.standard_normal((B, K, G, width)).astype(
        np.float32), device=device)
    if source == "strided":
        inj = inj[..., 160:160 + d]
    return inj, toe, a_blk


def _band_trig_tables(cfg, fs):
    from dsp_audio_project_tpu_torch.ops.eq_dynamic import _band_trig

    return _band_trig(fs, cfg.band_centers, cfg.nyquist_safety)


def hold_states(got, ref):
    """> 120 dB and max abs err <= 1e-5 * max|ref|, or equal where the
    reference is all zeros (s_in at G = 1)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    top = float(ref.abs().max())
    if top == 0.0:
        assert torch.equal(got, ref)
        return
    assert snr_db(host(ref), host(got)) > 120
    assert float((got - ref).abs().max()) <= 1e-5 * top


@pytest.mark.parametrize("name", list(STATE_SHAPES))
def test_group_states_kernel_matches_plain(cuda, name):
    """The scan and its entry mode, one launch each counted, against the
    dense product and the einsum; a second launch bit for bit."""
    from dsp_audio_project_tpu_torch.kernels.group_states import (
        group_entry_states_plain, group_states_plain,
    )
    from dsp_audio_project_tpu_torch.ops.eq import _carry_states

    inj, toe, a_blk = state_case(name, cuda)
    reset_launch_counts()
    s_in, end = pt.kernels.group_states(inj, toe)
    again = pt.kernels.group_states(inj, toe)
    ref_in, ref_end = group_states_plain(inj, toe)
    sigma = _carry_states(ref_end, a_blk)
    s_true = pt.kernels.group_entry_states(ref_in, sigma, toe)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["group_states"] == 2 and counts["group_entry_states"] == 1
    hold_states(s_in, ref_in)
    hold_states(end, ref_end)
    hold_states(s_true, group_entry_states_plain(ref_in, sigma, toe))
    assert torch.equal(s_in, again[0]) and torch.equal(end, again[1])


def test_group_states_ragged_tiles(cuda):
    """G past one tile of 128 groups, and not a multiple of it or of the
    chunk: the carry between tiles."""
    from dsp_audio_project_tpu_torch.kernels.group_states import (
        group_states_plain,
    )

    cfg = pt.EQConfig.from_gains(GAINS)
    for G in (100, 300):
        ops = make_block_operators(cfg.active_bands(48000), 48000, cfg.q,
                                   G * 32, 32)
        toe = torch.as_tensor(np.asarray(ops.group_toeplitz, np.float32),
                              device=cuda)
        rng = np.random.default_rng(G)
        inj = torch.as_tensor(rng.standard_normal((3, 5, G, 10)).astype(
            np.float32), device=cuda)
        got = pt.kernels.group_states(inj, toe)
        want = group_states_plain(inj, toe)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            hold_states(a, b)


@pytest.mark.parametrize("L,M", [(1, 4), (2, 8), (1, 5), (1, 6)])
def test_group_states_where_the_float32_product_is_inexact(cuda, L, M):
    """config_matrix's P = 1 plans at low rates (poles close to 1 within a
    group): the kernel holds against the plain version by
    ``states_agree``, against the float64 product where the dense float32
    product is itself too inexact for 120 dB."""
    gs = importlib.import_module(
        "dsp_audio_project_tpu_torch.kernels.group_states")

    fs_out = pt.SRCConfig(L=L, M=M).output_rate(FS)
    P = make_plan(L, M).P
    cfg = pt.EQConfig.from_gains(GAINS)
    ops = make_block_operators(cfg.active_bands(fs_out), fs_out, cfg.q,
                               128 * P, P)
    toe = torch.as_tensor(np.asarray(ops.group_toeplitz, np.float32),
                          device=cuda)
    rng = np.random.default_rng(L * 10 + M)
    x_g = torch.as_tensor(rng.standard_normal((1, 88, 128, P)).astype(
        np.float32), device=cuda)
    inj = x_g @ torch.as_tensor(np.asarray(ops.group_in, np.float32),
                                device=cuda)
    got = gs.group_states(inj, toe)
    want = gs.group_states_plain(inj, toe)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        ok, what = gs.states_agree(a, b, inj, toe)
        assert ok, what


def test_true_states_in_a_cuda_graph(cuda):
    """The cat route's solve (scan, cuBLAS carry, entry) captured once and
    replayed on new injections: equal to the eager call bit for bit (or
    >= 130 dB where the captured carry product takes another cuBLAS
    algorithm, as in the dynamic graph tests)."""
    from dsp_audio_project_tpu_torch.ops.eq import _true_states, block_tables

    inj, _, _ = state_case("serve", cuda)
    cfg = pt.EQConfig.from_gains(GAINS)
    ops = make_block_operators(cfg.active_bands(48000), 48000, cfg.q,
                               128 * 160, 160)
    tabs = block_tables(ops, cuda, inj.shape[1])
    buf = inj.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _true_states(buf, tabs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _true_states(buf, tabs)[0]
    for k in (1, 2):
        buf.copy_(inj * k - 0.5)
        graph.replay()
        torch.cuda.synchronize()
        eager = _true_states(buf, tabs)[0]
        assert torch.equal(out, eager) or snr_db(host(eager), host(out)) >= 130


def carry_case(name, device):
    """(inj, toe, carry_w) for a ``STATE_SHAPES`` entry with a carry
    triangle: ``state_case``'s injections and table, the static tables' or
    the device builder's ``carry_w`` for its K blocks."""
    from dsp_audio_project_tpu_torch.ops.eq import block_tables

    inj, toe, _ = state_case(name, device)
    (B, K, G, d), source = STATE_SHAPES[name]
    if source == "dynamic":
        ops = pt.build_dynamic_operators(
            torch.tensor(DYN_GAINS[0], device=device), 48000, pt.EQConfig(),
            160, G, K)
        return inj, ops.toe, ops.carry_w
    gains = {"Bass": 6} if source == "one band" else GAINS
    cfg = pt.EQConfig.from_gains(gains)
    ops = make_block_operators(cfg.active_bands(48000), 48000, cfg.q,
                               G * 160, 160)
    return inj, toe, block_tables(ops, device, K)["carry_w"]


def hold_solve(inj, toe, carry_w, sigma0=None):
    """The carry route's kernels against their plain versions by
    ``states_agree``: the ends and every full chunk's state, s_true and
    sigma; returns the kernels' outputs."""
    gs = importlib.import_module(
        "dsp_audio_project_tpu_torch.kernels.group_states")
    end, pre = gs.group_ends(inj, toe)
    s_true, sigma = gs.group_solve(inj, toe, end, pre, carry_w, sigma0)
    ref_end, ref_pre = gs.group_ends_plain(inj, toe)
    ref_true, _, ref_sigma = gs.group_solve_plain(inj, toe, carry_w, sigma0,
                                                  end)
    torch.cuda.synchronize()
    full = inj.shape[-2] // gs.CHUNK
    pairs = [("end", end, ref_end), ("s_true", s_true, ref_true),
             ("sigma", sigma, ref_sigma)]
    if full:
        pairs.append(("pre", pre[..., :full, :], ref_pre[..., :full, :]))
    for part, got, ref in pairs:
        ok, what = gs.states_agree(got, ref, inj, toe, carry_w, sigma0, end,
                                   part=part)
        assert ok, f"{part}: {what}"
    return end, pre, s_true, sigma


@pytest.mark.parametrize("with_sigma0", [False, True], ids=["zero", "sigma0"])
@pytest.mark.parametrize("name", ["serve", "slider", "stream step", "one band",
                                  "column slice"])
def test_carry_route_kernels_match_plain(cuda, name, with_sigma0):
    """The ends kernel and the solve kernel, one launch each counted,
    against the dense product, the carry's product and the einsum at the
    main paths' shapes (the serve cell's, the slider's d = 12, the frames
    route's column slice), with and without an incoming state; a second
    pair of launches bit for bit."""
    gs = importlib.import_module(
        "dsp_audio_project_tpu_torch.kernels.group_states")
    inj, toe, carry_w = carry_case(name, cuda)
    sigma0 = (torch.randn(inj.shape[:-3] + inj.shape[-1:], device=cuda,
                          generator=torch.Generator(cuda).manual_seed(3))
              if with_sigma0 else None)
    reset_launch_counts()
    first = hold_solve(inj, toe, carry_w, sigma0)
    counts = launch_counts()
    assert counts["group_ends"] == 1 and counts["group_solve"] == 1
    again = gs.group_true_states(inj, toe, carry_w, sigma0)
    torch.cuda.synchronize()
    assert torch.equal(again[0], first[2]) and torch.equal(again[1], first[0])
    assert torch.equal(again[2], first[3])


def test_carry_route_ragged_tiles_and_one_block(cuda):
    """Past one tile of groups and not a multiple of it or of the chunk
    (G = 100, 130, 300), one block (K = 1: sigma is the incoming state), a
    carry over 70 blocks (three a lane) and blocks of a signal split over
    two CUDA blocks (K = 6), each with an incoming state."""
    from dsp_audio_project_tpu_torch.ops.eq import block_tables

    cfg = pt.EQConfig.from_gains(GAINS)
    for G, K in ((100, 3), (130, 1), (300, 2), (8, 70), (16, 6)):
        ops = make_block_operators(cfg.active_bands(48000), 48000, cfg.q,
                                   G * 32, 32)
        tabs = block_tables(ops, cuda, K)
        rng = np.random.default_rng(G + K)
        inj = torch.as_tensor(rng.standard_normal((3, K, G, 10)).astype(
            np.float32), device=cuda)
        sigma0 = torch.as_tensor(rng.standard_normal((3, 10)).astype(
            np.float32), device=cuda)
        _, _, s_true, sigma = hold_solve(inj, tabs["group_toeplitz"],
                                         tabs["carry_w"], sigma0)
        if K == 1:
            assert torch.equal(sigma[:, 0], sigma0)


def test_cat_route_solve_is_two_launches(cuda, monkeypatch):
    """The cat route's state solve (``ops/eq._true_states`` with the carry
    triangle) is the ends kernel and the solve kernel, one launch each,
    and calls no torch product (no cuBLAS carry, no einsum entry)."""
    from dsp_audio_project_tpu_torch.ops.eq import _true_states, block_tables

    inj, toe, _ = state_case("serve", cuda)
    cfg = pt.EQConfig.from_gains(GAINS)
    ops = make_block_operators(cfg.active_bands(48000), 48000, cfg.q,
                               128 * 160, 160)
    tabs = block_tables(ops, cuda, inj.shape[1])

    def refuse(*args, **kwargs):
        raise AssertionError("a torch product inside the state solve")

    for name in ("matmul", "einsum", "addmm", "mm", "bmm"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "__matmul__", refuse)
    reset_launch_counts()
    s_true, end, sigma = _true_states(inj, tabs)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"group_ends": 1, "group_solve": 1}
    assert s_true.shape == inj.shape and end.shape == sigma.shape


def test_carry_route_replays_from_a_cuda_graph(cuda):
    """The two launches captured once and replayed on new injections and a
    new incoming state: equal to the eager call bit for bit."""
    gs = importlib.import_module(
        "dsp_audio_project_tpu_torch.kernels.group_states")
    inj, toe, carry_w = carry_case("serve", cuda)
    buf, s0 = inj.clone(), torch.zeros(inj.shape[0], inj.shape[-1],
                                       device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gs.group_true_states(buf, toe, carry_w, s0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gs.group_true_states(buf, toe, carry_w, s0)
    for k in (1, 2):
        buf.copy_(inj * k - 0.5)
        s0.fill_(0.25 * k)
        graph.replay()
        torch.cuda.synchronize()
        eager = gs.group_true_states(buf, toe, carry_w, s0)
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


def test_group_states_raise_when_the_kernel_cannot_build(cuda, monkeypatch):
    inj, toe, _ = state_case("one band", cuda)

    def refuse(name, launchers):
        raise RuntimeError(f"build of {name} refused")

    monkeypatch.setattr(_build, "load", refuse)
    with pytest.raises(RuntimeError, match="refused"):
        pt.kernels.group_states(inj, toe)
    with pytest.raises(RuntimeError, match="refused"):
        pt.kernels.group_entry_states(inj, inj[..., 0, :].contiguous(), toe)
    odd = torch.zeros(2, 4, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="d in"):
        pt.kernels.group_states(odd, torch.eye(9, device=cuda))


def test_dynamic_builder_takes_a_long_upload(cuda):
    """60 s at one group a block (K = 18,432 > 16,384): the device builder
    builds, bit for bit against its plain version on the same card, and
    the frames forward on its operators (the state kernels at G = 1)
    agrees with the same forward on the CPU (> 110 dB)."""
    from dsp_audio_project_tpu_torch.kernels.eq_design import (
        dynamic_operators_plain,
    )

    pipe, cpu = dyn_pipe(), dyn_pipe("cpu")
    x = make_x(1, 60 * FS, seed=29)
    n = x.shape[-1]
    U, G, K = pipe.dynamic_eq_geometry(FS, n, groups_per_block=1)
    assert G == 1 and K > 16384
    g = torch.tensor(DYN_GAINS[0], device=cuda)
    ops = pipe.dynamic_eq_operators(g, FS, n, groups_per_block=1,
                                    builder="traced")
    cfg = pt.EQConfig()
    s, c = _band_trig_tables(cfg, 48000)
    want = dynamic_operators_plain(
        g, torch.as_tensor(s, device=cuda), torch.as_tensor(c, device=cuda),
        cfg.q, cfg.bypass_threshold_db, U, G, K)
    for a, b in zip(ops, want):
        assert (a is None and b is None) or torch.equal(a, b)
    reset_launch_counts()
    z, _ = pipe.forward_frames_dynamic_ops(x, ops, FS)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["group_states"] == 1 and counts["group_entry_states"] == 1
    ops_c = cpu.dynamic_eq_operators(np.asarray(DYN_GAINS[0]), FS, n,
                                     groups_per_block=1, builder="host")
    z_c, _ = cpu.forward_frames_dynamic_ops(torch.as_tensor(x), ops_c, FS)
    assert snr_db(host(z_c), host(z)) > 110


# ---- streaming (streaming.py) ----------------------------------------------

STREAM_ROUTES = {
    "flat": (dict(fused=False, frames_per_shard=1024),
             ("fir_frames_kernel", "eq_finish")),
    "fused frames": (dict(frames_per_shard=512),
                     ("fir_frames_kernel", "eq_finish")),
    "cat": (dict(frames_per_shard=1024),
            ("polyphase_fir_class_rect_cat", "eq_finish")),
    "dynamic frames": (dict(frames_per_shard=512, gains_db=DYN_GAINS[0]),
                       ("fir_frames_kernel", "eq_finish")),
    "dynamic cat": (dict(frames_per_shard=1024, gains_db=DYN_GAINS[0]),
                    ("polyphase_fir_class_rect_cat", "eq_finish")),
}


def stream_cfg():
    return pt.PipelineConfig(src=pt.SRCConfig(L=160, M=147),
                             eq=pt.EQConfig.from_gains(GAINS))


def stream(sp, x, chunks):
    outs, pos = [], 0
    for c in chunks:
        outs.append(sp.process(x[..., pos : pos + c]))
        pos += c
    assert pos == x.shape[-1]
    outs.append(sp.flush())
    return np.concatenate(outs, axis=-1)


def sharded(device, route, channels=2, **kw):
    from dsp_audio_project_tpu_torch.parallel import single_device_mesh

    return pt.ShardedStreamProcessor(
        stream_cfg(), FS, single_device_mesh(device), channels,
        **STREAM_ROUTES[route][0], **kw)


STREAM_CHUNKS = [1, 4409, 100000, 66150, 200000, 70440]   # 441,000 = 10 s


@pytest.mark.parametrize("route", list(STREAM_ROUTES))
def test_stream_routes_on_card_match_cpu(cuda, route):
    """Each route of the sharded stream on the card (graph replays) vs the
    same processor on the CPU: > 110 dB; the route's kernels launched (at
    the warm-up and the capture), one capture."""
    x = make_x(2, 10 * FS, seed=30)
    reset_launch_counts()
    sp = sharded(None, route)
    z = stream(sp, x, STREAM_CHUNKS)
    counts = launch_counts()
    assert all(counts[k] >= 1 for k in STREAM_ROUTES[route][1]), counts
    assert sp.captures == 1 and sp._frames_done // sp._fl >= 2
    want = stream(sharded("cpu", route), x, STREAM_CHUNKS)
    assert z.shape == want.shape
    assert min(snr_db(want[c], z[c]) for c in range(2)) > 110


@pytest.mark.parametrize("route", ["fused frames", "cat", "dynamic cat"])
def test_stream_graph_replay_equals_eager_step(cuda, route):
    x = make_x(2, 10 * FS, seed=31)
    replayed = stream(sharded(None, route), x, STREAM_CHUNKS)
    sp = sharded(None, route, graphs=False)
    eager = stream(sp, x, STREAM_CHUNKS)
    assert sp.captures == 0
    np.testing.assert_array_equal(replayed, eager)


def test_stream_resume_on_card_is_bit_for_bit(cuda):
    from dsp_audio_project_tpu_torch.parallel import single_device_mesh

    x = make_x(2, 10 * FS, seed=32)
    full = stream(sharded(None, "cat"), x, STREAM_CHUNKS)
    sp = sharded(None, "cat")
    part1 = np.concatenate([sp.process(x[:, :104410]),
                            sp.process(x[:, 104410:250000])], axis=1)
    sp2 = pt.ShardedStreamProcessor.resume(
        stream_cfg(), single_device_mesh(), 2, sp.state_bytes(),
        **STREAM_ROUTES["cat"][0])
    got = np.concatenate([part1, stream(sp2, x[:, 250000:], [191000])], 1)
    np.testing.assert_array_equal(full, got)


def test_stream_set_gains_replays_without_recapture(cuda):
    """set_gains between two steps of the dynamic cat route: the captured
    graphs are the same objects, nothing is captured again, and the result
    agrees with the same stream on a CPU copy (> 110 dB)."""
    x = make_x(2, 10 * FS, seed=33)
    out = {}
    for device in (None, "cpu"):
        sp = sharded(device, "dynamic cat")
        part1 = sp.process(x[:, :200000])
        graphs = sp._runner.graphs
        sp.set_gains(DYN_GAINS[1])
        part2 = stream(sp, x[:, 200000:], [241000])
        assert sp._runner.graphs is graphs
        assert sp.captures == (1 if device is None else 0)
        out[device] = (part1.shape[1], np.concatenate([part1, part2], 1))
    assert out[None][0] == out["cpu"][0] == 1024 * 160
    assert min(snr_db(out["cpu"][1][c], out[None][1][c])
               for c in range(2)) > 110


def test_stream_processor_on_card_matches_cpu(cuda):
    """StreamProcessor in 100 ms chunks: the frames kernel and K9 launch on
    every chunk; the card agrees with the CPU (> 110 dB)."""
    x = make_x(1, 5 * FS, seed=34)[0]
    chunks = [FS // 10] * 50
    reset_launch_counts()
    z = stream(pt.StreamProcessor(stream_cfg(), FS), x, chunks)
    counts = launch_counts()
    assert counts["fir_frames_kernel"] >= 49 and counts["eq_finish"] >= 49
    want = stream(pt.StreamProcessor(stream_cfg(), FS, device="cpu"), x,
                  chunks)
    assert z.shape == want.shape and snr_db(want, z) > 110


# ---- sharding (parallel/): virtual meshes of several shards on cuda:0 ------

SHARD_ROUTES = {
    "plain": (dict(fused=False), ("fir_frames_kernel", "eq_finish")),
    "fused": (dict(fused=True), ("fir_frames_kernel", "eq_finish")),
    "cat": (dict(cat=True), ("polyphase_fir_class_rect_cat", "eq_finish")),
}


def card_mesh(mc, mb, device="cuda"):
    return pt.build_mesh(pt.MeshConfig(channel_devices=mc, block_devices=mb),
                         devices=[device] * (mc * mb))


@pytest.mark.parametrize("mc,mb", [(1, 4), (2, 2)])
@pytest.mark.parametrize("route", list(SHARD_ROUTES))
def test_run_sharded_on_card_matches_cpu(cuda, route, mc, mb):
    """run_sharded on a virtual cuda:0 mesh vs the same mesh on the CPU
    (plain versions): > 110 dB, the route's kernels launched; vs the card
    at 1x1 > 110 dB."""
    kw, needed = SHARD_ROUTES[route]
    x = make_x(2, 5 * FS, seed=40)
    cfg = stream_cfg()
    reset_launch_counts()
    z = pt.run_sharded(torch.as_tensor(x, device=cuda), FS, cfg,
                       card_mesh(mc, mb), **kw)[0]
    torch.cuda.synchronize()
    counts = launch_counts()
    assert all(counts[k] >= mc * mb for k in needed), counts
    assert z.device.type == "cuda"
    want = pt.run_sharded(x, FS, cfg, card_mesh(mc, mb, "cpu"), **kw)[0]
    z1 = pt.run_sharded(torch.as_tensor(x, device=cuda), FS, cfg,
                        card_mesh(1, 1), **kw)[0]
    z, want, z1 = z.cpu().numpy(), want.numpy(), z1.cpu().numpy()
    assert min(snr_db(want[c], z[c]) for c in range(2)) > 110
    assert min(snr_db(z1[c], z[c]) for c in range(2)) > 110


@pytest.mark.parametrize("mc,mb", [(1, 4), (2, 2)])
@pytest.mark.parametrize("route", ["fused frames", "cat", "dynamic cat"])
def test_sharded_stream_on_virtual_card_mesh(cuda, route, mc, mb):
    """The stream on a virtual cuda:0 mesh: one graph a slot covering every
    shard, captured once, equal to the eager step bit for bit and > 110 dB
    against the CPU; a checkpoint resumes bit for bit."""
    x = make_x(2, 20 * FS, seed=41)
    chunks = [1, 4409, 300000, 66150, 400000, 111440]      # 882,000 = 20 s
    kw = STREAM_ROUTES[route][0]

    def proc(device, **extra):
        return pt.ShardedStreamProcessor(stream_cfg(), FS,
                                         card_mesh(mc, mb, device), 2, **kw,
                                         **extra)

    sp = proc("cuda")
    replayed = stream(sp, x, chunks)
    assert sp.captures == 1 and sp._frames_done // sp._F_sup >= 2
    eager = stream(proc("cuda", graphs=False), x, chunks)
    np.testing.assert_array_equal(replayed, eager)
    want = stream(proc("cpu"), x, chunks)
    assert min(snr_db(want[c], replayed[c]) for c in range(2)) > 110
    sp = proc("cuda")
    part1 = sp.process(x[:, :700000])
    assert sp._frames_done >= sp._F_sup
    sp2 = pt.ShardedStreamProcessor.resume(
        stream_cfg(), card_mesh(mc, mb), 2, sp.state_bytes(), **kw)
    got = np.concatenate([part1, stream(sp2, x[:, 700000:], [182000])], 1)
    np.testing.assert_array_equal(replayed, got)


def test_stream_capture_after_a_dropped_processor(cuda):
    """A processor with captured graphs is freed as soon as it is dropped
    (no reference cycle), so its graphs are never destroyed inside a later
    processor's capture, which would invalidate it; the next processor
    captures and matches."""
    import gc
    import weakref

    x = make_x(2, 10 * FS, seed=42)
    want = stream(sharded(None, "fused frames"), x, STREAM_CHUNKS)
    for _ in range(3):
        old = sharded(None, "fused frames")
        old.process(x[:, :200000])
        assert old.captures == 1
        ref = weakref.ref(old)
        gc.disable()
        try:
            del old
            assert ref() is None
        finally:
            gc.enable()
        sp = sharded(None, "fused frames")
        assert stream(sp, x, STREAM_CHUNKS).tobytes() == want.tobytes()
        assert sp.captures == 1


# ---- several cards: meshes over the cards, NCCL between processes ----------

CARD_LAYOUTS = ("1xN", "Nx1", "2x2")


def cards_mesh(layout):
    """A mesh over real cards (decided here, never at import): 1xN or Nx1
    over every card, 2x2 over four; skips on a host with too few."""
    cards = torch.cuda.device_count()
    mc, mb = {"1xN": (1, cards), "Nx1": (cards, 1), "2x2": (2, 2)}[layout]
    if cards < 2 or mc * mb > cards:
        pytest.skip(f"{layout} across cards needs more cards than the "
                    f"{cards} here")
    return mc, mb, pt.build_mesh(
        pt.MeshConfig(channel_devices=mc, block_devices=mb),
        devices=[torch.device("cuda", i) for i in range(mc * mb)])


def sync_cards():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@pytest.mark.parametrize("layout", CARD_LAYOUTS)
@pytest.mark.parametrize("route", list(SHARD_ROUTES))
def test_run_sharded_across_cards(cuda, route, layout):
    """run_sharded with each shard on its own card: a launch a shard, z on
    shard (0, 0)'s card, >= 110 dB against the card at 1x1."""
    mc, mb, mesh = cards_mesh(layout)
    kw, needed = SHARD_ROUTES[route]
    x = make_x(4, 5 * FS, seed=43)
    cfg = stream_cfg()
    reset_launch_counts()
    z = pt.run_sharded(torch.as_tensor(x, device=cuda), FS, cfg, mesh,
                       **kw)[0]
    sync_cards()
    counts = launch_counts()
    assert all(counts[k] >= mc * mb for k in needed), counts
    assert z.device == torch.device("cuda", 0)
    z1 = pt.run_sharded(torch.as_tensor(x, device=cuda), FS, cfg,
                        card_mesh(1, 1), **kw)[0]
    z, z1 = z.cpu().numpy(), z1.cpu().numpy()
    assert z.shape == z1.shape
    assert min(snr_db(z1[c], z[c]) for c in range(4)) >= 110


@pytest.mark.parametrize("layout", CARD_LAYOUTS)
@pytest.mark.parametrize("route", ["fused frames", "cat", "dynamic cat"])
def test_sharded_stream_across_cards(cuda, route, layout):
    """The stream with each shard on its own card (eager steps, no
    capture): >= 110 dB against the one-shot z (DYN_GAINS[0] is GAINS
    band for band), and a checkpoint resumed bit for bit."""
    mc, mb, mesh = cards_mesh(layout)
    x = make_x(4, 20 * FS, seed=44)
    chunks = [1, 4409, 300000, 66150, 400000, 111440]      # 882,000 = 20 s
    kw = STREAM_ROUTES[route][0]
    reset_launch_counts()
    sp = pt.ShardedStreamProcessor(stream_cfg(), FS, mesh, 4, **kw)
    z = stream(sp, x, chunks)
    counts = launch_counts()
    assert all(counts[k] >= mc * mb for k in STREAM_ROUTES[route][1])
    assert sp.captures == 0 and sp._frames_done // sp._F_sup >= 2
    want = pt.run_sharded(torch.as_tensor(x, device=cuda), FS, stream_cfg(),
                          card_mesh(1, 1), cat=True)[0].cpu().numpy()
    assert z.shape == want.shape
    assert min(snr_db(want[c], z[c]) for c in range(4)) >= 110
    sp = pt.ShardedStreamProcessor(stream_cfg(), FS, mesh, 4, **kw)
    part1 = sp.process(x[:, :700000])
    assert sp._frames_done >= sp._F_sup
    sp2 = pt.ShardedStreamProcessor.resume(stream_cfg(), mesh, 4,
                                           sp.state_bytes(), **kw)
    got = np.concatenate([part1, stream(sp2, x[:, 700000:], [182000])], 1)
    np.testing.assert_array_equal(z, got)


def test_pod_scaling_on_nccl(cuda, tmp_path):
    """pod_scaling in one process a card (world = device_count) on NCCL
    through a file rendezvous: initialize, multihost_mesh, the halo and
    carry collectives, gather_grid; every rank exits 0 and rank 0's gates
    pass."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    world = torch.cuda.device_count()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dsp_audio_project_tpu_torch.scripts."
         "pod_scaling", "--coordinator", f"file://{tmp_path}/rdzv",
         "--num-processes", str(world), "--process-id", str(r),
         "--channel-hosts", "1", "--seconds", "20", "--reps", "2"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert f"{world} process(es) (nccl)" in outs[0]
    assert f"'block': {world}" in outs[0] and "gates passed" in outs[0]


# ---- the surfaces: the native codec, the CLI, the graph stages -------------

def test_native_codec_builds_and_loads(cuda):
    """The port's codec builds from its own native/ into _build/ on the
    GPU host and decodes and encodes equal to the numpy codec."""
    from dsp_audio_project_tpu_torch.io import native

    assert native.available()
    path = native.library_path()
    assert path.parent.name == "_build" and path.exists()
    assert path.parent.parent.name == "dsp_audio_project_tpu_torch"
    x = make_x(3, 4000, seed=11)
    data = pt.export_wav(x, FS)
    got, fs = native.decode(data, mono=False)
    want, fs_np = pt.load_signal(data, mono=False, engine="numpy")
    assert fs == fs_np == FS and np.array_equal(got, want)
    pcm = np.frombuffer(pt.export_wav(got, FS)[44:], "<i2")
    assert np.array_equal(native.encode_pcm16(got).reshape(-1), pcm)


def test_cli_one_shot_on_card(cuda, tmp_path):
    """The CLI on the card at 160/147 with --spectra and --report: the
    frames kernel, K9 and K2 launch; its WAV is within 1 LSB of the
    --device cpu run's and its spectra > 110 dB against them."""
    import json

    from dsp_audio_project_tpu_torch import cli

    src = str(tmp_path / "in.wav")
    pt.export_wav(make_x(2, FS // 2, seed=12), FS, src)
    base = [src, "-L", "160", "-M", "147", "--no-ui-bounds", "-g", "Bass=6",
            "-g", "Presence=-4", "--multichannel"]
    outs = {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        paths = [str(tmp_path / f"{tag}.{e}") for e in ("wav", "json", "html")]
        reset_launch_counts()
        assert cli.main([base[0], paths[0], *base[1:], *extra, "--spectra",
                         paths[1], "--report", paths[2]]) == 0
        outs[tag] = paths, launch_counts()
    counts = outs["card"][1]
    for name in ("fir_frames_kernel", "eq_finish", "rfft_four_step_magnitude"):
        assert counts[name] >= 1, (name, counts)
    assert sum(outs["cpu"][1].values()) == 0
    a, fa = pt.read_wav(outs["card"][0][0])
    b, fb = pt.read_wav(outs["cpu"][0][0])
    assert fa == fb == 48000 and a.shape == b.shape == (24000, 2)
    assert np.abs(a - b).max() * 32768 <= 1.0
    for key in ("input", "resampled", "output"):
        got, want = (np.asarray(json.load(open(outs[t][0][1]))[key]
                                ["magnitude"]) for t in ("card", "cpu"))
        assert snr_db(want.ravel(), got.ravel()) > 110, key
    assert "<audio" in open(outs["card"][0][2]).read()


def test_graph_chain_on_card_matches_cpu(cuda):
    """The telephone Chain on the card (the frames kernel launches) against
    the same chain with device="cpu": > 110 dB, the same rate."""
    stages = [pt.Resample(pt.SRCConfig(L=20, M=147, taps_rule_factor=4)),
              pt.Equalize(pt.EQConfig.from_gains({"Low Mids": 6})),
              pt.Resample(pt.SRCConfig(L=147, M=20, taps_rule_factor=4)),
              pt.Clip(), pt.Gain(-6.0), pt.Normalize()]
    x = make_x(2, FS, seed=13)
    reset_launch_counts()
    got, fs = pt.Chain(stages)(x, FS)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert launch_counts()["fir_frames_kernel"] >= 2
    want, fs_cpu = pt.Chain(stages, device="cpu")(x, FS)
    assert fs == fs_cpu == FS and got.shape == want.shape
    assert snr_db(host(want), host(got)) > 110


def test_measure_times_forward_cat(cuda):
    """utils/benchmarking on the card: a positive time for forward_cat,
    and the differential forms run."""
    from dsp_audio_project_tpu_torch.utils import benchmarking

    pipe = pt.AudioPipeline(stream_cfg(), device=cuda)
    ins = [(torch.as_tensor(make_x(2, 2 * FS, seed=s), device=cuda), FS)
           for s in range(8)]
    assert benchmarking.measure(pipe.forward_cat, ins[2:],
                                warmup_inputs=ins[:2], passes=3) > 0
    assert benchmarking.measure_differential(pipe.forward_cat, ins) > 0


def test_measure_device_hides_the_host(cuda):
    """measure_device: forward_cat at 8 x 60 s takes about its profiled
    kernel time (the host hidden behind the spin); a function that waits
    for the device raises."""
    from dsp_audio_project_tpu_torch.utils import benchmarking
    from dsp_audio_project_tpu_torch.utils.deviceprof import (
        profile_device_ops,
    )

    pipe = pt.AudioPipeline(stream_cfg(), device=cuda)
    x = torch.as_tensor(make_x(8, 60 * FS, seed=2), device=cuda)
    dev_s = benchmarking.measure_device(pipe.forward_cat, x, FS)
    prof_s = profile_device_ops(pipe.forward_cat, x, FS).total_ms / 1e3
    assert 0.8 * prof_s < dev_s < 1.5 * prof_s
    with pytest.raises(RuntimeError, match="waits for the device"):
        benchmarking.measure_device(lambda v: (v * 2).sum().item() + 0 * v,
                                    x)


def test_device_profile_lists_kernels_and_span(cuda):
    """profile_device_ops(forward_cat): K1's and K9's kernels among the
    rows, the src_eq_cat span apart, the total their sum."""
    from dsp_audio_project_tpu_torch.utils.deviceprof import (
        profile_device_ops,
    )

    pipe = pt.AudioPipeline(stream_cfg(), device=cuda)
    x = torch.as_tensor(make_x(8, 60 * FS, seed=1), device=cuda)
    pipe.forward_cat(x, FS)
    torch.cuda.synchronize()
    prof = profile_device_ops(pipe.forward_cat, x, FS, top=100)
    names = [name for name, _ in prof.ops]
    assert any("fir_tf32_kernel" in name for name in names), names
    assert any("eq_finish" in name for name in names), names
    assert "src_eq_cat" in [name for name, _ in prof.spans], prof.spans
    assert prof.total_ms == pytest.approx(sum(ms for _, ms in prof.ops))
    assert 0 < prof.total_ms < 50


def test_roofline_fraction_of_the_cat_chain(cuda):
    """roofline_fraction of the full chain's reckoned bytes at its call
    time on the H100 lies in (0, 1.05]."""
    from dsp_audio_project_tpu_torch import bench
    from dsp_audio_project_tpu_torch.utils import profiling
    from dsp_audio_project_tpu_torch.utils.benchmarking import measure

    if profiling.device_hbm_peak() is None:
        pytest.skip(f"no HBM peak for {torch.cuda.get_device_name()}")
    cfg = bench.serving_config()
    pipe = pt.AudioPipeline(cfg, device=cuda)
    n = int(bench.SECONDS * FS)
    batches = bench.device_batches(bench.make_signal(n, FS), 4, cuda)
    sec = measure(lambda v: pipe.forward_cat_spectra(v, FS), batches,
                  warmup_inputs=batches[:1])
    frac = profiling.roofline_fraction(
        bench.chain_bytes(cfg, n, bench.BATCH), sec)
    assert 0 < frac <= 1.05


def test_bench_correctness_at_full_width(cuda):
    """The bench's correctness section at 8 x 60 s on the card."""
    from dsp_audio_project_tpu_torch import bench

    acc = bench.check_accuracy(bench.SECONDS, bench.BATCH, device=cuda)
    assert acc["route"] == "cat"
    assert acc["snr_z"] >= 60 and acc["snr_spectra"] >= 60
    assert acc["z"].shape == (bench.BATCH, 2880000)


@pytest.mark.parametrize("fwd", ["forward_cat", "forward_frames"])
def test_stage_spans_inside_a_cuda_graph(cuda, fwd):
    """A forward with its trace_stage spans captured in a CUDA graph: the
    replay equals the eager call bit for bit."""
    pipe = pt.AudioPipeline(stream_cfg(), device=cuda)
    x = torch.as_tensor(make_x(2, 2 * FS, seed=3), device=cuda)
    call = getattr(pipe, fwd)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            call(x, FS)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(x, FS)
    graph.replay()
    torch.cuda.synchronize()
    got = out if isinstance(out, torch.Tensor) else out[0]
    want = call(x, FS)
    want = want if isinstance(want, torch.Tensor) else want[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_short_profiles_keep_their_kernels(cuda):
    """200 one-call profiles of K7 (two kernels a call) through
    utils/deviceprof: each holds both kernel records (none comes back
    empty or short, which a session without the edge sleeps could)."""
    from dsp_audio_project_tpu_torch.kernels.rfft_two_pass import (
        rfft_four_step_tall,
    )
    from dsp_audio_project_tpu_torch.utils.deviceprof import (
        profile_device_ops,
    )

    x = torch.randn(16, 131072, device=cuda)
    mag = functools.partial(rfft_four_step_tall, magnitude=True)
    mag(x)
    torch.cuda.synchronize()
    for _ in range(200):
        prof = profile_device_ops(mag, x)
        assert len(prof.ops) == 2 and prof.total_ms > 0, prof.ops


# ---- the compiled forwards (AudioPipeline.jit_forward_*) --------------------

JIT_METHODS = ("jit_forward", "jit_forward_frames",
               "jit_forward_frames_spectra", "jit_forward_spectra",
               "jit_forward_flat", "jit_forward_flat_spectra",
               "jit_forward_cat", "jit_forward_cat_spectra",
               "jit_forward_frames_dynamic", "jit_forward_frames_dynamic_ops",
               "jit_forward_cat_dynamic_ops")


def jit_cfg(**kernels):
    return pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(src_fast=True, eq_fast=True, **kernels))


def eager_of(pipe, method):
    """The eager forward a compiled forward captures."""
    return getattr(pipe, "_forward" if method == "jit_forward"
                   else method[len("jit_"):])


def jit_args(pipe, method, x, k=0, fs=FS):
    """The call's arguments: x, then gains (a tensor), or operators built
    on the host (and their cat table) for gain vector k, then fs."""
    if method == "jit_forward_frames_dynamic":
        return x, torch.tensor(DYN_GAINS[k], device=pipe.device), fs
    if method.endswith("_dynamic_ops"):
        ops = pipe.dynamic_eq_operators(np.asarray(DYN_GAINS[k]), fs,
                                        x.shape[-1], builder="host")
        if method == "jit_forward_cat_dynamic_ops":
            return x, ops, pipe.dynamic_cat_tables(ops), fs
        return x, ops, fs
    return x, fs


def out_leaves(out):
    return list(tensors(out))


def assert_bitwise(got, want):
    got, want = out_leaves(got), out_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("method", list(JIT_METHODS) + ["explicit"])
def test_compiled_forward_replays_the_eager_forward(cuda, method):
    """Each compiled forward, captured at its first call: the replay equals
    the eager forward bit for bit; a held result is unchanged by later
    calls on other batches (and other gains), which take a second slot and
    then copy; a released slot is replayed again without a capture; the
    capture ran the path's kernels."""
    explicit = method == "explicit"
    pipe = pt.AudioPipeline(jit_cfg(**({"fir_path": "pallas",
                                        "iir_path": "pallas"}
                                       if explicit else {})), device=cuda)
    method = "jit_forward" if explicit else method
    fn = getattr(pipe, method)()
    assert getattr(pipe, method)() is fn
    eager = eager_of(pipe, method)
    xs = [torch.as_tensor(make_x(2, FS, seed=40 + k), device=cuda)
          for k in range(3)]
    args = [jit_args(pipe, method, x, k % 2) for k, x in enumerate(xs)]
    reset_launch_counts()
    r1 = fn(*args[0])
    counts = launch_counts()
    if explicit:
        assert counts["block_end_states"] >= 1 and counts["block_apply"] >= 1
    elif "cat" in method:
        assert counts["polyphase_fir_class_rect_cat"] >= 1
    else:
        assert counts["fir_frames_kernel"] >= 1
    if "cat" in method or "frames" in method:
        assert counts["eq_finish"] >= 1
    if "spectra" in method:
        assert counts["rfft_four_step_magnitude"] >= 1
    assert_bitwise(r1, eager(*args[0]))
    kept1 = [t.clone() for t in out_leaves(r1)]
    r2 = fn(*args[1])
    assert_bitwise(r2, eager(*args[1]))
    kept2 = [t.clone() for t in out_leaves(r2)]
    r3 = fn(*args[2])
    assert_bitwise(r3, eager(*args[2]))
    assert (fn.captures, fn.copies) == (3, 1)
    assert_bitwise(r1, kept1)
    assert_bitwise(r2, kept2)
    del r1, r2, r3
    reset_launch_counts()
    assert_bitwise(fn(*args[0]), kept1)
    assert fn.captures == 3 and fn._cache_size() == 1
    assert not any(launch_counts().values())


@pytest.mark.parametrize("method", ["jit_forward_cat_spectra",
                                    "jit_forward_frames_spectra"])
def test_compiled_forward_across_rates(cuda, method):
    """Capture at 44.1 kHz, call at 48 kHz (which installs that rate's
    tables on the module), replay at 44.1 kHz: each result equals the eager
    forward at its rate bit for bit, though the first rate's tables left
    the module (the entry holds them; memory freed would have been
    overwritten by the NaN fills).  numpy input is taken."""
    pipe = pt.AudioPipeline(jit_cfg(), device=cuda)
    fn, eager = getattr(pipe, method)(), eager_of(pipe, method)
    xa = make_x(2, FS, seed=51)
    xb = torch.as_tensor(make_x(2, 48000, seed=52), device=cuda)
    want_a = eager(xa, FS)
    assert_bitwise(fn(xa, FS), want_a)
    old = {name: t.data_ptr() for name, t in pipe.named_buffers()}
    assert_bitwise(fn(xb, 48000), eager(xb, 48000))
    assert pipe.G.data_ptr() != old["G"]
    junk = [torch.full_like(t, float("nan")) for t in pipe.buffers()
            for _ in range(2)]
    assert_bitwise(fn(xa, FS), want_a)
    assert fn._cache_size() == 2 and fn.captures == 2
    del junk


def test_compiled_forward_runs_the_carry_scan(cuda):
    """One entry above _CARRY_ALLPAIRS_MAX = 512 blocks (2 x 600 s at
    44.1 kHz: the cat path's log-depth carry scan) is captured and replays
    bit for bit against the eager forward."""
    from dsp_audio_project_tpu_torch.ops.eq import _CARRY_ALLPAIRS_MAX

    pipe = pt.AudioPipeline(jit_cfg(), device=cuda)
    n = 600 * FS
    x = torch.as_tensor(make_x(2, n, seed=53), device=cuda)
    assert pipe.dynamic_eq_geometry(FS, n)[2] > _CARRY_ALLPAIRS_MAX
    fn = pipe.jit_forward_cat()
    got = fn(x, FS)
    assert torch.equal(got, pipe.forward_cat(x, FS))


def test_compiled_forward_on_another_card(cuda):
    """A pipeline on the last card, built and called while cuda:0 is
    current and after a capture on cuda:0: its graph records that card's
    work, so the replays of two different batches each equal the eager
    forward bit for bit (a capture on cuda:0's stream would have run the
    kernels eagerly and recorded nothing, and every replay would return
    the first batch's outputs)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two cards, {cards} here")
    first = pt.AudioPipeline(jit_cfg(), device=cuda)
    x0 = torch.as_tensor(make_x(2, FS, seed=56), device=cuda)
    assert torch.equal(first.jit_forward_cat()(x0, FS),
                       first.forward_cat(x0, FS))
    last = torch.device("cuda", cards - 1)
    assert torch.cuda.current_device() == 0
    pipe = pt.AudioPipeline(jit_cfg(), device=last)
    fn = pipe.jit_forward_cat_spectra()
    for seed in (57, 58):
        x = torch.as_tensor(make_x(2, FS, seed=seed), device=last)
        got = fn(x, FS)
        assert all(t.device == last for t in out_leaves(got))
        assert_bitwise(got, pipe.forward_cat_spectra(x, FS))
        del got
    assert fn.captures == 1 and torch.cuda.current_device() == 0


def test_compiled_forward_raises_when_the_capture_fails(cuda):
    """A forward that synchronizes cannot be captured: the call raises, no
    eager result comes back, every later call raises again, and the card
    is still usable."""
    pipe = pt.AudioPipeline(jit_cfg(), device=cuda)
    real = pipe.forward_cat

    def syncing(x, fs):
        z = real(x, fs)
        torch.cuda.synchronize()
        return z

    pipe.forward_cat = syncing
    fn = pipe.jit_forward_cat()
    x = torch.as_tensor(make_x(2, FS, seed=54), device=cuda)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture"):
            fn(x, FS)
    assert fn.captures == 0
    del pipe.forward_cat
    other = pt.AudioPipeline(jit_cfg(), device=cuda)
    assert torch.equal(other.jit_forward_cat()(x, FS),
                       other.forward_cat(x, FS))


def test_compiled_forward_replays_show_in_the_profiler(cuda):
    """The kernels of a replayed graph appear in a device profile
    (``utils/deviceprof``), as the bench reads them.  A replay runs no
    host code, so it opens no stage span: a profile of calls that each
    drop their result (replays of the first slot, no capture) lists no
    span, while a profile of calls that hold their results (a second
    slot's warm-up and capture, run under the span src_eq_cat) lists that
    span."""
    from dsp_audio_project_tpu_torch.utils.deviceprof import (
        profile_device_span,
    )

    pipe = pt.AudioPipeline(jit_cfg(), device=cuda)
    fn = pipe.jit_forward_cat_spectra()
    x = torch.as_tensor(make_x(2, FS, seed=55), device=cuda)
    fn(x, FS)
    torch.cuda.synchronize()

    def dropped():
        for _ in range(3):
            fn(x, FS)

    prof = profile_device_span(dropped)
    names = " ".join(name for name, _ in prof.ops)
    assert "fir_tf32" in names and "eq_finish" in names, prof.ops
    assert prof.total_ms > 0 and prof.spans == [], prof.spans
    assert fn.captures == 1
    held = profile_device_span(lambda: [fn(x, FS) for _ in range(2)])
    assert fn.captures == 2
    assert [name for name, _ in held.spans] == ["src_eq_cat"], held.spans
