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
strided view), > 120 dB for K9 (d <= 12
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
FIR launchers and E6.
"""
from __future__ import annotations

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
