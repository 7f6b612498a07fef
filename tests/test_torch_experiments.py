"""E6 (the butterfly rfft) and E3-E5 (the FIR staging variants): port vs the JAX kernels.

CPU, the plain versions; the JAX kernels run in interpret mode, as
tests/test_kernels.py and tests/test_cat_chain.py run them.  Tolerances:

* E6 (its plain version, the register-radix mirror of the CUDA kernel)
  against JAX ``rfft_pallas`` and float64 ``np.fft.rfft`` at N = 4 .. 2048,
  the small sizes included because each needs its own kernel
  instantiation: max abs error < 1e-5 * max|X| (the JAX test's bound:
  float32 FFTs over <= 11 stages), with ragged row counts; above N = 32768
  the wrapper's two-pass route against numpy, the same bound;
* E3, E4 and E5 against their JAX kernels at the serving plan (160/147)
  and N = 12000: max abs error < 1e-5 on signals of |x| <= ~1.2 (float32
  sums of ~190 terms in different orders, as tests/test_torch_frames.py).

The CUDA kernels are compared with these plain versions on the card in
tests/test_torch_gpu.py and chip_smoke.py.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsp_audio_project_tpu.kernels.experiments.fir_dma import (
    polyphase_fir_dma as jfir_dma,
)
from dsp_audio_project_tpu.kernels.experiments.fir_rowdma import (
    polyphase_fir_rect_rowdma as jrowdma,
)
from dsp_audio_project_tpu.kernels.experiments.fir_splitbank import (
    polyphase_fir_rect_splitbank as jsplitbank,
)
from dsp_audio_project_tpu.kernels.experiments.rfft_butterfly import (
    rfft_pallas,
)
from dsp_audio_project_tpu.ops.src import make_plan as jmake_plan
from dsp_audio_project_tpu_torch import SRCConfig
from dsp_audio_project_tpu_torch.kernels import (
    launch_counts, reset_launch_counts,
)
from dsp_audio_project_tpu_torch.kernels.experiments import (
    polyphase_fir_dma, polyphase_fir_rect_rowdma,
    polyphase_fir_rect_splitbank,
)
from dsp_audio_project_tpu_torch.kernels.experiments.rfft_butterfly import (
    rfft_butterfly,
)
from dsp_audio_project_tpu_torch.ops.src import make_plan

torch.set_num_threads(2)

TOL = 1e-5
N = 12000


def rel_err(want, got) -> float:
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max() / np.abs(want).max())


def max_err(a, b) -> float:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("n", [4, 8, 16, 64, 128, 256, 2048])
def test_rfft_butterfly_matches_jax_and_numpy(n):
    x = np.random.default_rng(n).standard_normal((5, n)).astype(np.float32)
    want = np.asarray(rfft_pallas(jnp.asarray(x), interpret=True))
    got = rfft_butterfly(torch.as_tensor(x))
    assert got.dtype == torch.complex64 and got.shape == (5, n // 2 + 1)
    assert rel_err(want, got) < TOL
    assert rel_err(np.fft.rfft(x.astype(np.float64)), got) < TOL


def test_rfft_butterfly_ragged_rows_and_routes():
    """7 rows (the JAX row-tile test's ragged count), leading axes, the
    smallest N and the two-pass route above N = 32768."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((7, 512)).astype(np.float32)
    want = np.asarray(rfft_pallas(jnp.asarray(x), row_tile=4, interpret=True))
    got = rfft_butterfly(torch.as_tensor(x), row_tile=4)
    assert rel_err(want, got) < TOL
    nested = rfft_butterfly(torch.as_tensor(x[:6].reshape(2, 3, 512)))
    assert torch.equal(nested.reshape(6, -1), got[:6])
    for n in (4, 65536):
        x = rng.standard_normal((2, n)).astype(np.float32)
        reset_launch_counts()
        got = rfft_butterfly(torch.as_tensor(x))
        assert launch_counts() == dict.fromkeys(launch_counts(), 0)  # CPU
        assert rel_err(np.fft.rfft(x.astype(np.float64)), got) < TOL
    for bad in (2, 100):
        with pytest.raises(ValueError, match="power-of-two N >= 4"):
            rfft_butterfly(torch.zeros(3, bad))


@pytest.mark.parametrize("L,M", [(160, 147), (147, 160)])
def test_fir_dma_matches_jax(L, M):
    x = (0.3 * np.random.default_rng(L).standard_normal((2, N))).astype(
        np.float32)
    n_out = SRCConfig(L=L, M=M).output_length(N)
    want = jfir_dma(jnp.asarray(x), jmake_plan(L, M), n_out, frame_tile=64,
                    interpret=True)
    got = polyphase_fir_dma(torch.as_tensor(x), make_plan(L, M), n_out,
                            frame_tile=64)
    assert got.shape == (2, n_out)
    assert max_err(want, got) < TOL


@pytest.mark.parametrize("pad_frames", [False, True])
def test_rect_variants_match_jax(pad_frames):
    """E4 (split bank) and E5 (row DMA) at the serving plan."""
    x = (0.3 * np.random.default_rng(7).standard_normal((2, N))).astype(
        np.float32)
    n_out = SRCConfig(L=160, M=147).output_length(N)
    plan, jplan = make_plan(160, 147), jmake_plan(160, 147)
    for jfn, tfn in ((jsplitbank, polyphase_fir_rect_splitbank),
                     (jrowdma, polyphase_fir_rect_rowdma)):
        want = jfn(jnp.asarray(x), jplan, n_out, pad_frames=pad_frames,
                   interpret=True)
        got = tfn(torch.as_tensor(x), plan, n_out, pad_frames=pad_frames)
        assert max_err(want, got) < TOL, tfn.__name__
    # E4's split changes no value: any split_at in range, one result.
    a = polyphase_fir_rect_splitbank(torch.as_tensor(x), plan, n_out,
                                     split_at=32)
    b = polyphase_fir_rect_rowdma(torch.as_tensor(x), plan, n_out)
    assert torch.equal(a, b)


def test_rect_variants_errors_match_jax():
    x = torch.zeros(2, 4000)
    plan = make_plan(160, 147)
    for split_at in (0, 160, -3):
        with pytest.raises(ValueError, match="split_at"):
            polyphase_fir_rect_splitbank(x, plan, 4354, split_at=split_at)
        with pytest.raises(ValueError, match="split_at"):
            jsplitbank(jnp.zeros((2, 4000)), jmake_plan(160, 147), 4354,
                       split_at=split_at, interpret=True)
    narrow = make_plan(8, 7)                     # s = 7
    for fn in (polyphase_fir_rect_splitbank, polyphase_fir_rect_rowdma):
        with pytest.raises(ValueError, match="class-kernel regime"):
            fn(x, narrow, 4572)
