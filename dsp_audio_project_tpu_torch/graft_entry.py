"""Entry points of the flagship program and the multi-shard dry run.

    python -m dsp_audio_project_tpu_torch.graft_entry 8               # the card
    python -m dsp_audio_project_tpu_torch.graft_entry 8 --device cpu  # the CPU

Counterpart of the repo's ``__graft_entry__.py``.  ``entry()`` returns
``(fn, (x,))``: ``fn`` is the serving program, ``forward_cat_spectra`` (K1,
the state solve, K9, K2 on x, y and z) at the flagship config (stereo
44.1 -> 48 kHz, L/M = 160/147, the five GAINS bands, full precision), and
``x`` a seeded stereo 1 s signal on the card.  The JAX entry runs its cat
program only on a TPU and its flat ``_forward`` elsewhere; the port's
kernels run on the card, and on the CPU as their plain versions, so ``fn``
is the cat program on either.  ``dryrun_multichip(n)`` is
``parallel/dryrun.dryrun_multichip``: every factorization of ``n`` shards
as a virtual mesh on one device, ending in a "dryrun_multichip OK" line.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .bench import FS, GAINS
from .config import EQConfig, PipelineConfig, SRCConfig
from .models.chain import AudioPipeline
from .parallel import dryrun


def entry(device=None):
    """(fn, (x,)): ``fn(x)`` -> (z frames (2, F_pad, 160), (mag_x, mag_y,
    mag_z)).  ``device``: the card unless "cpu" is asked."""
    cfg = PipelineConfig(src=SRCConfig(L=160, M=147),
                         eq=EQConfig.from_gains(GAINS))
    pipe = AudioPipeline(cfg, device=device)

    def fn(x):
        return pipe.forward_cat_spectra(x, FS)

    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        rng.standard_normal((2, FS)).astype(np.float32) * 0.5,
        device=pipe.device)
    return fn, (x,)


def dryrun_multichip(n_devices: int, device=None) -> list:
    """The sharded chain and stream over every factorization of
    ``n_devices`` shards (``parallel/dryrun.py``); prints its lines and
    "dryrun_multichip OK ..."."""
    return dryrun.dryrun_multichip(n_devices, device)


if __name__ == "__main__":
    sys.exit(dryrun.main())
