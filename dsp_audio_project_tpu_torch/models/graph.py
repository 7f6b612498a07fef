"""Composable processing graphs: chains of DSP stages on torch tensors.

`AudioPipeline` (chain.py) is the fixed reference cascade (SRC -> EQ).  Real
deployments compose more: multi-stage rate ladders (44.1k -> 8k -> 44.1k
"telephone" effects), EQ before and after conversion, gain staging.  A
``Chain`` is itself a ``Stage``, so graphs nest.

Every stage maps ``(x, fs) -> (y, fs_out)`` on (..., N) float32 tensors
with a rate transform known on the host (``output_rate``).  The JAX
package's ``Chain`` traces its stages into one XLA program; this one runs
them in turn, each on the device of its input: ``Resample`` through the
frames kernel (``ops/src.resample``), ``Equalize`` through the block EQ
(``ops/eq.equalize``), the rest as torch elementwise ops.  Nothing reads a
value back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import EQConfig, KernelConfig, SRCConfig
from ..ops.eq import equalize
from ..ops.src import resample
from ..utils.device import as_input


class Stage:
    """Interface: ``apply`` on a tensor; ``output_rate`` on the host."""

    def apply(self, x: torch.Tensor, fs: int) -> Tuple[torch.Tensor, int]:
        raise NotImplementedError

    def output_rate(self, fs: int) -> int:
        return fs


@dataclasses.dataclass(frozen=True)
class Resample(Stage):
    """L/M rate conversion (reference C5 semantics)."""

    config: SRCConfig

    def apply(self, x, fs):
        return resample(x, fs, self.config)

    def output_rate(self, fs):
        return self.config.output_rate(fs) if not self.config.bypass else fs


@dataclasses.dataclass(frozen=True)
class Equalize(Stage):
    """6-band peaking-EQ cascade (reference C8 semantics)."""

    config: EQConfig
    kernels: KernelConfig = KernelConfig()

    def apply(self, x, fs):
        return (
            equalize(x, fs, self.config, block=self.kernels.iir_block,
                     unroll=self.kernels.iir_unroll),
            fs,
        )


@dataclasses.dataclass(frozen=True)
class Gain(Stage):
    """Scalar gain in dB (the float32 factor, as the JAX stage)."""

    db: float

    def apply(self, x, fs):
        return x * float(np.float32(10.0 ** (self.db / 20.0))), fs


@dataclasses.dataclass(frozen=True)
class Clip(Stage):
    """Hard clip to [-limit, limit] (the reference clips at 1.0)."""

    limit: float = 1.0

    def apply(self, x, fs):
        return torch.clamp(x, -self.limit, self.limit), fs


@dataclasses.dataclass(frozen=True)
class Normalize(Stage):
    """Peak-normalize when the peak exceeds ``guard`` (C1 semantics); the
    test stays on the device (``torch.where``, no host sync)."""

    guard: float = 1e-6

    def apply(self, x, fs):
        peak = x.abs().amax()
        scale = torch.where(peak > self.guard, 1.0 / peak,
                            torch.ones_like(peak))
        return x * scale, fs


class Chain(Stage):
    """A sequence of stages, run in turn.

    Usage:
        telephone = Chain([
            Resample(SRCConfig(L=20, M=147, taps_rule_factor=4)),  # 44.1k->6k
            Equalize(EQConfig.from_gains({"Low Mids": 6})),
            Resample(SRCConfig(L=147, M=20, taps_rule_factor=4)),  # back up
            Clip(),
        ])
        y, fs_out = telephone(x, 44100)

    ``device`` as every entry point of the port: an array goes to the card
    (raising without one), a tensor stays on its device, ``device="cpu"``
    (or another device) moves the input there.
    """

    def __init__(self, stages: Sequence[Stage], device=None):
        self.stages = tuple(stages)
        self.device = device

    def _forward(self, x, fs):
        for stage in self.stages:
            x, fs = stage.apply(x, fs)
        return x

    def apply(self, x, fs):
        return self._forward(x, fs), self.output_rate(fs)

    def output_rate(self, fs: int) -> int:
        for stage in self.stages:
            fs = stage.output_rate(fs)
        return fs

    def __call__(self, x, fs: int) -> Tuple[torch.Tensor, int]:
        x = as_input(x, self.device, "Chain")
        return self._forward(x, fs), self.output_rate(fs)
