"""The (channel, block) device mesh of the sharded stream, one card for now.

Counterpart of ``dsp_audio_project_tpu/parallel/mesh.py``.  The workload's
parallel axes are ``channel`` (independent audio channels, no cross-device
math) and ``block`` (contiguous time spans, whose FIR halos and IIR carries
cross device boundaries).  The port's ``ShardedStreamProcessor`` runs on a
1x1 mesh: one device, where the block axis is degenerate and the halo
exchange and the all-gather of the carries reduce to the identity.  Meshes
over several cards (torch.distributed process groups, the halo as
send/recv, the carries' all-gather) are ROADMAP Queue 1 slice 7;
``build_mesh`` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import torch

from ..config import MeshConfig
from ..utils.device import default_device

CHANNEL_AXIS = "channel"
BLOCK_AXIS = "block"


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A grid of torch devices with named axes, as ``jax.sharding.Mesh``:
    ``devices`` is a (channel, block) tuple of tuples; ``shape`` maps each
    axis name to its size."""

    devices: tuple
    axis_names: tuple = (CHANNEL_AXIS, BLOCK_AXIS)

    @property
    def shape(self) -> Mapping[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def device(self) -> torch.device:
        """The one device of a 1x1 mesh."""
        if len(self.devices) * len(self.devices[0]) != 1:
            raise NotImplementedError(
                "meshes over several devices are ROADMAP slice 7")
        return self.devices[0][0]


def build_mesh(cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (channel, block) mesh over the given devices (default: every CUDA
    device, raising without one).  Only 1x1 is built: any other shape
    raises ``NotImplementedError`` (ROADMAP slice 7)."""
    if devices is None:
        default_device("build_mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if cfg is None:
        cfg = MeshConfig(channel_devices=1, block_devices=len(devs))
    n = cfg.channel_devices * cfg.block_devices
    if n > len(devs):
        raise ValueError(f"mesh needs {n} devices, have {len(devs)}")
    if n != 1:
        raise NotImplementedError(
            f"a {cfg.channel_devices}x{cfg.block_devices} mesh needs the "
            "multi-device stream (halo send/recv, the carries' all-gather "
            "over torch.distributed), which is ROADMAP slice 7; the port "
            "builds 1x1 meshes only")
    return DeviceMesh(((devs[0],),), (cfg.channel_axis, cfg.block_axis))


def single_device_mesh(device=None) -> DeviceMesh:
    """1x1 mesh on ``device`` (the card unless the caller asks for another,
    e.g. ``device="cpu"``)."""
    if device is None:
        device = default_device("single_device_mesh")
    return DeviceMesh(((torch.device(device),),))
