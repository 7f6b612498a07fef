"""The (channel, block) device mesh of the sharded chain and the streams.

Counterpart of ``dsp_audio_project_tpu/parallel/mesh.py``.  The workload's
parallel axes are ``channel`` (independent audio channels, no cross-device
math) and ``block`` (contiguous time spans, whose FIR halos and IIR carries
cross shard boundaries through ``collectives.py``).

A ``DeviceMesh`` is a grid of torch devices.  The grid may repeat a device:
a "virtual" mesh of several shards on one card (or on the CPU), the
counterpart of JAX's forced host device count, runs the real halo exchange,
gather and carry algebra with one device.  A mesh built by
``distributed.multihost_mesh`` holds one shard per process
(``ProcessGrid``): its collectives go through ``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..config import MeshConfig
from ..utils.device import default_device

CHANNEL_AXIS = "channel"
BLOCK_AXIS = "block"


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessGrid:
    """The process layout of a mesh with one shard per rank: ``ranks[c][b]``
    is the global rank holding shard (c, b), ``rank`` this process's, and
    ``block_groups[c]`` the process group of channel row c (the block
    axis's collectives)."""

    ranks: tuple
    rank: int
    block_groups: tuple

    def coords(self, rank: int) -> Tuple[int, int]:
        for c, row in enumerate(self.ranks):
            if rank in row:
                return c, row.index(rank)
        raise ValueError(f"rank {rank} holds no shard of this mesh")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A grid of torch devices with named axes, as ``jax.sharding.Mesh``:
    ``devices`` is a (channel, block) tuple of tuples; ``shape`` maps each
    axis name to its size.  ``process`` is None when every shard lives in
    this process, else the ``ProcessGrid`` of a one-shard-a-rank mesh."""

    devices: tuple
    axis_names: tuple = (CHANNEL_AXIS, BLOCK_AXIS)
    process: Optional[ProcessGrid] = None

    @property
    def shape(self) -> Mapping[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def device_of(self, c: int, b: int) -> torch.device:
        """The device of shard (c, b)."""
        return self.devices[c][b]

    @property
    def shared(self) -> bool:
        """Whether every shard lives in this process on one device."""
        return (self.process is None
                and len({d for row in self.devices for d in row}) == 1)

    @property
    def device(self) -> torch.device:
        """The one device of a mesh whose shards share it (a 1x1 mesh, or a
        virtual one); a ValueError for a mesh over several devices."""
        if not self.shared:
            raise ValueError("this mesh spans several devices or processes; "
                             "ask device_of(c, b) for a shard's device")
        return self.devices[0][0]

    @property
    def local_shards(self) -> Tuple[Tuple[int, int], ...]:
        """The (c, b) shards held by this process, channel-major."""
        if self.process is not None:
            return (self.process.coords(self.process.rank),)
        return tuple((c, b) for c in range(len(self.devices))
                     for b in range(len(self.devices[0])))


def build_mesh(cfg: Optional[MeshConfig] = None,
               devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (channel, block) mesh over ``devices`` (default: every CUDA device,
    raising without one), filled channel-major as JAX fills its grid.  The
    list may repeat a device (a virtual mesh): ``devices=["cpu"] * 8``
    builds every factorization of 8 on the CPU.  Without ``cfg`` the mesh
    is 1 x len(devices)."""
    if devices is None:
        default_device("build_mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if cfg is None:
        cfg = MeshConfig(channel_devices=1, block_devices=len(devs))
    mc, mb = cfg.channel_devices, cfg.block_devices
    if mc < 1 or mb < 1:
        raise ValueError(f"mesh shape must be positive, got {mc}x{mb}")
    if mc * mb > len(devs):
        raise ValueError(f"mesh needs {mc * mb} devices, have {len(devs)}")
    grid = tuple(tuple(devs[c * mb:(c + 1) * mb]) for c in range(mc))
    return DeviceMesh(grid, (cfg.channel_axis, cfg.block_axis))


def single_device_mesh(device=None) -> DeviceMesh:
    """1x1 mesh on ``device`` (the card unless the caller asks for another,
    e.g. ``device="cpu"``)."""
    if device is None:
        device = default_device("single_device_mesh")
    return DeviceMesh(((torch.device(device),),))


def _shard_size(total: int, parts: int, what: str) -> int:
    if total % parts:
        raise ValueError(f"{what} {total} does not split into {parts} shards")
    return total // parts


def shard_signal(mesh: DeviceMesh, x: torch.Tensor
                 ) -> Dict[Tuple[int, int], torch.Tensor]:
    """Split a (C_pad, N_pad) signal into this process's shards, the
    counterpart of ``signal_sharding``: channels over ``channel``, time
    over ``block``.  Returns {(c, b): the (C_pad / mc, N_pad / mb) slice
    on shard (c, b)'s device} (a view where the device is x's)."""
    mc, mb = len(mesh.devices), len(mesh.devices[0])
    rows = _shard_size(x.shape[0], mc, "channel count")
    cols = _shard_size(x.shape[-1], mb, "length")
    return {(c, b): x[c * rows:(c + 1) * rows,
                      b * cols:(b + 1) * cols].to(mesh.device_of(c, b))
            for c, b in mesh.local_shards}


def unshard_signal(shards: Mapping[Tuple[int, int], torch.Tensor]
                   ) -> torch.Tensor:
    """Put a full grid of shards (every (c, b) of the mesh; on a
    process-group mesh ``collectives.gather_grid`` collects them first)
    back together on shard (0, 0)'s device; a 1x1 grid's shard comes back
    as it is, not copied."""
    mc = 1 + max(c for c, _ in shards)
    mb = 1 + max(b for _, b in shards)
    device = shards[(0, 0)].device
    rows = []
    for c in range(mc):
        parts = [shards[(c, b)].to(device) for b in range(mb)]
        rows.append(parts[0] if mb == 1 else torch.cat(parts, -1))
    return rows[0] if mc == 1 else torch.cat(rows, 0)
