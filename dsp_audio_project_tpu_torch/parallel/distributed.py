"""Multi-process execution: one mesh shard per process.

Counterpart of ``dsp_audio_project_tpu/parallel/distributed.py``.  On a
host with several cards (or several hosts) each process drives one device,
the torch idiom for data on several GPUs; ``torch.distributed`` links
them.  The layout rules are the JAX package's:

* the ``block`` axis carries the halo and carry collectives, so it is laid
  inside a group of consecutive ranks (on one host: NVLink);
* the ``channel`` axis has no cross-shard math, so it spans the groups.

``initialize`` joins the process group: gloo for a mesh on the CPU, NCCL
for one on the cards, never one in place of the other.  ``multihost_mesh``
builds the (channel, block) mesh over every rank, one shard a rank, and
the block axis's process groups; ``parallel/pipeline.run_sharded`` runs on
it unchanged (``collectives.GroupBlockAxis``).  Every rank calls the same
functions in the same order.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..utils.device import default_device
from .mesh import DeviceMesh, ProcessGrid


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device=None,
) -> torch.device:
    """Join the process group; returns this process's device.

    ``coordinator_address``: "host:port" (TCP, rank 0 listens) or an init
    URL ("tcp://...", "file://..."; a file rendezvous needs no free port).
    ``device``: "cpu" runs the mesh on the CPU over gloo; None (the card)
    or a CUDA device runs it on the cards over NCCL, rank r on card
    r % device_count, and raises without one.  A process already in a
    group keeps it (the JAX package's "already initialized" no-op).
    """
    if device is None:
        device = default_device("initialize")
    device = torch.device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(device.type)
    if backend is None:
        raise ValueError(f"no process-group backend for {device}")
    if dist.is_initialized() and dist.get_backend() != backend:
        raise RuntimeError(
            f"this process is already in a {dist.get_backend()} group; a "
            f"mesh on {device.type} needs {backend}")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    return device


def multihost_mesh(channel_hosts: Optional[int] = None,
                   cfg: Optional[MeshConfig] = None) -> DeviceMesh:
    """The (channel, block) mesh over every rank, one shard a rank.

    Ranks fill the grid host-major, as ``jax.devices()`` orders them: the
    block axis within a group of consecutive ranks, the channel axis across
    the ``channel_hosts`` groups (default: one row a rank).  Creates the
    block axis's process group of every channel row (every rank creates
    every group, in the same order).  The shards' devices follow the
    backend ``initialize`` chose: the CPU under gloo, card r % device_count
    under NCCL.
    """
    if not dist.is_initialized():
        raise RuntimeError("call distributed.initialize first")
    cfg = cfg or MeshConfig()
    world = dist.get_world_size()
    ch = channel_hosts if channel_hosts is not None else world
    if ch < 1 or world % ch:
        raise ValueError(f"channel_hosts={ch} must divide the process "
                         f"count {world}")
    block = world // ch
    ranks = tuple(tuple(range(c * block, (c + 1) * block)) for c in range(ch))
    groups = tuple(dist.new_group(list(row)) for row in ranks)
    if dist.get_backend() == "nccl":
        n_dev = torch.cuda.device_count()
        devices = tuple(tuple(torch.device("cuda", r % n_dev) for r in row)
                        for row in ranks)
    else:
        devices = tuple(tuple(torch.device("cpu") for _ in row)
                        for row in ranks)
    return DeviceMesh(devices, (cfg.channel_axis, cfg.block_axis),
                      ProcessGrid(ranks, dist.get_rank(), groups))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that should do I/O and logging."""
    return not dist.is_initialized() or dist.get_rank() == 0
