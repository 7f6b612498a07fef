"""Multi-process execution: one mesh shard per process.

Counterpart of ``dsp_audio_project_tpu/parallel/distributed.py``.  On a
host with several cards (or several hosts) each process drives one device,
the torch idiom for data on several GPUs; ``torch.distributed`` links
them.  The layout rules are the JAX package's:

* the ``block`` axis carries the halo and carry collectives, so it is laid
  inside a group of consecutive ranks (on one host: NVLink);
* the ``channel`` axis has no cross-shard math, so it spans the groups.

``initialize`` joins the process group: gloo for a mesh on the CPU, NCCL
for one on the cards, never one in place of the other.  With no
coordinator it reads the launcher's environment (``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), as the
JAX ``initialize`` detects a pod.  ``multihost_mesh`` builds the (channel,
block) mesh over every rank, one shard a rank, and the block axis's
process groups; ``parallel/pipeline.run_sharded`` runs on it unchanged
(``collectives.GroupBlockAxis``).  Every rank calls the same functions in
the same order.
"""
from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..utils.device import default_device
from .mesh import DeviceMesh, ProcessGrid


LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def card_index(rank: int, local_rank: Optional[int], count: int) -> int:
    """The card of a rank under NCCL: the launcher's ``LOCAL_RANK`` where it
    gives one (ranks fill a host's cards in order), else ``rank % count``
    (processes started by hand on one host).  A ``ValueError`` when the
    local rank names a card this host lacks."""
    if count < 1:
        raise ValueError("no CUDA device for an NCCL rank")
    if local_rank is None:
        return rank % count
    if not 0 <= local_rank < count:
        raise ValueError(f"LOCAL_RANK={local_rank} but this host has "
                         f"{count} card(s)")
    return local_rank


def launcher_env(environ: Mapping[str, str]) -> Optional[dict]:
    """(rank, world size, local rank or None) from a ``torchrun``-style
    environment, or None when a variable of ``LAUNCHER_ENV`` is missing."""
    if any(k not in environ for k in LAUNCHER_ENV):
        return None
    local = environ.get("LOCAL_RANK")
    return {"rank": int(environ["RANK"]),
            "world": int(environ["WORLD_SIZE"]),
            "local_rank": None if local is None else int(local)}


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> torch.device:
    """Join the process group; returns this process's device.

    With no ``coordinator_address`` the launcher's environment names the
    group (``env://``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``, and ``LOCAL_RANK`` where given); without it either,
    a ``ValueError``, as the JAX ``initialize`` raises off a pod.
    ``coordinator_address``: "host:port" (TCP, rank 0 listens) or an init
    URL ("tcp://...", "file://..."; a file rendezvous needs no free port),
    with ``num_processes`` and ``process_id``.  ``device``: "cpu" runs the
    mesh on the CPU over gloo; None (the card) or a CUDA device runs it on
    the cards over NCCL, on card ``card_index(rank, LOCAL_RANK, count)``
    unless ``device`` names one, and raises without one; the group is bound
    to that card when it is made, so no collective runs on another.  A
    process already in a group keeps it (the JAX package's "already
    initialized" no-op).
    """
    if device is None:
        device = default_device("initialize")
    device = torch.device(device)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(device.type)
    if backend is None:
        raise ValueError(f"no process-group backend for {device}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"this process is already in a {dist.get_backend()} group; "
                f"a mesh on {device.type} needs {backend}")
        return (torch.device("cuda", torch.cuda.current_device())
                if device.type == "cuda" else device)
    env = launcher_env(os.environ)
    if coordinator_address is None:
        if env is None:
            raise ValueError(
                "no coordinator_address and no launcher environment "
                f"({', '.join(LAUNCHER_ENV)}): start the processes with "
                "torchrun, or pass coordinator_address, num_processes and "
                "process_id")
        url, world, rank = "env://", env["world"], env["rank"]
        for given, have, name in ((num_processes, world, "num_processes"),
                                  (process_id, rank, "process_id")):
            if given is not None and given != have:
                raise ValueError(f"{name}={given} but the launcher says "
                                 f"{have}")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes "
                             "and process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", card_index(
                rank, env["local_rank"] if env else None,
                torch.cuda.device_count()))
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=url, world_size=world, rank=rank,
        device_id=device if device.type == "cuda" else None)
    return device


def multihost_mesh(channel_hosts: Optional[int] = None,
                   cfg: Optional[MeshConfig] = None) -> DeviceMesh:
    """The (channel, block) mesh over every rank, one shard a rank.

    Ranks fill the grid host-major, as ``jax.devices()`` orders them: the
    block axis within a group of consecutive ranks, the channel axis across
    the ``channel_hosts`` groups (default: one row a rank).  Creates the
    block axis's process group of every channel row (every rank creates
    every group, in the same order).  The shards' devices follow the
    backend ``initialize`` chose: the CPU under gloo, under NCCL each
    rank's own card (one object all-gather of the card indices).
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
        cards = [None] * world
        dist.all_gather_object(cards, torch.cuda.current_device())
        devices = tuple(tuple(torch.device("cuda", cards[r]) for r in row)
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
