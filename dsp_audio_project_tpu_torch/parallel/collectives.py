"""The two collectives of the sharded chain and stream, over the block axis.

Counterparts of the JAX package's ``jax.lax.ppermute`` shift-by-one (the
FIR halo: ``parallel/pipeline.py:133-154``, ``streaming.py:643-664``) and
``jax.lax.all_gather`` (the IIR carry: ``pipeline.py:268``,
``streaming.py:723``).  ``block_axis(mesh, c)`` returns the block axis of
channel row c with one of two backends:

* ``LocalBlockAxis``: every block shard of the row lives in this process
  (a virtual mesh on one device, or a mesh over this host's devices); a
  shard receives its neighbour's own tensor, moved with ``.to(device)``;
* ``GroupBlockAxis``: one shard a rank (``distributed.multihost_mesh``);
  point-to-point through ``dist.batch_isend_irecv`` (every rank posts the
  ops that match its neighbours', an edge rank none for the neighbour it
  lacks) and ``dist.all_gather`` in the row's process group.  With two
  block shards or more every rank of the row joins each batch (an edge
  rank with one op, the others with two), as NCCL asks of a group's first
  P2P batch; a row of one shard posts none.  A gloo group takes CPU
  tensors and an NCCL group CUDA ones; the other pairing raises.

Both take and return the row's local shards as a list in block order
(``blocks``): all nb of them locally, the rank's one in a group.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DeviceMesh


class LocalBlockAxis:
    """The block axis of one channel row held in this process."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(devices)
        self.size = len(self.devices)
        self.blocks = tuple(range(self.size))

    def shift(self, parts: List[torch.Tensor], offset: int
              ) -> List[torch.Tensor]:
        """Shard b receives shard (b + offset)'s part (offset +1: from the
        next shard, -1: from the previous one); zeros where that shard does
        not exist, the ppermute's edge."""
        out = []
        for b, dev in enumerate(self.devices):
            src = b + offset
            out.append(parts[src].to(dev) if 0 <= src < self.size
                       else torch.zeros_like(parts[b]))
        return out

    def all_gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard receives the stack (nb, ...) of all shards' parts."""
        return [torch.stack([p.to(dev) for p in parts])
                for dev in self.devices]


def _check_backend(group, t: torch.Tensor) -> None:
    backend = dist.get_backend(group)
    if t.device.type != {"gloo": "cpu", "nccl": "cuda"}.get(backend):
        raise RuntimeError(
            f"a {backend} process group cannot carry {t.device.type} "
            "tensors: initialize with device='cuda' (NCCL) for a mesh on "
            "the cards, device='cpu' (gloo) for one on the CPU")


class GroupBlockAxis:
    """The block axis of a channel row whose shards are one a rank."""

    def __init__(self, group, ranks: Sequence[int], block: int):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.block = block
        self.blocks = (block,)

    def shift(self, parts: List[torch.Tensor], offset: int
              ) -> List[torch.Tensor]:
        (part,) = parts
        _check_backend(self.group, part)
        part = part.contiguous()
        b, nb = self.block, self.size
        ops = []
        if 0 <= b - offset < nb:        # the shard that receives mine
            ops.append(dist.P2POp(dist.isend, part, self.ranks[b - offset],
                                  self.group))
        if 0 <= b + offset < nb:
            got = torch.empty_like(part)
            ops.append(dist.P2POp(dist.irecv, got, self.ranks[b + offset],
                                  self.group))
        else:
            got = torch.zeros_like(part)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [got]

    def all_gather(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        (part,) = parts
        _check_backend(self.group, part)
        part = part.contiguous()
        out = [torch.empty_like(part) for _ in range(self.size)]
        dist.all_gather(out, part, group=self.group)
        return [torch.stack(out)]


def block_axis(mesh: DeviceMesh, c: int):
    """The collectives of channel row c's block axis on ``mesh``."""
    grid = mesh.process
    if grid is None:
        return LocalBlockAxis(mesh.devices[c])
    return GroupBlockAxis(grid.block_groups[c], grid.ranks[c],
                          grid.coords(grid.rank)[1])


def gather_grid(mesh: DeviceMesh,
                shards: Dict[Tuple[int, int], torch.Tensor]
                ) -> Dict[Tuple[int, int], torch.Tensor]:
    """Every shard of the mesh in this process: the local shards as they
    are, or, on a process-group mesh, one ``dist.all_gather`` over all
    ranks (the shards have one shape), as ``process_allgather`` does."""
    grid = mesh.process
    if grid is None:
        return dict(shards)
    ((_, part),) = shards.items()
    _check_backend(None, part)
    part = part.contiguous()
    out = [torch.empty_like(part) for _ in range(dist.get_world_size())]
    dist.all_gather(out, part)
    return {grid.coords(r): t for r, t in enumerate(out)}
