"""Where a call runs (the card unless the caller asks for the CPU), the
per-device cache of host-built constant tables, and the CUDA-graph capture
protocol the port's captures share.

The port's entry points take ``device=None``.  A tensor stays on its own
device; any other input (a numpy array, a list) goes to the card, and the
call raises when no CUDA device is visible; an explicit ``device`` (the
CPU tests pass ``device="cpu"``) moves the input there.
"""
from __future__ import annotations

import gc

import torch


def default_device(what: str) -> torch.device:
    """The card, or a RuntimeError naming ``what`` when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the GPU by default and no CUDA device is "
            "visible; pass device='cpu' to run the plain versions of the "
            "kernels on the CPU")
    return torch.device("cuda")


def as_input(x, device=None, what: str = "this call") -> torch.Tensor:
    """``x`` as a float32 tensor on the device the call runs on (see the
    module note); a float32 tensor already there comes back as it is."""
    if device is None:
        device = (x.device if isinstance(x, torch.Tensor)
                  else default_device(what))
    return torch.as_tensor(x, dtype=torch.float32, device=device)


_tables: dict = {}


def device_tables(table, *args, device):
    """``table(*args)`` — a host array, or a tuple of them, from a cached
    builder — as tensors on ``device``, cached per (builder, args, device)."""
    key = (table, args, str(device))
    hit = _tables.get(key)
    if hit is None:
        host = table(*args)
        hit = (tuple(torch.as_tensor(a, device=device) for a in host)
               if isinstance(host, tuple)
               else torch.as_tensor(host, device=device))
        _tables[key] = hit
    return hit


def warm_up(fn, device=None) -> None:
    """``fn()`` twice on a side stream joined to the current one both ways:
    the lazy initializations a CUDA-graph capture must not see."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    cur.wait_stream(side)


def capture_graph(fn):
    """(graph, fn()'s output): ``fn`` captured into one CUDA graph, with
    automatic garbage collection off.  A collection inside a capture may
    destroy graphs or pinned buffers that cyclic garbage holds, which
    invalidates the capture (``torch.cuda.graph`` collects just before it
    begins).  Warm ``fn`` up first (``warm_up``)."""
    graph = torch.cuda.CUDAGraph()
    gc_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        if gc_enabled:
            gc.enable()
    return graph, out
