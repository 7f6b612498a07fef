"""Where a call runs (the card unless the caller asks for the CPU), the
per-device cache of host-built constant tables, the CUDA-graph capture
protocol the port's captures share, and ``CompiledForward``, the graph
runner behind ``AudioPipeline.jit_forward_*``.

The port's entry points take ``device=None``.  A tensor stays on its own
device; any other input (a numpy array, a list) goes to the card, and the
call raises when no CUDA device is visible; an explicit ``device`` (the
CPU tests pass ``device="cpu"``) moves the input there.
"""
from __future__ import annotations

import gc
from typing import Callable, Hashable

import numpy as np
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


def capture_graph(fn, device=None):
    """(graph, fn()'s output): ``fn`` captured into one CUDA graph on
    ``device`` (the current card when None), with automatic garbage
    collection off.  The capture runs with ``device`` current and on a new
    stream of that card: ``torch.cuda.graph``'s default capture stream is
    made once, on the card current at the process's first capture, and a
    capture there would record none of the work that the kernels launch on
    another card's stream.  A collection inside a capture may destroy
    graphs or pinned buffers that cyclic garbage holds, which invalidates
    the capture (``torch.cuda.graph`` collects just before it begins).
    Warm ``fn`` up first (``warm_up``)."""
    graph = torch.cuda.CUDAGraph()
    gc_enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device), torch.cuda.graph(
                graph, stream=torch.cuda.Stream(device)):
            out = fn()
    finally:
        if gc_enabled:
            gc.enable()
    return graph, out


SLOTS = 2   # graph slots an entry hands out before it copies its outputs


def _uses(t: torch.Tensor) -> int:
    """References to ``t``'s storage (PyTorch's cudagraph trees test the
    same count before they reuse an output)."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


def _arg_leaves(arg) -> tuple[list, Callable]:
    """(leaves, rebuild) of one call argument: a NamedTuple (operators,
    tables) is walked field by field; anything else (a tensor, an array, a
    list of samples, None) is one leaf.  ``rebuild(iterator)`` puts the
    argument back together from an iterator over new leaves."""
    if isinstance(arg, tuple) and hasattr(arg, "_fields"):
        parts = [_arg_leaves(a) for a in arg]
        return ([t for p in parts for t in p[0]],
                lambda it: type(arg)(*[p[1](it) for p in parts]))
    return [arg], lambda it: next(it)


def _load(inputs: list, leaves: list) -> None:
    """Copy each leaf into its static buffer (on the current stream)."""
    for buf, leaf in zip(inputs, leaves):
        if buf is not None:
            buf.copy_(leaf if isinstance(leaf, torch.Tensor)
                      else torch.as_tensor(leaf))


def _output_leaves(out) -> tuple[list, Callable]:
    """(tensor leaves, rebuild) of a forward's result: nested tuples,
    NamedTuples and lists of tensors; other values pass through."""
    if isinstance(out, torch.Tensor):
        return [out], lambda it: next(it)
    if isinstance(out, (tuple, list)):
        parts = [_output_leaves(o) for o in out]

        def rebuild(it):
            vals = [p[1](it) for p in parts]
            if isinstance(out, list):
                return vals
            return type(out)(*vals) if hasattr(out, "_fields") else tuple(vals)
        return [t for p in parts for t in p[0]], rebuild
    return [], lambda it: out


def _spec(leaf):
    """A leaf's part of an entry's key: None, or (shape, dtype); an array
    or a list becomes float32, as the forwards take it."""
    if leaf is None:
        return None
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    return tuple(np.shape(leaf)), torch.float32


class _Slot:
    """One captured graph of an entry: its static input buffers, its
    outputs, the tensors its graph reads that it must keep alive, and the
    use count of each output's storage while only the slot holds it."""

    def __init__(self, inputs: list, graph, out, keep: tuple):
        self.inputs, self.graph, self.keep = inputs, graph, keep
        self.outs, self.rebuild = _output_leaves(out)
        self.base = [_uses(t) for t in self.outs]

    def held(self) -> bool:
        """True while a tensor the caller holds shares an output's
        storage."""
        return any(_uses(t) > b for t, b in zip(self.outs, self.base))

    def result(self, copy: bool):
        outs = [t.clone() if copy else t.detach() for t in self.outs]
        return self.rebuild(iter(outs))


class CompiledForward:
    """``fn(*args, static)`` as one CUDA graph per (shapes of ``args``,
    ``static``): the counterpart of a ``jax.jit`` callable whose last
    argument is static.

    On a CUDA ``device`` the first call of a key (an entry) allocates
    static input buffers, copies the arguments in, runs ``fn`` twice on a
    side stream (``warm_up``: kernel builds, table uploads, a rate's
    design) and captures it (``capture_graph``); every call copies its
    arguments into the buffers (a tensor, or an array as ``jax.jit``
    takes it; a NamedTuple of tensors field by field, so operators
    rewritten in place between calls are read anew) and replays the graph
    with one host call, all with ``device`` current, so an entry on
    another card than the current one records and replays its own card's
    work.  Nothing is keyed by an address.  A failed capture
    raises; no call runs ``fn`` eagerly on the card.  Host-side code inside
    ``fn`` (stage spans, Python checks) runs only at warm-up and capture.

    Outputs: a replay rewrites its graph's output tensors, while a result
    the caller holds must not change.  An entry hands out up to ``SLOTS``
    graphs, captured as needed, each returning its own outputs (no copy);
    a slot is replayed only when no live tensor shares its outputs'
    storage.  When every slot is held, one more graph runs and its outputs
    are cloned on the stream (``copies`` counts those calls).  Each slot
    keeps the tensors ``keep()`` returned at its capture (the module's
    buffers), so a table that a later rate or shape replaces stays alive
    for the graph that reads it.

    On any other device a call is ``fn(*args, static)``: graphs are CUDA's
    and the caller asked for that device.  ``_cache_size()`` counts the
    keys seen, as a ``jax.jit`` callable's does.
    """

    def __init__(self, fn: Callable, device, name: str,
                 keep: Callable[[], tuple] = tuple):
        self.fn, self.name, self.keep = fn, name, keep
        self.device = torch.device(device)
        self.captures = 0
        self.copies = 0
        self._entries: dict = {}

    def _cache_size(self) -> int:
        return len(self._entries)

    def __call__(self, *args):
        if not args:
            raise TypeError(f"{self.name} takes its arguments and a static "
                            "last one")
        *dyn, static = args
        parts = [_arg_leaves(a) for a in dyn]
        leaves = [v for p in parts for v in p[0]]

        def rebuild(it):
            return [p[1](it) for p in parts]

        key: Hashable = (tuple(_spec(v) for v in leaves), static)
        if self.device.type != "cuda":
            self._entries.setdefault(key, None)
            return self.fn(*args)
        with torch.cuda.device(self.device):
            return self._replay(key, leaves, rebuild, static)

    def _replay(self, key, leaves: list, rebuild: Callable, static):
        """The CUDA path of a call, with ``self.device`` current: the input
        copies, a capture where the entry needs one, the replay and any
        output copy all go to that card's current stream."""
        entry = self._entries.setdefault(key, {"slots": [], "spare": None})
        slots = entry["slots"]
        slot = next((s for s in slots if not s.held()), None)
        copy = slot is None and len(slots) >= SLOTS
        if copy:
            slot = entry["spare"]
        if slot is None:
            slot = self._capture(leaves, rebuild, static)
            if copy:
                entry["spare"] = slot
            else:
                slots.append(slot)
        _load(slot.inputs, leaves)
        slot.graph.replay()
        self.copies += copy
        return slot.result(copy)

    def _capture(self, leaves: list, rebuild: Callable, static) -> _Slot:
        inputs = [None if v is None else torch.empty(
            spec[0], dtype=spec[1], device=self.device)
            for v, spec in ((v, _spec(v)) for v in leaves)]
        _load(inputs, leaves)

        def call():
            return self.fn(*rebuild(iter(inputs)), static)

        try:
            warm_up(call, self.device)
            graph, out = capture_graph(call, self.device)
        except Exception as err:
            raise RuntimeError(f"{self.name}: the CUDA graph capture at "
                               f"{static!r} failed: {err}") from err
        self.captures += 1
        return _Slot(inputs, graph, out, self.keep())
