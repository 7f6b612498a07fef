"""The port's compiled forwards (``AudioPipeline.jit_forward_*``) on the CPU.

Each of the eleven methods returns a callable cached on the module; on
``device="cpu"`` it runs the eager forward of the same name, so its result
equals that forward bit for bit.  Against the JAX package's callable of
the same name on the same numpy inputs (Pallas in interpret mode, the
serving precision src_fast = eq_fast = True): every output > 90 dB, the
bound of ``tests/test_torch_chain.py`` (the JAX bf16x3 products measure
~100 dB; the port is float32).  ``jit_forward_frames_dynamic`` is held
against the JAX ``jit_forward_frames_dynamic_ops`` on the JAX host
builder's operators for the same gains: the JAX method of the same name
traces its device builder, whose XLA:CPU compile takes 100-180 s here
(``tests/test_torch_chain_dynamic.py`` keeps out of it for that reason);
the two builders agree to float32 rounding.

The graph slots, their ownership test and the argument walk of
``utils/device.CompiledForward`` run on CPU tensors here; the replays
themselves are CUDA's (``tests/test_torch_gpu.py``).  Batch 2 x 8192
samples at 44.1 kHz.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dsp_audio_project_tpu as jpkg
import dsp_audio_project_tpu_torch as pt
from dsp_audio_project_tpu.config import KernelConfig as JKernelConfig
from dsp_audio_project_tpu_torch.oracle import snr_db
from dsp_audio_project_tpu_torch.utils import device as tdevice

torch.set_num_threads(2)

FS = 44100
N = 8192
GAINS = {"Sub-Bass": 6, "Bass": -3, "High Mids": 12, "Presence": -15,
         "Brilliance": 4}
DYN_GAINS = (6.0, -3.0, 0.0, 12.0, -15.0, 4.0)
METHODS = ("jit_forward", "jit_forward_frames", "jit_forward_frames_spectra",
           "jit_forward_spectra", "jit_forward_flat",
           "jit_forward_flat_spectra", "jit_forward_cat",
           "jit_forward_cat_spectra", "jit_forward_frames_dynamic",
           "jit_forward_frames_dynamic_ops", "jit_forward_cat_dynamic_ops")
EXPLICIT = {"fir_path": "pallas", "iir_path": "pallas"}


def make_x(batch=2, n=N, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal((batch, n))
    return (x / np.abs(x).max()).astype(np.float32)


def port_pipe(**kernels):
    return pt.AudioPipeline(pt.PipelineConfig(
        src=pt.SRCConfig(L=160, M=147), eq=pt.EQConfig.from_gains(GAINS),
        kernels=pt.KernelConfig(src_fast=True, eq_fast=True, **kernels)),
        device="cpu")


def jax_pipe(**kernels):
    return jpkg.AudioPipeline(jpkg.PipelineConfig(
        src=jpkg.SRCConfig(L=160, M=147), eq=jpkg.EQConfig.from_gains(GAINS),
        kernels=JKernelConfig(src_fast=True, eq_fast=True, interpret=True,
                              **kernels)))


def eager_of(pipe, method):
    return getattr(pipe, "_forward" if method == "jit_forward"
                   else method[len("jit_"):])


def port_args(pipe, method, x, gains=DYN_GAINS, fs=FS):
    if method == "jit_forward_frames_dynamic":
        return x, torch.tensor(gains), fs
    if method.endswith("_dynamic_ops"):
        ops = pipe.dynamic_eq_operators(np.asarray(gains), fs, x.shape[-1],
                                        builder="host")
        if method == "jit_forward_cat_dynamic_ops":
            return x, ops, pipe.dynamic_cat_tables(ops), fs
        return x, ops, fs
    return x, fs


def leaves(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in leaves(o)]
    return [out]


@pytest.mark.parametrize("method", METHODS)
def test_compiled_forward_is_the_eager_forward_on_cpu(method):
    """On the CPU a call is the eager forward: equal bit for bit, numpy x
    taken, a held result untouched by a later call on another batch."""
    pipe = port_pipe()
    fn = getattr(pipe, method)()
    x1, x2 = make_x(seed=1), make_x(seed=2)
    got = fn(*port_args(pipe, method, x1))
    want = eager_of(pipe, method)(*port_args(pipe, method, torch.as_tensor(x1)))
    assert len(leaves(got)) == len(leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        assert a.device.type == "cpu" and torch.equal(a, b)
    kept = [t.clone() for t in leaves(got)]
    fn(*port_args(pipe, method, torch.as_tensor(x2), gains=DYN_GAINS[::-1]))
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), kept))


def jax_result(method, x):
    """The JAX package's callable of the same name on numpy x (for
    frames_dynamic, see the module note)."""
    jp = jax_pipe(**(EXPLICIT if method == "explicit" else {}))
    xj = jnp.asarray(x)
    if method.endswith("_dynamic_ops") or method == "jit_forward_frames_dynamic":
        ops = jp.dynamic_eq_operators(np.asarray(DYN_GAINS), FS, x.shape[-1],
                                      builder="host")
        if method == "jit_forward_cat_dynamic_ops":
            return jp.jit_forward_cat_dynamic_ops()(
                xj, ops, jp.dynamic_cat_tables(ops), FS)
        return jp.jit_forward_frames_dynamic_ops()(xj, ops, FS)
    name = "jit_forward" if method == "explicit" else method
    return getattr(jp, name)()(xj, FS)


@pytest.mark.parametrize("method", METHODS + ("explicit",))
def test_compiled_forward_matches_jax(method):
    x = make_x(seed=3)
    pipe = port_pipe(**(EXPLICIT if method == "explicit" else {}))
    name = "jit_forward" if method == "explicit" else method
    got = getattr(pipe, name)()(*port_args(pipe, name, x))
    want = jax_result(method, x)
    assert len(leaves(got)) == len(leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        assert snr_db(b.ravel(), a.numpy().ravel()) > 90


def test_compiled_forwards_are_cached_per_method():
    pipe = port_pipe()
    fns = [getattr(pipe, m)() for m in METHODS]
    assert all(getattr(pipe, m)() is f for m, f in zip(METHODS, fns))
    assert len({id(f) for f in fns}) == len(METHODS)
    assert port_pipe().jit_forward_cat() is not fns[METHODS.index(
        "jit_forward_cat")]


def test_fs_is_static():
    """One entry per (input shapes, fs): two rates, two entries; another
    batch of the same shape, none more; another length, one more."""
    pipe = port_pipe()
    fn = pipe.jit_forward_cat_spectra()
    x = make_x()
    for fs in (FS, 48000, FS):
        z, mags = fn(x, fs)
        want_z, want_m = pipe.forward_cat_spectra(x, fs)
        assert torch.equal(z, want_z)
        assert all(torch.equal(a, b) for a, b in zip(mags, want_m))
    assert fn._cache_size() == 2
    fn(make_x(seed=9), FS)
    assert fn._cache_size() == 2
    fn(make_x(n=N + 1000), FS)
    assert fn._cache_size() == 3


def test_dynamic_ops_key_by_shape_not_address():
    """Two operator sets of one shape share an entry, and each call reads
    the operators it is given."""
    pipe = port_pipe()
    fn = pipe.jit_forward_frames_dynamic_ops()
    x = torch.as_tensor(make_x(seed=4))
    outs = []
    for gains in (DYN_GAINS, DYN_GAINS[::-1]):
        args = port_args(pipe, "jit_forward_frames_dynamic_ops", x, gains)
        outs.append(fn(*args)[0])
        assert torch.equal(outs[-1], pipe.forward_frames_dynamic_ops(*args)[0])
    assert fn._cache_size() == 1 and not torch.equal(*outs)


def test_graph_slot_knows_when_an_output_is_held():
    """``_Slot.held``: the storage use count of each output against its
    count at capture.  An alias handed out holds it, a view of that alias
    too, a clone does not; a copied result never holds it."""
    z, m = torch.zeros(4, 8), torch.ones(3)
    slot = tdevice._Slot([], None, (z, (m,)), keep=())
    assert not slot.held()
    out = slot.result(copy=False)
    assert out[0].data_ptr() == z.data_ptr() and slot.held()
    view = out[1][0][:2]
    del out
    assert slot.held()
    del view
    assert not slot.held()
    copied = slot.result(copy=True)
    assert copied[0].data_ptr() != z.data_ptr() and not slot.held()
    assert torch.equal(copied[0], z) and isinstance(copied[1], tuple)
    kept = slot.result(copy=False)[0].clone()
    assert not slot.held() and torch.equal(kept, z)


def test_arguments_walk_named_tuples_field_by_field():
    """Operators (a NamedTuple with a None field) are walked field by
    field and rebuilt; an array or a list is one leaf, keyed float32."""
    pipe = port_pipe()
    ops = pipe.dynamic_eq_operators(np.asarray(DYN_GAINS), FS, N,
                                    builder="host")
    leaves_, rebuild = tdevice._arg_leaves(ops)
    assert len(leaves_) == len(ops._fields)
    again = rebuild(iter(leaves_))
    assert type(again) is type(ops)
    assert all(a is b for a, b in zip(again, ops))
    x = make_x().astype(np.float64)
    assert tdevice._arg_leaves(x)[0][0] is x
    assert tdevice._spec(x) == ((2, N), torch.float32)
    assert tdevice._spec([[0.0, 1.0]]) == ((1, 2), torch.float32)
    assert tdevice._spec(None) is None
