"""Sharded SRC -> EQ over a (channel, block) mesh.

Counterpart of ``dsp_audio_project_tpu/parallel/pipeline.py``.  A
multichannel long-form signal is cut into channel rows and contiguous time
blocks; each shard runs the chain on its own samples, with two
cross-shard exchanges (``collectives.py``):

  1. **FIR halo (overlap-save).**  A time shard's polyphase frames read a
     few edge samples its neighbours own (left max(0, -lo), right
     max(0, lo + W - 1)).  They come in by a shift-by-one along the block
     axis; the edge shards receive zeros, which is numpy's 'same' zero
     extension, so the sharded FIR equals the unsharded one.
  2. **IIR carry.**  Each shard runs the grouped block recurrence from a
     zero state and exposes its end state (d values a channel).  One
     all-gather of those states and a host table W[dst, src] =
     A^{(dst-1-src) n_out_local}, built in float64, give every shard its
     true incoming state; the carry then folds into the shard's block
     states, and K9 reads out and clips (``carry.py``, shared with the
     sharded stream, whose incoming carry is the stream's; here zero).

Geometry is host-side and static (``_plan_shards``, the JAX package's
values field for field): a shard owns a whole number of polyphase frames
and of IIR blocks; the global zero padding lands in the last shard and is
cropped after the gather (exact: 'same' zero extension and a causal IIR).

Routes inside a shard, all on the port's kernels:

* plain (``fused=False``): the frames kernel (``ops/src.shifted_frames_
  matmul``) with ``pad_left = -(lo + halo_left)`` at every stride (the JAX
  package gathers and runs an einsum below s = 8; the frames kernel
  computes the same windows), viewed flat, the EQ at the config's unroll;
* fused: ``kernels.fir_frames`` (the frames kernel) on the halo-extended
  shard, the EQ at unroll P on its frames (fpb = 128 frames a block);
* cat: K1 emits the EQ's y0 and injections per frame, then the state
  solve, the carry and K9.

``fused=None`` is fused wherever the plan's stride s >= 8, the rule the
port's stream takes (the JAX package's "on a TPU or in interpret mode" has
no counterpart: the port's kernels have CPU plain versions).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig, SRCConfig
from ..kernels import fir_frames
from ..kernels.fir_class import (
    cat_operator,
    polyphase_fir_class_rect_cat,
    rect_supported,
)
from ..ops import eq as eq_ops
from ..ops.src import PolyphasePlan, make_plan, shifted_frames_matmul
from . import carry, collectives
from .mesh import BLOCK_AXIS, CHANNEL_AXIS, DeviceMesh, shard_signal, \
    unshard_signal


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static geometry for one (config, input shape, mesh shape)."""

    n: int                 # true input length
    n_out: int             # true output length
    c: int                 # true channel count
    c_pad: int             # padded channel count (multiple of mesh channel dim)
    n_in_local: int        # input samples per block-shard
    n_out_local: int       # output samples per block-shard
    frames_local: int      # polyphase frames per shard
    halo_left: int
    halo_right: int
    iir_block: int         # IIR block length used inside shards


def _plan_shards(
    n: int, c: int, mesh_channel: int, mesh_block: int,
    src_cfg: SRCConfig, iir_block_hint: int, fused: bool = False,
) -> Tuple[ShardPlan, Optional[PolyphasePlan]]:
    """The JAX package's ``_plan_shards`` (``pipeline.py:47-130``)."""
    if src_cfg.bypass:
        plan = None
        s, Pcls = 1, 1
    else:
        plan = make_plan(src_cfg.L, src_cfg.M, src_cfg.taps_rule_factor)
        s, Pcls = plan.s, plan.P

    # Frames per IIR block, a multiple of 16 so the block keeps a power-of-2
    # factor for the unroll; the fused path pins 128 (the unsharded frames
    # path's groups_per_block).
    if fused:
        fpb = 128
    else:
        fpb = max(1, -(-iir_block_hint // Pcls))
        fpb = -(-fpb // 16) * 16
    iir_block = fpb * Pcls

    # Fused shards round frames_local to the 1024-frame granule (K1's frame
    # grid emits exactly frames_local rows); the pad frames land in the
    # last shard, the global tail.
    granule = 1024 if fused else fpb
    granule = -(-granule // fpb) * fpb
    frames_total = (
        -(-n // (s * mesh_block * granule)) * granule * mesh_block
    )
    frames_local = frames_total // mesh_block
    n_in_local = frames_local * s
    n_out_local = frames_local * Pcls

    # One block shard has no neighbours: the frame kernels' own zero
    # extension is the halo.
    halo_left = plan.halo_left if plan is not None and mesh_block > 1 else 0
    halo_right = plan.halo_right if plan is not None and mesh_block > 1 else 0
    if max(halo_left, halo_right) > n_in_local and mesh_block > 1:
        raise ValueError(
            f"shard too small for filter halo: local={n_in_local}, "
            f"halo=({halo_left},{halo_right})"
        )
    c_pad = -(-c // mesh_channel) * mesh_channel
    sp = ShardPlan(
        n=n,
        n_out=src_cfg.output_length(n),
        c=c,
        c_pad=c_pad,
        n_in_local=n_in_local,
        n_out_local=n_out_local,
        frames_local=frames_local,
        halo_left=halo_left,
        halo_right=halo_right,
        iir_block=iir_block,
    )
    return sp, plan


def _halo_extend(parts, sp: ShardPlan, axis):
    """[left tail | x_loc | right head] for each of a row's local shards,
    the halos received through the block axis (zeros at the edges)."""
    hl, hr = sp.halo_left, sp.halo_right
    if not (hl or hr):
        return parts
    left = axis.shift([p[..., -hl:] for p in parts], -1) if hl else None
    right = axis.shift([p[..., :hr] for p in parts], +1) if hr else None
    out = []
    for i, p in enumerate(parts):
        pieces = ([left[i]] if hl else []) + [p] + ([right[i]] if hr else [])
        out.append(torch.cat(pieces, -1))
    return out


def _local_resample(x_ext: torch.Tensor, plan: PolyphasePlan,
                    sp: ShardPlan) -> torch.Tensor:
    """Shard-local polyphase frames through the frames kernel, flat."""
    frames = shifted_frames_matmul(x_ext, plan, sp.frames_local,
                                   -(plan.lo + sp.halo_left))
    return frames.reshape(x_ext.shape[:-1] + (sp.n_out_local,))


def _local_resample_shear(x_ext: torch.Tensor, plan: PolyphasePlan,
                          sp: ShardPlan) -> torch.Tensor:
    """Shard-local frames (..., frames_local, P) through ``fir_frames``:
    frame 0's window starts at the real neighbour data of the halo."""
    return fir_frames(
        x_ext.contiguous(), plan, sp.n_out_local,
        num_frames=sp.frames_local, pad_left=-(plan.lo + sp.halo_left),
    )


def _local_resample_cat(x_ext: torch.Tensor, plan: PolyphasePlan,
                        sp: ShardPlan, g2: torch.Tensor):
    """Shard-local K1: (y0 frames (..., frames_local, P), inj (...,
    frames_local, d)); frames_local is a 1024-frame multiple, so K1's grid
    emits exactly frames_local rows."""
    return polyphase_fir_class_rect_cat(
        x_ext.contiguous(), plan, sp.n_out_local, None,
        num_frames=sp.frames_local, pad_left=-(plan.lo + sp.halo_left),
        g2=g2,
    )


def build_sharded_pipeline(
    mesh: DeviceMesh,
    config: PipelineConfig,
    fs: int,
    n: int,
    channels: int,
    fused: Optional[bool] = None,
    cat: bool = False,
):
    """A sharded processor for fixed (fs, N, C).

    Returns ``(fn, shard_plan)``: ``fn(shards)`` takes this process's
    shards of the padded (c_pad, mesh_block * n_in_local) input, a dict
    {(c, b): tensor} (``mesh.shard_signal``), and returns the dicts
    ``(z, y)`` of its output shards, z clipped (with ``cat=True`` the dict
    of z alone); ``run_sharded`` wraps the pad, split, gather and crop.
    ``fused``: the frame-major route in each shard; None = wherever the
    plan's stride s >= 8.  ``cat``: K1's EQ-fused route (implies fused;
    needs an active EQ and ``src_fast == eq_fast``).
    """
    mesh_channel = mesh.shape[CHANNEL_AXIS]
    mesh_block = mesh.shape[BLOCK_AXIS]
    src_cfg, eq_cfg = config.src, config.eq

    plan_probe = (
        None if src_cfg.bypass
        else make_plan(src_cfg.L, src_cfg.M, src_cfg.taps_rule_factor)
    )
    if fused is None:
        fused = plan_probe is not None and plan_probe.s >= 8
    if fused and (plan_probe is None or plan_probe.s < 8):
        raise ValueError("fused sharded path requires SRC with stride s >= 8")
    if cat:
        kc = config.kernels
        if not fused:
            raise ValueError("cat sharding implies the fused frame path")
        if plan_probe is None or not rect_supported(plan_probe):
            raise ValueError("cat sharding needs the rect kernel geometry")
        if bool(kc.src_fast) != bool(kc.eq_fast):
            raise ValueError(
                "cat sharding folds both stages into one kernel precision; "
                "set src_fast == eq_fast"
            )
    sp, plan = _plan_shards(
        n, channels, mesh_channel, mesh_block, src_cfg,
        config.kernels.iir_block, fused=bool(fused),
    )
    fs_out = src_cfg.output_rate(fs)
    bands = eq_cfg.active_bands(fs_out)
    eq_active = not eq_cfg.bypass and bool(bands)
    if cat and not eq_active:
        raise ValueError("cat sharding requires an active EQ")
    ops = (
        eq_ops.make_block_operators(
            bands, int(fs_out), eq_cfg.q, sp.iir_block,
            **({"unroll": plan.P} if fused else {}),
        )
        if eq_active
        else None
    )
    K_loc = sp.n_out_local // ops.block if eq_active else 0
    g2_host = (cat_operator(plan.G, eq_ops.eq_cat_weights(ops))
               if cat else None)
    cross_tabs = (carry.cross_shard_tables(ops.state_corr, mesh_block, K_loc)
                  if eq_active else None)
    dev_tables: dict = {}

    def tables(dev) -> dict:
        key = str(dev)
        if key not in dev_tables:
            t = {**eq_ops.block_tables(ops, dev, K_loc),
                 **{k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                    for k, v in cross_tabs.items()}}
            if cat:
                t["g2"] = torch.as_tensor(g2_host, device=dev)
            dev_tables[key] = t
        return dev_tables[key]

    def src_stage(x_ext: torch.Tensor, t: Optional[dict]):
        """(y flat, EQ parts (y0, s_in, sigma_local, e_shard) or None) of
        one shard."""
        x_ext = x_ext.to(torch.float32)
        lead = x_ext.shape[:-1]
        if cat:
            y0f, inj = _local_resample_cat(x_ext, plan, sp, t["g2"])
            d = inj.shape[-1]
            fpb = ops.block // plan.P
            s_in, e = eq_ops._group_states(
                inj.reshape(lead + (K_loc, fpb, d)), t["group_toeplitz"])
            return None, ((y0f.reshape(lead + (K_loc, fpb, plan.P)), s_in)
                          + carry.shard_end(e, t))
        if plan is None:
            y = x_ext.contiguous()
        elif fused:
            y = _local_resample_shear(x_ext, plan, sp).reshape(
                lead + (sp.n_out_local,))
        else:
            y = _local_resample(x_ext, plan, sp)
        if not eq_active:
            return y, None
        U = ops.unroll
        x_g = y.reshape(lead + (K_loc, ops.block // U, U))
        y0, s_in, e = eq_ops._grouped_parts(x_g, t)
        return y, (y0, s_in) + carry.shard_end(e, t)

    def fn(shards: Dict[Tuple[int, int], torch.Tensor]):
        z_out, y_out = {}, {}
        for c in sorted({c for c, _ in shards}):
            axis = collectives.block_axis(mesh, c)
            parts = [shards[(c, b)] for b in axis.blocks]
            if plan is not None:
                parts = _halo_extend(parts, sp, axis)
            devs = [p.device for p in parts]
            tabs = [tables(dv) if eq_active else None for dv in devs]
            staged = [src_stage(p, t) for p, t in zip(parts, tabs)]
            if not eq_active:
                for b, (y, _) in zip(axis.blocks, staged):
                    y_out[(c, b)] = y
                    z_out[(c, b)] = (y if eq_cfg.bypass
                                     else torch.clamp(y, -1.0, 1.0))
                continue
            # The one-shot chain starts from rest: a zero incoming carry.
            eq_parts = [p for _, p in staged]
            zs, _ = carry.finish_row(axis, eq_parts, tabs,
                                     torch.zeros_like(eq_parts[0][3]))
            for b, (y, _), z in zip(axis.blocks, staged, zs):
                z_out[(c, b)] = z.reshape(z.shape[:-3] + (sp.n_out_local,))
                y_out[(c, b)] = y
        return z_out if cat else (z_out, y_out)

    return fn, sp


_sharded_cache: dict = {}


def run_sharded(
    x,
    fs: int,
    config: PipelineConfig,
    mesh: DeviceMesh,
    fused: Optional[bool] = None,
    cat: bool = False,
):
    """Pad, shard, process, gather, crop: the host-facing sharded entry.

    ``x``: (C, N) or (N,) float32, numpy or a tensor (a tensor's device is
    where the padded signal is built; numpy starts on the host, and each
    shard goes to its own device).  Returns (z, y, fs_out, plan) with z and
    y cropped to the true (C, n_out), on shard (0, 0)'s device; with
    ``cat=True`` the EQ-fused cat shards run and y is None.  On a
    process-group mesh (``distributed.multihost_mesh``) every rank passes
    the whole x and receives the whole z.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x, dtype=np.float32))
    if x.ndim == 1:
        x = x[None, :]
    c, n = x.shape
    # One build per (mesh, config, geometry), as the JAX package's compile
    # cache: the host tables are made once.
    key = (mesh, config, fs, n, c, fused, cat)
    hit = _sharded_cache.get(key)
    if hit is None:
        hit = build_sharded_pipeline(
            mesh, config, fs, n, c, fused=(True if cat else fused), cat=cat
        )
        _sharded_cache[key] = hit
    fn, sp = hit
    n_padded = sp.n_in_local * mesh.shape[BLOCK_AXIS]
    xp = x.new_zeros((sp.c_pad, n_padded), dtype=torch.float32)
    xp[:c, :n] = x
    out = fn(shard_signal(mesh, xp))
    fs_out = config.src.output_rate(fs)
    z_sh, y_sh = (out, None) if cat else out
    z = unshard_signal(collectives.gather_grid(mesh, z_sh))[:c, : sp.n_out]
    if cat:
        return z, None, fs_out, sp
    y = unshard_signal(collectives.gather_grid(mesh, y_sh))[:c, : sp.n_out]
    return z, y, fs_out, sp
