"""Streaming / long-form processing with explicit, serializable carry state.

Counterpart of ``dsp_audio_project_tpu/streaming.py``.  Chunked SRC -> EQ
whose output equals the one-shot chain's to float32 rounding, and which can
checkpoint and resume mid-stream.  The carry is small and explicit:

  * SRC: the polyphase frame grid position (one sample counter) plus the
    input tail the next chunk's frames reach back into (~W samples);
  * EQ: the cascade's state, d values (two a band), in the Schur basis of
    the config, the JAX package's basis: ``StreamState`` reads and writes
    the JAX package's bytes, so a blob from either package resumes in the
    other.

``StreamProcessor`` (one signal, any chunking) runs the frames kernel on
each chunk's span (``ops/src.shifted_frames_matmul``) and
``ops/eq.equalize_stream`` (its readout and clip one K9 pass).
``ShardedStreamProcessor`` (C channels, fixed super-steps) runs each step
as K1 or the frames kernel, the EQ's state algebra and K9, with the carry
kept on the device; on a card each step is one replayed CUDA graph.  It
runs on any (channel, block) mesh held in this process (parallel/mesh.py):
the halo between block shards and the all-gather of their end states go
through ``parallel/collectives.py``.
"""
from __future__ import annotations

import dataclasses
import io
import json
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import PipelineConfig
from .kernels import fir_frames
from .kernels.fir_class import (
    cat_operator,
    plan_operator,
    polyphase_fir_class_rect_cat,
    rect_supported,
)
from .ops import eq as eq_ops
from .ops.eq_dynamic import (
    build_cat_tables_dyn,
    build_dynamic_stream_operators_host,
    dyn_frames_weights,
)
from .ops.src import (
    PolyphasePlan,
    _resample_frames,
    make_plan,
    resample,
    shifted_frames_matmul,
)
from .parallel import carry, collectives
from .parallel.mesh import BLOCK_AXIS, CHANNEL_AXIS
from .utils.device import capture_graph, default_device, warm_up


@dataclasses.dataclass
class StreamState:
    """Serializable carry for a paused stream.

    ``d`` records the EQ state dimension the carry was captured under and
    ``gains_db`` the active dynamic gain vector (None for static-gains
    streams), so a resume can validate the carry's basis instead of
    silently reinterpreting it under different operators.  ``to_bytes``
    writes the JAX package's format byte for byte.
    """

    samples_in: int          # total input samples consumed
    frames_done: int         # polyphase frames fully emitted
    src_carry: np.ndarray    # input tail the next frames reach into
    eq_state: np.ndarray     # cascade state (d,) or (C, d), or empty
    fs: int
    d: Optional[int] = None          # EQ state dim at capture
    gains_db: Optional[list] = None  # dynamic gains at capture

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        meta = dict(samples_in=self.samples_in, frames_done=self.frames_done,
                    fs=self.fs, d=self.d, gains_db=self.gains_db)
        head = json.dumps(meta).encode()
        buf.write(len(head).to_bytes(4, "little"))
        buf.write(head)
        np.save(buf, self.src_carry, allow_pickle=False)
        np.save(buf, self.eq_state, allow_pickle=False)
        return buf.getvalue()

    @staticmethod
    def from_bytes(data: bytes) -> "StreamState":
        buf = io.BytesIO(data)
        hlen = int.from_bytes(buf.read(4), "little")
        meta = json.loads(buf.read(hlen).decode())
        meta.setdefault("d", None)          # payloads older than the fields
        meta.setdefault("gains_db", None)
        src_carry = np.load(buf, allow_pickle=False)
        eq_state = np.load(buf, allow_pickle=False)
        return StreamState(src_carry=src_carry, eq_state=eq_state, **meta)


def _host(chunk) -> np.ndarray:
    """A chunk (numpy, a list or a tensor on any device) as float32 numpy."""
    if isinstance(chunk, torch.Tensor):
        chunk = chunk.detach().cpu().numpy()
    return np.asarray(chunk, dtype=np.float32)


class StreamProcessor:
    """Chunked SRC->EQ processing of one signal, equal to the one-shot chain.

    Usage:
        sp = StreamProcessor(PipelineConfig(...), fs=44100)
        for chunk in chunks:
            out.append(sp.process(chunk))
        out.append(sp.flush())

    ``process`` and ``flush`` take numpy or a tensor and return numpy, as
    the JAX package's do.  ``device``: where the kernels run, the card
    unless the caller passes another (``device="cpu"`` runs their plain
    versions).
    """

    def __init__(self, config: PipelineConfig, fs: int,
                 state: Optional[StreamState] = None, device=None):
        if device is None:
            device = default_device("StreamProcessor")
        self.device = torch.device(device)
        self.config = config
        self.fs = int(fs)
        self.fs_out = config.src.output_rate(self.fs)
        src = config.src
        self._plan: Optional[PolyphasePlan] = (
            None if src.bypass
            else make_plan(src.L, src.M, src.taps_rule_factor)
        )
        if state is not None:
            if state.fs != self.fs:
                raise ValueError("state was captured at a different rate")
            self._samples_in = state.samples_in
            self._frames_done = state.frames_done
            self._src_carry = np.array(state.src_carry, dtype=np.float32)
            self._eq_state = (
                torch.as_tensor(np.asarray(state.eq_state, np.float32),
                                device=self.device)
                if state.eq_state.size else None
            )
        else:
            self._samples_in = 0
            self._frames_done = 0
            self._src_carry = np.zeros(0, dtype=np.float32)
            self._eq_state = None
        self._flushed = False

    # -- state ------------------------------------------------------------
    @property
    def state(self) -> StreamState:
        eq_state = (
            self._eq_state.cpu().numpy()
            if self._eq_state is not None
            else np.zeros(0, dtype=np.float32)
        )
        return StreamState(
            samples_in=self._samples_in,
            frames_done=self._frames_done,
            src_carry=self._src_carry.copy(),
            eq_state=eq_state,
            fs=self.fs,
        )

    def state_bytes(self) -> bytes:
        return self.state.to_bytes()

    @staticmethod
    def resume(config: PipelineConfig, data: bytes,
               device=None) -> "StreamProcessor":
        st = StreamState.from_bytes(data)
        return StreamProcessor(config, st.fs, state=st, device=device)

    # -- processing -------------------------------------------------------
    def process(self, chunk) -> np.ndarray:
        """Consume a chunk, return finalized output samples."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        chunk = _host(chunk)
        if self.config.src.bypass:
            self._samples_in += len(chunk)
            return self._run_eq(torch.as_tensor(chunk, device=self.device))
        return self._run_eq(self._src_chunk(chunk, final=False))

    def flush(self) -> np.ndarray:
        """Emit the remaining tail (zero-extension beyond the stream end)."""
        if self._flushed:
            return np.zeros(0, dtype=np.float32)
        self._flushed = True
        if self.config.src.bypass:
            return np.zeros(0, dtype=np.float32)
        return self._run_eq(self._src_chunk(np.zeros(0, np.float32),
                                            final=True))

    def _src_chunk(self, chunk: np.ndarray, final: bool) -> torch.Tensor:
        """Polyphase SRC over [carry + chunk], emitting finalized frames.

        A frame k covers input [k*s + lo, k*s + lo + W); it is finalized once
        the stream holds samples beyond its window (or at flush, where the
        'same' zero extension applies).  ``_src_carry`` holds the stream tail
        from absolute position carry_start = samples_in - len(carry).
        """
        plan = self._plan
        src = self.config.src
        n_prev = self._samples_in
        self._samples_in += len(chunk)
        n_total = self._samples_in

        if final and 0 < n_total * src.L < src.num_taps:
            # Stream shorter than the filter: the centered-'same' geometry
            # differs (see ops/src.resample); no frames were finalizable yet,
            # so the carry still holds the whole stream: run it one-shot.
            assert self._frames_done == 0
            short_plan = make_plan(
                src.L, src.M, src.taps_rule_factor, (n_total * src.L - 1) // 2
            )
            n_out = -(-src.num_taps // src.M)
            y = _resample_frames(
                torch.as_tensor(self._src_carry, device=self.device),
                short_plan, n_total, n_out)
            self._frames_done = -(-n_out // short_plan.P)
            return y

        total_out = src.output_length(n_total) if n_total else 0
        total_frames_avail = -(-total_out // plan.P)
        if final:
            new_last_frame = total_frames_avail  # emit everything
        elif n_total * src.L < src.num_taps:
            # The stream might still end shorter than the filter, which
            # would retroactively switch to the short-signal 'same' geometry:
            # nothing is stable yet.
            new_last_frame = 0
        else:
            # frame k finalized iff k*s + lo + W <= n_total
            new_last_frame = max(
                0, min(total_frames_avail,
                       (n_total - plan.lo - plan.W) // plan.s + 1)
            )
        k0 = self._frames_done
        if new_last_frame <= k0:
            self._append_carry(chunk)
            return torch.zeros(0, device=self.device)

        # The input span frames [k0, new_last_frame) touch, built on the
        # host: absolute positions [k0*s + lo, (new_last_frame-1)*s + lo + W)
        # with zero extension on both sides.
        lo_abs = k0 * plan.s + plan.lo
        hi_abs = (new_last_frame - 1) * plan.s + plan.lo + plan.W
        carry_start = n_prev - len(self._src_carry)
        stream = np.concatenate([self._src_carry, chunk])
        x_span = np.zeros(hi_abs - lo_abs, dtype=np.float32)
        s0, s1 = max(lo_abs, carry_start), min(hi_abs, n_total)
        if s1 > s0:
            x_span[s0 - lo_abs : s1 - lo_abs] = (
                stream[s0 - carry_start : s1 - carry_start])
        # Local frame j = global frame k0 + j starts at j*s in x_span: the
        # frames kernel with pad_left = 0 (the JAX package's windows @ G).
        num_frames = new_last_frame - k0
        y = shifted_frames_matmul(
            torch.as_tensor(x_span, device=self.device), plan, num_frames, 0
        ).reshape(-1)
        # Trim to the true output count in [k0*P, min(new_last*P, total_out)).
        emit_upto = min(new_last_frame * plan.P, total_out)
        y = y[: emit_upto - k0 * plan.P]
        self._frames_done = new_last_frame
        self._append_carry(chunk)
        return y

    def _append_carry(self, chunk: np.ndarray) -> None:
        if self._plan is None:
            return
        keep = max(
            0,
            self._samples_in - (self._frames_done * self._plan.s + self._plan.lo),
        )
        keep = min(keep + 8, self._samples_in)  # small slack, bounded by stream
        stream_tail = np.concatenate([self._src_carry, chunk])
        self._src_carry = stream_tail[max(0, len(stream_tail) - keep):]

    def _run_eq(self, y: torch.Tensor) -> np.ndarray:
        cfg = self.config.eq
        if len(y) == 0 or cfg.bypass:
            return y.cpu().numpy()
        z, st = eq_ops.equalize_stream(
            y, self.fs_out, cfg, self._eq_state,
            block=self.config.kernels.iir_block,
        )
        self._eq_state = st
        return z.cpu().numpy()


class _StepRunner:
    """Runs a stream's super-steps from one device (the step itself moves
    shards to the other devices of its mesh).

    ``step(x, sigma) -> (z, sigma_out)``, the device program, comes with
    each ``run`` (the runner keeps no reference to its processor, so a
    processor nobody holds is freed at once, graphs and all, never by the
    cycle collector inside another stream's capture); the runner keeps the
    carry ``sigma`` on the device (written in place after each step) and
    owns the host staging.  On the CPU a step is a plain call on
    a fresh host array.  On a card: two device input slots, each with a
    pinned host buffer; step k uploads on a copy stream, runs on the
    current stream, and its z is copied on a second copy stream into a
    pinned buffer from a pool, so step k+1's upload and kernels overlap
    step k's fetch.  Events order the slots: an upload waits until the
    previous user of its slot was fetched (its z, which may alias the
    slot, has left the device), and a pinned buffer is refilled only once
    its upload has completed.  With ``graphs`` each slot's step is one
    CUDA graph, captured at the first step (after a warm-up that leaves
    the carry untouched) and replayed for every later one; ``captures``
    counts the captures.
    """

    def __init__(self, device: torch.device, x_shape, z_shape,
                 sigma: torch.Tensor, graphs: bool):
        self.device = device
        self.x_shape, self.z_shape = tuple(x_shape), tuple(z_shape)
        self.sigma = sigma
        self.cuda = device.type == "cuda"
        self.use_graphs = graphs and self.cuda
        self.graphs = None
        self.captures = 0
        if self.cuda:
            self.x_dev = [torch.empty(self.x_shape, device=device)
                          for _ in range(2)]
            self.x_pin = [torch.empty(self.x_shape, pin_memory=True)
                          for _ in range(2)]
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)
            self.uploaded = [None, None]
            self.fetched = [None, None]
            self.z_pool: list = []
        self.slot = 0

    def _body(self, step, slot: int) -> torch.Tensor:
        z, sigma_out = step(self.x_dev[slot], self.sigma)
        self.sigma.copy_(sigma_out)
        return z

    def host_buffer(self) -> np.ndarray:
        """The host array the next step's input span is written into."""
        if not self.cuda:
            return np.empty(self.x_shape, np.float32)
        ev = self.uploaded[self.slot]
        if ev is not None:
            ev.synchronize()
        return self.x_pin[self.slot].numpy()

    def run(self, host: np.ndarray, step):
        """Dispatch ``step`` on ``host`` (from ``host_buffer``); returns a
        pending record for ``fetch``."""
        if not self.cuda:
            z, sigma_out = step(torch.from_numpy(host), self.sigma)
            self.sigma = sigma_out
            return z, None
        slot = self.slot
        self.slot ^= 1
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.h2d):
            if self.fetched[slot] is not None:
                self.h2d.wait_event(self.fetched[slot])
            self.x_dev[slot].copy_(self.x_pin[slot], non_blocking=True)
            self.uploaded[slot] = self.h2d.record_event()
        cur.wait_event(self.uploaded[slot])
        if self.use_graphs:
            if self.graphs is None:
                self._capture(step)
            self.graphs[slot].replay()
            z = self.z_out[slot]
        else:
            z = self._body(step, slot)
        computed = cur.record_event()
        zp = (self.z_pool.pop() if self.z_pool
              else torch.empty(self.z_shape, pin_memory=True))
        with torch.cuda.stream(self.d2h):
            self.d2h.wait_event(computed)
            zp.copy_(z, non_blocking=True)
            if not self.use_graphs:
                z.record_stream(self.d2h)
            self.fetched[slot] = self.d2h.record_event()
        return zp, self.fetched[slot]

    def _capture(self, step) -> None:
        # Lazy inits first; the carry is untouched.
        warm_up(lambda: step(self.x_dev[0], self.sigma.clone()), self.device)
        self.graphs, self.z_out = [], []
        for slot in range(2):
            graph, z = capture_graph(lambda: self._body(step, slot),
                                     self.device)
            self.graphs.append(graph)
            self.z_out.append(z)
        self.captures += 1

    def fetch(self, pending, dest: np.ndarray) -> None:
        """Write the step's z, cropped to ``dest``'s shape, into ``dest``."""
        z, done = pending
        rows, cols = dest.shape
        if done is not None:
            done.synchronize()
        dest[...] = z.numpy()[:rows, :cols]
        if done is not None:
            self.z_pool.append(z)


class ShardedStreamProcessor:
    """Chunked SRC->EQ over a (channel, block) device mesh.

    BASELINE config 5 (the long-form multichannel stream).  Input chunks of
    any size buffer on the host; whenever the stream covers a full
    super-step of ``mesh_block * frames_per_shard`` finalized polyphase
    frames, the step runs on the device:

      * SRC: the step's input span (with the W - s samples the last frames
        reach into) goes through the frames kernel, or through K1 with the
        EQ's first product folded in (the cat route);
      * EQ: the grouped block recurrence from a zero state, then the
        cross-shard carry algebra of the JAX package (the shard-end states,
        the stream's incoming carry sigma_in, and the replicated outgoing
        carry), then the readout and clip as one K9 pass.

    The step's span is cut into ``mesh_block`` shards of
    ``frames_per_shard`` frames and the channels into ``mesh_channel`` rows.
    Block shard b's last frames read W - s samples of shard b + 1, received
    through ``collectives`` (the last shard takes the real stream tail,
    uploaded with the span); each shard's end state goes to every shard of
    its row by an all-gather, and ``parallel/carry.py`` (shared with
    ``run_sharded``) gives shard b its incoming carry from ``weights[b]``
    and ``pow_nb[b]``.  On a 1x1 mesh
    the halo is the tail itself and the gather the shard's own state.  The
    mesh is held in this process: a virtual mesh whose shards share one
    device (``mesh.shared``) runs each step as one CUDA graph covering
    every shard; on a mesh over several devices the steps run eagerly (a
    graph over several devices is ROADMAP work), and a process-group mesh
    (``distributed.multihost_mesh``) is refused.

    Routes, chosen as the JAX package chooses them:

    * flat (``fused=False``): the frames kernel's output viewed flat and
      regrouped at U = 128 (halved until it divides the block);
    * fused frames: the frames kernel with the EQ at U = P on its frames;
    * cat: K1 emits y0 and the injections (static gains, an active EQ,
      ``rect_supported``, ``src_fast == eq_fast``, frames_per_shard a
      multiple of 1024); with ``gains_db`` the dynamic cat route, K1 on the
      G2 of ``ops/eq_dynamic.build_cat_tables_dyn``.

    ``fused=None`` is fused wherever the plan's stride s >= 8.  The JAX
    package's rule ("on a TPU or in interpret mode") has no counterpart:
    the port's kernels have CPU plain versions, so 'auto' is fused on the
    card and on the CPU alike.

    The carry sigma stays on the device between steps (the host mirror is
    refreshed by ``_sync_sigma`` for ``state``); ``process`` and ``flush``
    dispatch every ready step and fetch afterwards.  On a card each step is
    one CUDA graph, captured at the first step and replayed
    (``graphs=False`` runs the eager step, the reference the replay is held
    against).  Dynamic gains (``gains_db=[...]``): ``set_gains`` swaps the
    EQ at a step boundary by rewriting the step's table buffers in place,
    so the captured graph is replayed as it is (never re-captured) and the
    carry passes through the change un-reset.  The output equals the
    one-shot chain for any chunking (gated >= 110 dB in the tests); carry
    state serializes through ``StreamState`` for checkpoint and resume.
    """

    def __init__(
        self,
        config: PipelineConfig,
        fs: int,
        mesh,
        channels: int,
        frames_per_shard: Optional[int] = None,
        state: Optional[StreamState] = None,
        fused: Optional[bool] = None,
        gains_db=None,
        graphs: bool = True,
    ):
        self.config = config
        self.fs = int(fs)
        self.fs_out = config.src.output_rate(self.fs)
        if mesh.process is not None:
            raise ValueError(
                "ShardedStreamProcessor runs on a mesh held in one process "
                "(build_mesh, single_device_mesh); a process-group mesh "
                "runs run_sharded")
        self.mesh = mesh
        self._nb = mesh.shape[BLOCK_AXIS]
        self._mc = mesh.shape[CHANNEL_AXIS]
        self.device = mesh.device_of(0, 0)   # where the span goes up
        self.channels = int(channels)
        self._c_pad = -(-self.channels // self._mc) * self._mc
        src = config.src
        self._plan = (
            None if src.bypass
            else make_plan(src.L, src.M, src.taps_rule_factor)
        )
        p = self._plan
        self._P = p.P if p else 1
        self._s = p.s if p else 1
        self._W = p.W if p else 1
        self._lo = p.lo if p else 0
        self._hr = max(0, self._W - self._s)

        if fused is None:
            fused = p is not None and p.s >= 8
        if fused and (p is None or p.s < 8):
            raise ValueError("fused streaming requires SRC with stride s >= 8")
        self._fused = bool(fused)

        bands = config.eq.active_bands(self.fs_out)
        self._dynamic = gains_db is not None
        self._eq_active = self._dynamic or (
            (not config.eq.bypass) and bool(bands)
        )
        cat_ok = (
            self._fused and self._eq_active
            and p is not None and rect_supported(p)
            and bool(config.kernels.src_fast) == bool(config.kernels.eq_fast)
        )
        fpb = max(1, -(-config.kernels.iir_block // self._P))
        fpb = -(-fpb // 16) * 16
        if cat_ok:
            # The JAX kernel's cat layout groups frames in 128-frame supers;
            # the EQ block is aligned to them unless an explicit
            # frames_per_shard is not a multiple (cat then stays off).
            fpb_cat = max(128, -(-fpb // 128) * 128)
            if frames_per_shard is None or frames_per_shard % fpb_cat == 0:
                fpb = fpb_cat
            else:
                cat_ok = False
        self._fpb = fpb
        # Unroll: P on the fused frame-major path, 128 on the flat path
        # (halved until it divides the block).
        self._U = self._P if self._fused else 128
        if not self._fused:
            while (fpb * self._P) % self._U:
                self._U //= 2
        if frames_per_shard is None:
            frames_per_shard = fpb
        if frames_per_shard % fpb:
            raise ValueError(
                f"frames_per_shard {frames_per_shard} must be a multiple of "
                f"the EQ block's frame count {fpb}"
            )
        self._fl = frames_per_shard
        if self._nb > 1 and self._hr > self._fl * self._s:
            raise ValueError(
                f"a shard of {self._fl * self._s} input samples is shorter "
                f"than the filter halo {self._hr}: raise frames_per_shard")
        self._K_loc = self._fl // fpb
        self._F_sup = self._nb * self._fl
        self._cat = cat_ok and not self._dynamic and self._fl % 1024 == 0
        self._cat_dyn = cat_ok and self._dynamic and self._fl % 1024 == 0

        if self._dynamic:
            # All bands stay active (0 dB is the identity), so d and the
            # step's shapes do not depend on the gains.
            self._d = 2 * len(config.eq.band_centers)
            self._ops = None
            self._gains = self._check_gains(gains_db)
        else:
            self._ops = (
                eq_ops.make_block_operators(
                    bands, self.fs_out, config.eq.q, fpb * self._P, self._U
                )
                if self._eq_active else None
            )
            self._d = self._ops.A.shape[0] if self._eq_active else 0
        self._dops = None

        if state is not None:
            if state.fs != self.fs:
                raise ValueError("state was captured at a different rate")
            if state.d is not None and state.d != self._d:
                raise ValueError(
                    f"stream state carries an EQ basis of dimension "
                    f"{state.d} but this processor's configuration has "
                    f"d={self._d}: resume with the same EQ config (and, "
                    f"for dynamic mode, pass gains_db; the captured gains "
                    f"are state.gains_db)"
                )
            self._samples_in = state.samples_in
            self._frames_done = state.frames_done
            self._buf = np.array(state.src_carry, dtype=np.float32)
            if self._buf.ndim == 1:
                self._buf = self._buf[None].repeat(self.channels, 0)
            eqs = np.asarray(state.eq_state, dtype=np.float32)
            if eqs.size and eqs.size != self.channels * self._d:
                raise ValueError(
                    f"stream state eq carry has {eqs.size} values; this "
                    f"configuration needs channels*d = "
                    f"{self.channels}*{self._d}: the state was captured "
                    f"under a different EQ config or channel count"
                )
            self._sigma = (
                eqs.reshape(self.channels, self._d)
                if eqs.size else np.zeros((self.channels, 0), np.float32)
            )
        else:
            self._samples_in = 0
            self._frames_done = 0
            self._buf = np.zeros((self.channels, 0), dtype=np.float32)
            self._sigma = np.zeros((self.channels, self._d), np.float32)
        self._flushed = False
        self._graphs = bool(graphs)
        self._tab = self._build_tables()
        self._tabs = {str(self.device): self._tab}   # per shard device
        self._runner: Optional[_StepRunner] = None   # built at the 1st step

    # -- tables ----------------------------------------------------------------
    def _check_gains(self, gains_db) -> np.ndarray:
        g = np.asarray(gains_db, np.float64).reshape(-1)
        if g.shape[0] != len(self.config.eq.band_centers):
            raise ValueError(
                f"expected {len(self.config.eq.band_centers)} gains, got "
                f"{g.shape[0]}"
            )
        return g

    def _build_tables(self) -> dict:
        """The step's device tables, named as the static BlockOperators
        fields where they have one (so ``ops/eq``'s grouped passes read
        them): the SRC operator ``g`` (or K1's ``g2``), ``w_frames``,
        ``group_toeplitz``, ``group_pows``, ``group_out``, ``state_corr``
        (A^block), ``carry_w`` (the local carry triangle, where it is
        dense), and the cross-shard tables ``pk``, ``weights``, ``w_out``,
        ``pow_nb``."""
        dev, plan = self.device, self._plan
        tab = {}
        if plan is not None and not (self._cat or self._cat_dyn):
            tab["g"] = plan_operator(plan, dev)
        if self._dynamic:
            tab.update(self._dyn_tables(self._gains))
        elif self._eq_active:
            tab.update(self._static_tables())
        return tab

    def _static_tables(self) -> dict:
        """Float64 host tables rounded to float32 last, as the JAX
        package's step builds them (streaming.py:605-632)."""
        ops, K_loc = self._ops, self._K_loc
        host = {
            "group_toeplitz": ops.group_toeplitz, "group_pows": ops.group_pows,
            "group_out": ops.group_out, "state_corr": ops.state_corr,
            **carry.cross_shard_tables(ops.state_corr, self._nb, K_loc),
        }
        if K_loc <= eq_ops._CARRY_ALLPAIRS_MAX:
            host["carry_w"] = eq_ops._carry_weights(ops, K_loc)
        if self._cat:
            host["g2"] = cat_operator(self._plan.G, eq_ops.eq_cat_weights(ops))
        else:
            host["w_frames"] = eq_ops.frames_weights(ops.group_fir,
                                                     ops.group_in)
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device).contiguous()
                for k, v in host.items()}

    def _dyn_tables(self, gains: np.ndarray) -> dict:
        """The gain-dependent tables of one gain vector: the host float64
        builder (``build_dynamic_stream_operators_host``) and, on the cat
        route, K1's G2 (one float64 product on the device)."""
        dops = build_dynamic_stream_operators_host(
            gains, self.fs_out, self.config.eq, unroll=self._U,
            groups_per_block=(self._fpb * self._P) // self._U,
            num_blocks=self._K_loc, num_shards=self._nb, device=self.device,
        )
        self._dops = dops
        o = dops.ops
        tab = {"group_toeplitz": o.toe, "group_pows": o.pows_g,
               "group_out": o.group_out, "state_corr": o.A_blk,
               "pk": dops.pk, "weights": dops.weights, "w_out": dops.w_out,
               "pow_nb": dops.pow_nb}
        if dops.carry_loc is not None:
            tab["carry_w"] = dops.carry_loc
        if self._cat_dyn:
            tab["g2"] = build_cat_tables_dyn(self._plan, o).g2
        else:
            tab["w_frames"] = dyn_frames_weights(o)
        return tab

    # -- dynamic gains -------------------------------------------------------
    def set_gains(self, gains_db) -> None:
        """Swap the EQ gains at a super-step boundary, with no re-capture.

        Only valid in dynamic mode (constructed with ``gains_db=...``).  One
        host float64 build and a small upload, copied into the step's table
        buffers in place (in stream order after the steps already
        dispatched), so the captured step graph is replayed as it is.  The
        carry sigma passes through the change un-reset: the live-lfilter
        semantics, where a coefficient change keeps the filter's internal
        state (the reference's slider model, app.py:158-167, applied
        mid-stream).  The same as the segment before the change processed
        with the old gains, ending in state sigma, then the segment after
        it with the new gains from sigma.
        """
        if not self._dynamic:
            raise RuntimeError(
                "processor was built with static gains; construct with "
                "gains_db=... for dynamic mode"
            )
        self._gains = self._check_gains(gains_db)
        new = self._dyn_tables(self._gains)
        for tab in self._tabs.values():
            for name, t in new.items():
                tab[name].copy_(t)

    def _sync_sigma(self) -> None:
        if self._runner is not None:
            self._sigma = self._runner.sigma.cpu().numpy()[: self.channels]

    # -- state --------------------------------------------------------------
    @property
    def captures(self) -> int:
        """How many times the step was captured as a CUDA graph (0 or 1)."""
        return 0 if self._runner is None else self._runner.captures

    @property
    def state(self) -> StreamState:
        self._sync_sigma()
        return StreamState(
            samples_in=self._samples_in,
            frames_done=self._frames_done,
            src_carry=self._buf.copy(),
            eq_state=self._sigma.copy(),
            fs=self.fs,
            d=self._d,
            gains_db=(
                [float(g) for g in self._gains] if self._dynamic else None
            ),
        )

    def state_bytes(self) -> bytes:
        return self.state.to_bytes()

    @staticmethod
    def resume(config: PipelineConfig, mesh, channels: int, data: bytes,
               frames_per_shard: Optional[int] = None,
               fused: Optional[bool] = None, gains_db=None,
               graphs: bool = True) -> "ShardedStreamProcessor":
        """Rebuild a processor from ``state_bytes`` output (this package's
        or the JAX package's).

        A dynamic-mode checkpoint records its gain vector; if ``gains_db``
        is not supplied the captured gains are re-applied (pass gains to
        resume under other slider positions: the carry passes through
        un-reset).
        """
        st = StreamState.from_bytes(data)
        if gains_db is None and st.gains_db is not None:
            gains_db = st.gains_db
        return ShardedStreamProcessor(
            config, st.fs, mesh, channels,
            frames_per_shard=frames_per_shard, state=st, fused=fused,
            gains_db=gains_db, graphs=graphs,
        )

    # -- device step ---------------------------------------------------------
    def _tables_on(self, dev) -> dict:
        """The step's tables on a shard's device (copies of ``_tab``, kept
        in step by ``set_gains``)."""
        key = str(dev)
        if key not in self._tabs:
            self._tabs[key] = {k: v.to(dev) for k, v in self._tab.items()}
        return self._tabs[key]

    def _carry_out(self, gathered, sigma_in, t):
        """The outgoing carry, the same on every block shard of a row: at
        nb = 1, e_shard + A_shard sigma_in."""
        return (torch.einsum("sij,s...j->...i", t["w_out"], gathered)
                + sigma_in @ t["pow_nb"][self._nb].T)

    def _shard_parts(self, x: torch.Tensor, t: dict):
        """One shard's SRC and the EQ's zero-state passes: x (C, fl*s + hr)
        -> (y0, s_in, sigma_local, e_shard), or (z, None) with no active
        EQ.  x index 0 is frame 0's window start: pad_left = 0."""
        plan = self._plan
        C, fl, P, K, U, d = (x.shape[0], self._fl, self._P, self._K_loc,
                             self._U, self._d)
        G = (self._fpb * P) // U
        if self._cat or self._cat_dyn:
            y0, inj = polyphase_fir_class_rect_cat(
                x, plan, fl * P, None, num_frames=fl, pad_left=0,
                g2=t["g2"])
            y0 = y0[:, :fl].reshape(C, K, G, U)
            s_in, e = eq_ops._group_states(inj[:, :fl].reshape(C, K, G, d),
                                           t["group_toeplitz"])
        else:
            if plan is None:
                y = x
            elif self._fused:
                y = fir_frames(x, plan, fl * P, num_frames=fl, pad_left=0,
                               g=t["g"])
            else:
                y = shifted_frames_matmul(x, plan, fl, 0)
            y = y.reshape(C, fl * P)
            if not self._eq_active:
                z = y if self.config.eq.bypass else torch.clamp(y, -1.0, 1.0)
                return z, None
            y0, s_in, e = eq_ops._grouped_parts(y.reshape(C, K, G, U), t)
        return (y0, s_in) + carry.shard_end(e, t)

    def _halo_parts(self, xr: torch.Tensor, axis) -> list:
        """A channel row's span cut into its block shards, each with its
        right halo: the first W - s samples of the next shard, received
        through the block axis; the last shard's is the stream tail (not
        the shift's zero edge).  With one block shard the span is the
        shard, its tail already joined."""
        devs = axis.devices
        if self._nb == 1:
            return [xr.to(devs[0])]
        L, hr = self._fl * self._s, self._hr
        heads = [xr[:, b * L:(b + 1) * L].to(dev)
                 for b, dev in enumerate(devs)]
        if not hr:
            return [h.contiguous() for h in heads]
        right = axis.shift([h[:, :hr] for h in heads], +1)
        right[-1] = xr[:, self._nb * L:].to(devs[-1])
        return [torch.cat([h, r], -1) for h, r in zip(heads, right)]

    def _row_step(self, xr: torch.Tensor, sigma_in: torch.Tensor, c: int):
        """Channel row c of a super-step: (z (rows, nb*fl*P), sigma_out),
        both on xr's device."""
        axis = collectives.block_axis(self.mesh, c)
        tabs = [self._tables_on(dev) for dev in axis.devices]
        staged = [self._shard_parts(p, t)
                  for p, t in zip(self._halo_parts(xr, axis), tabs)]
        if not self._eq_active:
            zs, sigma_out = [z for z, _ in staged], sigma_in
        else:
            zs, gathered = carry.finish_row(axis, staged, tabs, sigma_in)
            sigma_out = self._carry_out(gathered[0], sigma_in.to(
                axis.devices[0]), tabs[0]).to(xr.device)
        zs = [z.reshape(z.shape[0], self._fl * self._P).to(xr.device)
              for z in zs]
        return (zs[0] if len(zs) == 1 else torch.cat(zs, -1)), sigma_out

    def _step(self, x: torch.Tensor, sigma_in: torch.Tensor):
        """One super-step: x (C_pad, nb*fl*s + hr) -> (z (C_pad, nb*fl*P),
        sigma_out), each channel row of the mesh in turn.

        Pure (the carry comes in and goes out), so a warm-up call leaves
        the stream as it was and the eager step can be held against a
        replay of the captured one.
        """
        mc = self._mc
        if mc == 1:
            return self._row_step(x, sigma_in, 0)
        rows = x.shape[0] // mc
        out = [self._row_step(x[c * rows:(c + 1) * rows],
                              sigma_in[c * rows:(c + 1) * rows], c)
               for c in range(mc)]
        return (torch.cat([z for z, _ in out], 0),
                torch.cat([s for _, s in out], 0))

    def _get_runner(self) -> _StepRunner:
        if self._runner is None:
            sigma = torch.zeros((self._c_pad, self._d), device=self.device)
            sigma[: self.channels] = torch.as_tensor(self._sigma)
            self._runner = _StepRunner(
                self.device,
                (self._c_pad, self._F_sup * self._s + self._hr),
                (self._c_pad, self._F_sup * self._P), sigma,
                self._graphs and self.mesh.shared)
        return self._runner

    # -- processing ----------------------------------------------------------
    def process(self, chunk) -> np.ndarray:
        """Consume a (C, n) [or (n,)] chunk (numpy or a tensor); return the
        finalized (C, m) output as numpy."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        chunk = _host(chunk)
        if chunk.ndim == 1:
            chunk = chunk[None]
        if chunk.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} channels, got {chunk.shape[0]}"
            )
        self._buf = np.concatenate([self._buf, chunk], axis=1)
        self._samples_in += chunk.shape[1]
        # Dispatch every ready super-step back to back (uploads and steps
        # queue on the device; the carry stays there), then fetch.
        pend = []
        while self._step_ready():
            pend.append(self._run_step())
        return self._fetch_all(pend)

    def flush(self) -> np.ndarray:
        """Emit the remaining tail (zero extension beyond the stream end)."""
        if self._flushed:
            return np.zeros((self.channels, 0), np.float32)
        self._flushed = True
        src = self.config.src
        n_total = self._samples_in
        if self._plan is not None and 0 < n_total * src.L < src.num_taps:
            # Stream shorter than the filter: the centered-'same' geometry
            # differs (ops/src.resample); nothing was finalizable, so the
            # buffer holds the whole stream: run it one-shot.
            assert self._frames_done == 0
            y, _ = resample(torch.as_tensor(self._buf, device=self.device),
                            self.fs, src)
            return self._flush_eq_unsharded(y)
        total_out = src.output_length(n_total) if n_total else 0
        pend = []
        total_frames = -(-total_out // self._P)
        while self._frames_done < total_frames:
            pend.append(self._run_step())
        return self._fetch_all(pend)

    def _fetch_all(self, pend) -> np.ndarray:
        """Fetch dispatched super-steps, in stream order, into one (C, m)
        host array."""
        out = np.empty((self.channels, sum(emit for _, emit in pend)),
                       np.float32)
        col = 0
        for pending, emit in pend:
            self._runner.fetch(pending, out[:, col : col + emit])
            col += emit
        return out

    def _flush_eq_unsharded(self, y: torch.Tensor) -> np.ndarray:
        cfg = self.config.eq
        self._sync_sigma()
        if self._dynamic:
            # One grouped pass over the zero-padded blocks with the carry
            # folded in; the post-flush state is not updated (the stream is
            # closed).
            o = self._dops.ops
            U, d = o.group_in.shape
            G = o.toe.shape[0] // d
            n, blk = y.shape[-1], G * U
            K = -(-n // blk)
            x_g = F.pad(y, (0, K * blk - n)).reshape(y.shape[:-1] + (K, G, U))
            tab = {"w_frames": dyn_frames_weights(o),
                   "group_toeplitz": o.toe, "state_corr": o.A_blk,
                   "group_pows": o.pows_g, "group_out": o.group_out}
            y0, s_in, e = eq_ops._grouped_parts(x_g, tab)
            sigma = eq_ops._carry_states(
                e, o.A_blk, None,
                torch.as_tensor(self._sigma, device=self.device))
            z = eq_ops._grouped_finish(y0, s_in, sigma, tab)
            return z.reshape(y.shape[:-1] + (K * blk,))[..., :n].cpu().numpy()
        if cfg.bypass:
            return y.cpu().numpy()
        if not self._eq_active:
            return torch.clamp(y, -1.0, 1.0).cpu().numpy()
        z, st = eq_ops.equalize_stream(y, self.fs_out, cfg, self._sigma,
                                       block=self._ops.block)
        self._sigma = st.cpu().numpy()
        return z.cpu().numpy()

    def _step_ready(self) -> bool:
        src = self.config.src
        n_total = self._samples_in
        k_end = self._frames_done + self._F_sup
        if self._plan is None:
            return k_end <= n_total
        if n_total * src.L < src.num_taps:
            return False  # short-signal geometry not yet ruled out
        window_end = (k_end - 1) * self._s + self._lo + self._W
        if window_end > n_total:
            return False
        # Never emit output indices the stream hasn't justified yet (they
        # would be unretractable if the stream ended now).
        return k_end * self._P <= src.output_length(n_total)

    def _run_step(self):
        """Dispatch ONE super-step; returns (pending z, emit count).

        The span is written straight into the runner's host buffer (pinned
        on a card), uploaded and run asynchronously; nothing is fetched
        here, and the carry stays on the device for the next dispatch.
        """
        runner = self._get_runner()
        k0 = self._frames_done
        k_end = k0 + self._F_sup
        span_start = k0 * self._s + self._lo
        n_total = self._samples_in
        buf_start = n_total - self._buf.shape[1]
        arr = runner.host_buffer()
        a, b = span_start, span_start + arr.shape[1]
        s0, s1 = max(a, buf_start), min(b, n_total)
        if s1 > s0:
            arr[: self.channels, : s0 - a] = 0.0
            arr[: self.channels, s0 - a : s1 - a] = (
                self._buf[:, s0 - buf_start : s1 - buf_start]
            )
            arr[: self.channels, s1 - a :] = 0.0
            arr[self.channels :] = 0.0
        else:
            arr[:] = 0.0
        pending = runner.run(arr, self._step)

        src = self.config.src
        total_out = (
            src.output_length(n_total) if self._plan is not None else n_total
        )
        emit_upto = min(k_end * self._P, total_out)
        emit = emit_upto - k0 * self._P
        self._frames_done = k_end
        # Trim the buffer to the samples future frames can still touch.
        keep_from = self._frames_done * self._s + self._lo
        drop = max(0, keep_from - buf_start)
        if drop:
            self._buf = self._buf[:, drop:]
        return pending, emit
