"""Walk engines of the host collective plane.

Port of `kungfu_tpu/collective/walks.py`. Two walk families execute every
allreduce:

- the bandwidth-optimal **segmented ring** (`_run_segmented`):
  (k-1)-step reduce-scatter + (k-1)-step all-gather, exactly
  2·(k-1)/k·N bytes per peer;
- chunk-striped **graph walks** (`_run_strategies` → `_run_graphs`,
  parity: runGraphs, session.go:231-299) over (reduce, bcast) pairs.

Both live on the :class:`WalkEngine` mixin of
:class:`~kungfu_tpu_torch.collective.host_session.HostSession`, sharing
the receive protocol (`_recv_collective`), the wire-byte accounting and
the critical-path profiler feeds. Buffers are one-dimensional contiguous
torch CPU tensors; they cross into the transport only here, as their
bytes (`_buf`), and come back from received bytes by `_frombuffer`.

With `KF_TELEMETRY=trace` the segmented walk records one span per ring
step (`host.rs.step`, `host.ag.step`, thinned by
`KF_TELEMETRY_SPAN_SAMPLE`). Left out of the port for now: the two-level
walk over an adopted `HierPlan` and the ring order of an adopted
`RingPlan`, which only the re-plan rounds set (ROADMAP item 1e-ii); the
ring here is rank order.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence

import torch

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.base.ops import (
    QWire,
    copy_segment,
    decode_accumulate_any,
    decode_wire_any,
    encode_wire_any,
    reduce_inplace,
    reduce_segment,
    transform2,
    transform_n,
)
from kungfu_tpu_torch.base.ops import wire_nbytes as _wire_payload_nbytes
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.base.workspace import Workspace, even_partition
from kungfu_tpu_torch.collective import strategies as st
from kungfu_tpu_torch.collective.codec import DeferredDecode
from kungfu_tpu_torch.collective.profiler import WalkProfile, get_walk_profiler
from kungfu_tpu_torch.plan import topology as topo
from kungfu_tpu_torch.plan.graph import Graph
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.telemetry import audit
from kungfu_tpu_torch.transport.message import ConnType, Flags
from kungfu_tpu_torch.utils import trace
from kungfu_tpu_torch.utils.handoff import parallel_run as _par
from kungfu_tpu_torch.utils.pool import get_buffer_pool, get_pool

# Chunking (parity: session.go chunkSize, but self-tuned): ~8 chunks per
# collective, clamped to [1 MiB, 32 MiB]; KF_CONFIG_CHUNK_BYTES overrides.
CHUNK_BYTES = int(knobs.get("KF_CONFIG_CHUNK_BYTES"))
_CHUNK_MIN = 1 << 20
_CHUNK_MAX = 32 << 20
DEFAULT_TIMEOUT = 120.0

# A/B algorithm override: forces the engine onto one family regardless of
# the configured/AUTO strategy. MUST agree cluster-wide (peers that
# resolved different algorithms would wait on each other's names forever).
_ALGO_STRATEGY = {
    "": None,
    "auto": Strategy.AUTO,
    "tree": Strategy.BINARY_TREE,
    "segmented": Strategy.RING_SEGMENTED,
}


def algo_override() -> Optional[Strategy]:
    """Parse KF_CONFIG_ALGO (read per session epoch, not import time)."""
    return _ALGO_STRATEGY[knobs.get("KF_CONFIG_ALGO")]


def choose_chunk_bytes(total: int) -> int:
    """Chunk size for a `total`-byte collective: the env override, else
    ~8 chunks per collective, clamped to [1 MiB, 32 MiB]. Depends only on
    cluster-agreed inputs: chunk workspaces are named '<name>[i/k]', so
    peers that computed different k would wait on each other forever."""
    if CHUNK_BYTES > 0:
        return CHUNK_BYTES
    c = total // 8
    return max(_CHUNK_MIN, min(_CHUNK_MAX, c))


def _buf(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a one-dimensional contiguous tensor, as a uint8 view
    (no copy): what the transport sends, by its data pointer."""
    if not t.is_contiguous():
        raise ValueError("the host plane sends contiguous buffers")
    return t.view(torch.uint8)


def _frombuffer(data, dtype: torch.dtype, count: int) -> torch.Tensor:
    """`count` elements of `dtype` over received bytes, no copy: a byte
    tensor (a filled sink) is viewed, any other buffer (a buffered frame,
    a mapped shm region) wrapped by `torch.frombuffer`."""
    if isinstance(data, torch.Tensor):
        return data.view(dtype)[:count]
    if count == 0:
        return torch.empty(0, dtype=dtype)
    return torch.frombuffer(data, dtype=dtype, count=count)


class WalkEngine:
    """Walk-engine mixin for HostSession: engine dispatch
    (`_allreduce_ws`), the segmented ring walk, the chunked graph walks
    and the shared receive/accounting/profiling plumbing. Relies on
    session state (peers, client, endpoint, timeout, candidates,
    adaptive, the wire-byte counters) owned by the facade's
    constructor."""

    # Segmentation pays only when the per-step segment amortizes the
    # 2*(k-1) serialized message latencies; below this the rank-0 binary
    # tree fallback graphs win. MUST be cluster-agreed (it decides which
    # rendezvous names a peer waits on).
    SEGMENT_MIN_BYTES = int(knobs.get("KF_CONFIG_SEGMENT_MIN_BYTES"))

    def _segmented_active(self) -> bool:
        return (
            not self._tree_override
            and self.size >= 2
            and self._candidates[self.adaptive.active][0] == Strategy.RING_SEGMENTED
        )

    def _allreduce_ws(
        self,
        w: Workspace,
        cancel: Optional[threading.Event] = None,
        defer_decode: bool = False,
    ) -> Optional[DeferredDecode]:
        """Engine dispatch for one allreduce workspace: the segmented ring
        walk when RING_SEGMENTED is active and the payload is worth
        segmenting, else chunked graph walks. `cancel` (group scope)
        propagates so an abandoned walk observes the caller's timeout
        before mutating recv buffers.

        With `defer_decode=True` a compressed segmented walk skips its
        walk-end decode and returns the wire buffer as a DeferredDecode
        (w.recv is then NOT fully written!); every other path returns
        None and w.recv holds the result."""
        wire = self._wire_codec_for(w)
        if self._segmented_active() and w.recv.nbytes >= self.SEGMENT_MIN_BYTES:
            return self._run_segmented(w, cancel=cancel, wire=wire, defer_decode=defer_decode)
        self._run_strategies(w, self.global_strategies, cancel, wire=wire)
        return None

    # ------------------------------------------------------------------
    # accounting / profiling plumbing
    # ------------------------------------------------------------------

    def _count_wire(self, nbytes: int, strategy_label: str, codec: str = "off",
                    raw_bytes: int = 0) -> None:
        """Payload bytes this peer sent into a walk, by (public
        collective, executing strategy, codec); with metrics on, also the
        `kungfu_collective_wire_bytes_total` counter and the bytes the
        codec kept off the wire (`raw_bytes` minus `nbytes`)."""
        if nbytes:
            key = (self._wire_kind, strategy_label, codec)
            with self._wire_lock:
                self.wire_bytes[key] = self.wire_bytes.get(key, 0) + nbytes
            if self._wire_ctr is not None:
                self._wire_ctr.labels(*key).inc(nbytes)
        if self._wire_saved_ctr is not None and codec != "off" and raw_bytes > nbytes:
            self._wire_saved_ctr.labels(self._wire_kind, codec).inc(raw_bytes - nbytes)

    def _record_walk(self, strategy_label: str, k: int, payload_bytes: int, wall: float,
                     prof: WalkProfile) -> None:
        """Feed one finished allreduce walk to the process profiler."""
        get_walk_profiler().record(self._wire_kind, strategy_label, k, payload_bytes,
                                   wall, prof.wait, prof.send)

    def _walk_label(self) -> str:
        """Strategy label for graph-walk wire accounting: the graphs that
        actually EXECUTED. While RING_SEGMENTED is active, a payload below
        SEGMENT_MIN_BYTES (or a reduce/broadcast/gather) walks the binary
        tree fallback graphs and must not count as RING_SEGMENTED. The
        first such fallback of a session epoch is audited
        (`segmented_fallback`), except inside the knob-consensus walk,
        which takes the star by design."""
        if self._tree_override:
            return "SET_TREE"
        active = self._candidates[self.adaptive.active][0]
        if active == Strategy.RING_SEGMENTED:
            if not self._segmented_fallback_noted and not self._in_fixed_walk:
                self._segmented_fallback_noted = True
                audit.record_event(
                    "segmented_fallback",
                    peer=str(self.self_id),
                    collective=self._wire_kind,
                    wire_label=Strategy.BINARY_TREE.name,
                    threshold_bytes=self.SEGMENT_MIN_BYTES,
                )
            return Strategy.BINARY_TREE.name
        return active.name

    def _recv_collective(self, peer: PeerID, name: str, nbytes: int, dtype: torch.dtype,
                         count: int, timeout: float):
        """Receive (peer, name) into a pooled scratch buffer — delivered
        straight off the socket when we're parked first (sink path), else
        from the buffered Message (possibly a zero-copy shm borrow).
        Returns (tensor view, scratch-or-None to return to the pool,
        release-or-None to call once the view has been consumed). On error
        the scratch is deliberately NOT returned to the pool: a timed-out
        sink may still be mid-fill by the transport thread."""
        bufpool = get_buffer_pool()
        scratch = bufpool.get(nbytes)
        msg, filled = self.endpoint.recv_into(peer, name, scratch, timeout)
        if filled:
            return _frombuffer(scratch, dtype, count), scratch, None
        bufpool.put(scratch)  # unused: sender raced us or size mismatch
        return _frombuffer(msg.data, dtype, count), None, msg.release

    # ------------------------------------------------------------------
    # segmented ring walk
    # ------------------------------------------------------------------

    def _run_segmented(
        self,
        w: Workspace,
        ranks: Optional[Sequence[int]] = None,
        cancel: Optional[threading.Event] = None,
        wire=None,
        defer_decode: bool = False,
        phase: str = "all",
        ef_owned: Optional[torch.Tensor] = None,
    ) -> Optional[DeferredDecode]:
        """Bandwidth-optimal segmented walk: a (k-1)-step reduce-scatter
        over contiguous segments followed by a (k-1)-step all-gather
        around a ring (arXiv:1810.11112 §3). Each step sends ONE ~N/k
        segment to the ring successor and reduces (or, in the gather
        phase, copies) the segment arriving from the predecessor in place
        — ~2*(k-1)/k*N bytes moved per peer in total.

        With `wire` set each segment crosses the transport encoded:

        * reduce-scatter: the sender encodes its f32 partial into a pooled
          wire scratch; the receiver decode-accumulates into the f32
          buffer in one fused pass, so every transmitted value is
          quantized exactly once;
        * all-gather: segments STAY encoded in a walk-local wire buffer —
          each reduced segment is quantized once by its owner, relayed
          untouched, and decoded exactly once per peer at walk end (the
          owner decodes its own encoding too, so every peer lands on
          bit-identical results).

        Receives prefer the zero-copy sink/shm-borrow path and release
        borrows after the in-place reduce; one deadline bounds the WHOLE
        walk; a timed-out scratch buffer is never returned to the pool;
        empty segments (payload < k elements) are skipped identically on
        both ends of every edge.

        `ranks` restricts the ring to a subset (hierarchical cross-host
        mode); non-members forward send into recv. `phase` selects
        ``"all"`` (the allreduce), ``"rs"`` (stop after the reduce-scatter:
        w.recv holds the reduced OWNED segment, always raw f32) or
        ``"ag"`` (the standalone all-gather of segments the caller placed
        into an INPLACE workspace). The quantized codec carries
        error-feedback residuals: full walks use the session store keyed
        by workspace name, the ``"ag"`` phase the caller's `ef_owned`.
        Quantized walks never defer the walk-end decode."""
        if phase not in ("all", "rs", "ag"):
            raise ValueError(f"unknown segmented phase: {phase!r}")
        if phase == "rs":
            wire = None  # the reduce leg stays exact f32
        if w.is_empty:
            w.forward()
            return None
        members = list(range(self.size)) if ranks is None else list(ranks)
        k = len(members)
        if self.rank not in members or k == 1:
            w.forward()
            return None
        sched = topo.gen_segmented_schedule(members, members.index(self.rank))
        bounds = topo.segment_bounds(w.recv.numel(), k)
        w.forward()  # seed the accumulator with own contribution
        acc = w.recv
        send_peer = self.peers[sched.send_peer]
        recv_peer = self.peers[sched.recv_peer]
        itemsize = acc.element_size()
        codec_label = wire.name.lower() if wire is not None else "off"

        def seg_wire_nbytes(count: int) -> int:
            """Bytes segment `count` elements occupy on the wire."""
            if wire is None:
                return count * itemsize
            return _wire_payload_nbytes(count, wire)

        bufpool = get_buffer_pool()
        deadline = time.monotonic() + self.timeout
        wire_bytes = 0
        raw_bytes = 0
        # per-step spans of this walk (KF_TELEMETRY=trace, thinned by
        # KF_TELEMETRY_SPAN_SAMPLE)
        emit_steps = self._step_spans and self._span_sampler.sample()
        # critical-path attribution: wait-on-recv and send-blocked seconds
        # of THIS thread; the reduce/codec compute is the residual
        prof = WalkProfile()
        # all-gather wire buffer: segments stay encoded here from the
        # owner's single quantization until the walk-end decode. Leaked
        # (not pool-returned) on any error — the transport may still be
        # mid-fill into a timed-out sink slice. 16-bit codecs index it by
        # element; the block-scaled quantizer's variable-length segments
        # get per-segment byte offsets (blocks relative to each segment).
        wirebuf: Optional[torch.Tensor] = None
        wirearr: Optional[torch.Tensor] = None
        qoff: Optional[List[int]] = None
        if isinstance(wire, QWire):
            qoff = [0]
            for b, e in bounds:
                qoff.append(qoff[-1] + seg_wire_nbytes(e - b))
            wirebuf = bufpool.get(qoff[-1])
            wirearr = wirebuf
        elif wire is not None:
            wirebuf = bufpool.get(acc.numel() * 2)
            wirearr = wirebuf.view(torch.uint16)

        def ag_slice(seg: int) -> torch.Tensor:
            """The wire buffer slice holding segment `seg`'s encoding."""
            b, e = bounds[seg]
            if qoff is not None:
                return wirearr[qoff[seg]:qoff[seg + 1]]
            return wirearr[b:e]

        # error feedback (quantized codec only): RS sends and the AG seed
        # touch DISJOINT slices, so each element's residual is written at
        # most once per walk — pool-thread encodes included
        ef_full: Optional[torch.Tensor] = None
        if isinstance(wire, QWire) and phase == "all":
            ef_full = self._ef_residual(w.name, acc.numel())

        def encode_seg(payload: torch.Tensor, sb: int, se: int,
                       ef: Optional[torch.Tensor]) -> None:
            """Quantize acc[sb:se] into `payload`, folding the carried
            residual in and banking the new remainder (EF)."""
            if ef is None:
                encode_wire_any(payload, acc[sb:se], wire)
                return
            corrected = acc[sb:se] + ef
            encode_wire_any(payload, corrected, wire)
            decoded = torch.empty(se - sb, dtype=torch.float32)
            decode_wire_any(decoded, payload, wire)
            torch.sub(corrected, decoded, out=ef)

        def do_send(name: str, buf: torch.Tensor) -> None:
            """Deadline-bounded send: a frozen successor would otherwise
            block the send forever and the walk-wide deadline — checked
            only in the receives — would never fire. A timed-out send
            thread is abandoned; the buffer stays valid because the
            caller raises out of the walk without touching acc again."""
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"segmented walk timed out: {name}")
            done = threading.Event()
            errs: List[BaseException] = []

            def run() -> None:
                try:
                    # zero-copy: segments are disjoint and steps sequential
                    # per workspace, so this view cannot change mid-send
                    self.client.send(send_peer, name, _buf(buf), ConnType.COLLECTIVE)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)
                finally:
                    done.set()

            t_send = time.perf_counter()
            get_pool().submit(run)
            ok = done.wait(remaining)
            prof.send += time.perf_counter() - t_send
            if not ok:
                raise TimeoutError(f"segmented send timed out: {name}")
            if errs:
                raise errs[0]

        def start_send_wire(name: str, sb: int, se: int, buf: torch.Tensor, ef=None):
            """Async wire-mode send: encode (when `buf` is an f32 view) and
            transport copy run on a pool thread so they OVERLAP the
            blocking predecessor recv. Safe because a step's send and recv
            segments are disjoint by schedule construction. Returns
            (done, errs) for finish_send."""
            done = threading.Event()
            errs: List[BaseException] = []

            def run() -> None:
                try:
                    if buf.dtype != torch.float32:
                        payload = buf  # all-gather: already wire-encoded
                        scratch = None
                    else:
                        nb = seg_wire_nbytes(se - sb)
                        scratch = bufpool.get(nb)
                        payload = scratch if qoff is not None else scratch.view(torch.uint16)
                        encode_seg(payload, sb, se, ef)
                    self.client.send(send_peer, name, _buf(payload), ConnType.COLLECTIVE)
                    if scratch is not None:
                        bufpool.put(scratch)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errs.append(e)
                finally:
                    done.set()

            get_pool().submit(run)
            return done, errs

        def finish_send(pending, name: str) -> None:
            done, errs = pending
            remaining = deadline - time.monotonic()
            t_send = time.perf_counter()
            ok = remaining > 0 and done.wait(remaining)
            prof.send += time.perf_counter() - t_send
            if not ok:
                raise TimeoutError(f"segmented send timed out: {name}")
            if errs:
                raise errs[0]

        def recv_rs(name: str, rb: int, re_: int) -> None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"segmented walk timed out: {name}")
            nb = seg_wire_nbytes(re_ - rb)
            if qoff is not None:
                recv_dtype, recv_count = torch.uint8, nb
            elif wire is not None:
                recv_dtype, recv_count = torch.uint16, re_ - rb
            else:
                recv_dtype, recv_count = acc.dtype, re_ - rb
            t_recv = time.perf_counter()
            incoming, scratch, release = self._recv_collective(
                recv_peer, name, nb, recv_dtype, recv_count, remaining)
            prof.wait += time.perf_counter() - t_recv
            try:
                if cancel is not None and cancel.is_set():
                    # caller-scope timeout fired while we were blocked:
                    # a late arrival must not be reduced into the buffer
                    raise TimeoutError(f"collective cancelled: {name}")
                if wire is not None:
                    # fused decode + f32 accumulate: one pass, one
                    # quantization deep (the sender's encode)
                    decode_accumulate_any(acc, rb, re_, incoming, wire, w.op)
                else:
                    reduce_segment(acc, rb, re_, incoming, w.op)
            finally:
                del incoming
                if release is not None:
                    release()
            if scratch is not None:
                bufpool.put(scratch)

        def recv_ag(name: str, seg: int, rb: int, re_: int) -> None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"segmented walk timed out: {name}")
            if wire is None:
                t_recv = time.perf_counter()
                incoming, scratch, release = self._recv_collective(
                    recv_peer, name, (re_ - rb) * itemsize, acc.dtype, re_ - rb, remaining)
                prof.wait += time.perf_counter() - t_recv
                try:
                    if cancel is not None and cancel.is_set():
                        raise TimeoutError(f"collective cancelled: {name}")
                    copy_segment(acc, rb, re_, incoming)
                finally:
                    del incoming
                    if release is not None:
                        release()
                if scratch is not None:
                    bufpool.put(scratch)
                return
            # wire mode: deliver straight into the wire buffer slice — no
            # scratch, no decode (relayed as-is, decoded once at walk end)
            if qoff is not None:
                byte_lo, byte_hi = qoff[seg], qoff[seg + 1]
            else:
                byte_lo, byte_hi = rb * 2, re_ * 2
            t_recv = time.perf_counter()
            msg, filled = self.endpoint.recv_into(recv_peer, name, wirebuf[byte_lo:byte_hi],
                                                  remaining)
            prof.wait += time.perf_counter() - t_recv
            if cancel is not None and cancel.is_set():
                if msg is not None and msg.release is not None:
                    msg.release()
                raise TimeoutError(f"collective cancelled: {name}")
            if not filled:
                try:
                    wirebuf[byte_lo:byte_hi].copy_(
                        _frombuffer(msg.data, torch.uint8, byte_hi - byte_lo))
                finally:
                    if msg.release is not None:
                        msg.release()

        def step(phase: str, s: int, send_seg: int, recv_seg: int) -> None:
            nonlocal wire_bytes, raw_bytes
            sb, se = bounds[send_seg]
            rb, re_ = bounds[recv_seg]
            name = f"{w.name}:{phase}{s}"
            if cancel is not None and cancel.is_set():
                raise TimeoutError(f"collective cancelled: {name}")
            # empty segments are skipped on BOTH ends (identical bounds).
            # RAW mode: send-then-recv is deliberately SEQUENTIAL — the
            # send returns once the payload is in the shm ring / kernel
            # buffer. WIRE mode: encode+send run async on a pool thread
            # and overlap the predecessor wait (disjoint segments).
            if se > sb:
                wire_bytes += seg_wire_nbytes(se - sb)
                raw_bytes += (se - sb) * itemsize
            if wire is not None:
                pending = None
                if se > sb:
                    if phase == "rs":
                        ef = ef_full[sb:se] if ef_full is not None else None
                        pending = start_send_wire(name, sb, se, acc[sb:se], ef)
                    else:
                        pending = start_send_wire(name, sb, se, ag_slice(send_seg))
                if re_ > rb:
                    if phase == "rs":
                        recv_rs(name, rb, re_)
                    else:
                        recv_ag(name, recv_seg, rb, re_)
                if pending is not None:
                    finish_send(pending, name)
                return
            if se > sb:
                do_send(name, acc[sb:se])
            if re_ > rb:
                if phase == "rs":
                    recv_rs(name, rb, re_)
                else:
                    recv_ag(name, recv_seg, rb, re_)

        def timed_step(span_name: str, phase: str, s: int, snd: int, rcv: int) -> None:
            """One ring step, with a per-step span (when this walk emits
            them) annotated with how long the step was blocked waiting on
            its predecessor vs its successor."""
            if not emit_steps:
                step(phase, s, snd, rcv)
                return
            w0, s0 = prof.wait, prof.send
            with trace.span(span_name, step=s, k=k) as sp:
                step(phase, s, snd, rcv)
                sp.args["wait_us"] = round((prof.wait - w0) * 1e6)
                sp.args["send_us"] = round((prof.send - s0) * 1e6)

        t0 = time.perf_counter()
        if phase != "ag":
            for s, (snd, rcv) in enumerate(sched.rs_steps):
                timed_step("host.rs.step", "rs", s, snd, rcv)
        if phase == "rs":
            self._count_wire(wire_bytes, Strategy.RING_SEGMENTED.name, "off", raw_bytes)
            wall = time.perf_counter() - t0
            trace.record(f"host.rs[{w.recv.nbytes >> 20}MiB]", wall)
            # half walks move (k-1)/k·N = the optimal 2(k-1)/k volume of
            # HALF the payload: score against the halved payload
            self._record_walk(Strategy.RING_SEGMENTED.name, k, w.recv.nbytes // 2, wall, prof)
            return None
        if wire is not None:
            # seed the all-gather: quantize the owned (fully reduced)
            # segment ONCE; every peer — self included — decodes this same
            # encoding, so results stay bit-identical ringwide
            ob, oe = bounds[sched.owned_segment]
            if oe > ob:
                ef = None
                if isinstance(wire, QWire):
                    if ef_owned is not None and ef_owned.numel() != oe - ob:
                        raise ValueError(
                            f"ef residual of {ef_owned.numel()} elements for owned "
                            f"segment [{ob}:{oe}) — caller sharded differently")
                    ef = ef_owned
                    if ef is None and ef_full is not None:
                        ef = ef_full[ob:oe]
                encode_seg(ag_slice(sched.owned_segment), ob, oe, ef)
        for s, (snd, rcv) in enumerate(sched.ag_steps):
            timed_step("host.ag.step", "ag", s, snd, rcv)
        if cancel is not None and cancel.is_set():
            # a sibling in the group scope timed out while our steps
            # completed — acc may belong to a caller that already raised
            raise TimeoutError(f"collective cancelled: {w.name}")
        deferred: Optional[DeferredDecode] = None
        if wire is not None:
            if defer_decode and qoff is None:
                deferred = DeferredDecode(wire, wirebuf, wirearr)
            elif qoff is not None:
                # block-scaled: segments decode individually (each one's
                # scale blocks are relative to its own start)
                with trace.span("host.wire.decode", bytes=int(qoff[-1])):
                    for i, (b, e) in enumerate(bounds):
                        if e > b:
                            decode_wire_any(acc[b:e], ag_slice(i), wire)
                bufpool.put(wirebuf)
            else:
                with trace.span("host.wire.decode", bytes=int(acc.numel() * 2)):
                    decode_wire_any(acc, wirearr, wire)
                bufpool.put(wirebuf)
        self._count_wire(wire_bytes, Strategy.RING_SEGMENTED.name, codec_label, raw_bytes)
        wall = time.perf_counter() - t0
        trace.record(f"host.segmented[{w.recv.nbytes >> 20}MiB]", wall)
        self._record_walk(Strategy.RING_SEGMENTED.name, k,
                          w.recv.nbytes if phase == "all" else w.recv.nbytes // 2, wall, prof)
        return deferred

    # ------------------------------------------------------------------
    # chunked graph walks
    # ------------------------------------------------------------------

    def _run_strategies(
        self,
        w: Workspace,
        strategies: List[st.StrategyPair],
        cancel: Optional[threading.Event] = None,
        wire=None,
    ) -> None:
        """`wire` is decided ONCE on the whole workspace (in _allreduce_ws)
        and inherited by every chunk, so no residual chunk can fall below
        WIRE_MIN_BYTES and mix wire formats inside one collective."""
        total = w.recv.nbytes
        k = max(1, -(-total // choose_chunk_bytes(total)))
        chunks = w.split(even_partition, k) if k > 1 else [w]
        if cancel is None:
            cancel = threading.Event()
        if k == 1:
            pair = strategies[0]
            self._run_graphs(chunks[0], [pair.reduce_graph, pair.bcast_graph], cancel, wire,
                             profile=True)
            return
        jobs = []
        for i, chunk in enumerate(chunks):
            pair = st.choose(strategies, i)
            jobs.append(
                lambda c=chunk, p=pair: self._run_graphs(
                    c, [p.reduce_graph, p.bcast_graph], cancel, wire, profile=True))
        _par(jobs, self.timeout, cancel)

    def _run_graphs(
        self,
        w: Workspace,
        graphs: List[Graph],
        cancel: Optional[threading.Event] = None,
        wire=None,
        profile: bool = False,
    ) -> None:
        """The hot walk; parity: runGraphs (session.go:231-299).

        `profile=True` (the allreduce paths, via _run_strategies) feeds
        this walk's wait/send/compute attribution to the WalkProfiler.
        `cancel` is shared across every thread touching this workspace:
        once any part of the collective times out, late-arriving receives
        must not write into (possibly reused) caller buffers.

        With `wire` set, every send encodes the f32 buffer into a pooled
        wire scratch and every receive decode-accumulates (reduce phase)
        or decodes (bcast phase) back into f32 — accumulation never
        happens in 16-bit storage. Relays re-encode values that are
        already wire-quantized, which is exact, so every peer converges on
        bit-identical values."""
        if w.is_empty:
            return
        if all(g.is_isolated(self.rank) for g in graphs):
            w.forward()
            return
        if cancel is None:
            cancel = threading.Event()
        t_walk = time.perf_counter()
        prof = WalkProfile() if profile else None

        state = {"recv_count": 0}
        lock = threading.Lock()

        def effective() -> torch.Tensor:
            if state["recv_count"] > 0 or w.is_inplace:
                return w.recv
            return w.send

        wire_label = self._walk_label()
        codec_label = wire.name.lower() if wire is not None else "off"
        bufpool = get_buffer_pool()
        count = w.recv.numel()
        nbytes = w.recv.nbytes
        wire_nbytes = _wire_payload_nbytes(count, wire) if wire is not None else nbytes
        if isinstance(wire, QWire):
            # block-scaled payload: scales + packed bytes, u8-framed
            wire_dtype, wire_count = torch.uint8, wire_nbytes
        elif wire is not None:
            wire_dtype, wire_count = torch.uint16, count
        else:
            wire_dtype, wire_count = w.send.dtype, count

        def wire_scratch():
            scratch = bufpool.get(wire_nbytes)
            return scratch, scratch.view(wire_dtype)

        def send_to(peer: PeerID, flags: Flags = Flags.NONE) -> None:
            # zero-copy: the walk's phases are sequential per chunk, so
            # the buffer cannot change while the send drains it
            self.client.send(peer, w.name, _buf(effective()), ConnType.COLLECTIVE, flags)
            self._count_wire(wire_nbytes, wire_label, codec_label, nbytes)

        def send_all(peers: List[PeerID], flags: Flags = Flags.NONE) -> None:
            """Fan-out send of the current effective() buffer. Wire mode
            encodes ONCE into a shared scratch for the whole fan-out (every
            edge carries identical bytes). The scratch returns to the pool
            only on success: after a timeout an abandoned send thread may
            still be draining it."""
            if not peers:
                return
            if wire is None:
                t_send = time.perf_counter()
                _par([lambda p=p: send_to(p, flags) for p in peers], self.timeout, cancel)
                if prof is not None:
                    prof.send += time.perf_counter() - t_send
                return
            scratch, enc = wire_scratch()
            # the fan-out encode is codec COMPUTE; quantized payloads
            # re-encode idempotently (pow2 scales), so graph fan-outs need
            # no error feedback to stay bit-identical
            encode_wire_any(enc, effective(), wire)

            def send_enc(peer: PeerID) -> None:
                self.client.send(peer, w.name, _buf(enc), ConnType.COLLECTIVE, flags)
                self._count_wire(wire_nbytes, wire_label, codec_label, nbytes)

            t_send = time.perf_counter()
            _par([lambda p=p: send_enc(p) for p in peers], self.timeout, cancel)
            if prof is not None:
                prof.send += time.perf_counter() - t_send
            bufpool.put(scratch)

        def recv_payload(peer: PeerID):
            """See _recv_collective (shared with the segmented walk)."""
            return self._recv_collective(peer, w.name, wire_nbytes, wire_dtype, wire_count,
                                         self.timeout)

        def recv_onto(peer: PeerID) -> None:
            incoming, scratch, release = recv_payload(peer)
            try:
                with lock:
                    if cancel.is_set():
                        # abort the whole walk: a late arrival must neither
                        # write the workspace nor let the send phase relay
                        # stale data
                        raise TimeoutError(f"collective cancelled: {w.name}")
                    if wire is not None:
                        if state["recv_count"] == 0 and not w.is_inplace:
                            # first arrival: recv = decode(incoming), then
                            # fold own send in f32 (ops are commutative)
                            decode_wire_any(w.recv, incoming, wire)
                            reduce_inplace(w.recv, w.send, w.op)
                        else:
                            decode_accumulate_any(w.recv, 0, count, incoming, wire, w.op)
                    elif state["recv_count"] == 0 and not w.is_inplace:
                        # first arrival: recv = send (op) incoming
                        transform2(w.recv, w.send, incoming, w.op)
                    else:
                        reduce_inplace(w.recv, incoming, w.op)
                    state["recv_count"] += 1
            finally:
                del incoming
                if release is not None:
                    release()
            if scratch is not None:
                bufpool.put(scratch)

        def recv_all_onto(peers: List[PeerID]) -> None:
            """Accumulate phase: receive every prev, then reduce them all
            in ONE n-ary pass (kf_transform_n) — the receives themselves
            still overlap each other."""
            got: List = [None] * len(peers)

            def grab(i: int, p: PeerID) -> None:
                res = recv_payload(p)
                if cancel.is_set():
                    # the walk already timed out and its finally block may
                    # have run: release the borrow here or nobody will
                    if res[2] is not None:
                        res[2]()
                    return
                got[i] = res

            try:
                t_recv = time.perf_counter()
                _par([lambda i=i, p=p: grab(i, p) for i, p in enumerate(peers)],
                     self.timeout, cancel)
                if prof is not None:
                    prof.wait += time.perf_counter() - t_recv
                with lock:
                    if cancel.is_set():
                        raise TimeoutError(f"collective cancelled: {w.name}")
                    if wire is not None:
                        # decode-accumulate each arrival into f32 (no n-ary
                        # variant exists for mixed wire/f32 sources)
                        if not w.is_inplace:
                            w.forward()
                        for incoming, _, _ in got:
                            decode_accumulate_any(w.recv, 0, count, incoming, wire, w.op)
                    elif w.is_inplace:
                        for incoming, _, _ in got:
                            reduce_inplace(w.recv, incoming, w.op)
                    else:
                        transform_n(w.recv, [w.send] + [inc for inc, _, _ in got], w.op)
                    state["recv_count"] += len(peers)
            finally:
                for item in got:
                    if item is not None and item[2] is not None:
                        item[2]()
            for item in got:
                if item is not None and item[1] is not None:
                    bufpool.put(item[1])

        def recv_into(peer: PeerID) -> None:
            incoming, scratch, release = recv_payload(peer)
            try:
                with lock:
                    if cancel.is_set():
                        raise TimeoutError(f"collective cancelled: {w.name}")
                    if wire is not None:
                        decode_wire_any(w.recv, incoming, wire)
                    else:
                        w.recv.copy_(incoming)
                    state["recv_count"] += 1
            finally:
                del incoming
                if release is not None:
                    release()
            if scratch is not None:
                bufpool.put(scratch)

        for g in graphs:
            prevs = [self.peers[r] for r in g.prevs(self.rank)]
            nexts = [self.peers[r] for r in g.nexts(self.rank)]
            if g.is_self_loop(self.rank):
                # accumulate: receive from all prevs, n-ary reduce, send on
                if prevs and state["recv_count"] == 0:
                    recv_all_onto(prevs)
                elif prevs:
                    t_recv = time.perf_counter()
                    _par([lambda p=p: recv_onto(p) for p in prevs], self.timeout, cancel)
                    if prof is not None:
                        prof.wait += time.perf_counter() - t_recv
                send_all(nexts)
            else:
                # pass-through node: take value from single prev (or
                # forward own), relay to nexts
                if not prevs and state["recv_count"] == 0:
                    w.forward()
                else:
                    t_recv = time.perf_counter()
                    for p in prevs:
                        recv_into(p)
                    if prof is not None:
                        prof.wait += time.perf_counter() - t_recv
                send_all(nexts, Flags.WAIT_RECV_BUF)
        if cancel.is_set():
            # the group scope aborted while this walk's own edges completed
            # — w.recv may already be reused by the caller that raised
            raise TimeoutError(f"collective cancelled: {w.name}")
        if wire is not None and not graphs[-1].prevs(self.rank):
            # the bcast root never receives a wire message, so it would
            # keep its full-precision result while every other peer decodes
            # the quantized broadcast: roundtrip the root's recv through
            # the codec so all peers land on bit-identical values
            scratch, enc = wire_scratch()
            encode_wire_any(enc, w.recv, wire)
            decode_wire_any(w.recv, enc, wire)
            bufpool.put(scratch)
        wall = time.perf_counter() - t_walk
        trace.record(f"host.walk[{w.recv.nbytes >> 20}MiB]", wall)
        if prof is not None:
            self._record_walk(wire_label, self.size, w.recv.nbytes, wall, prof)
