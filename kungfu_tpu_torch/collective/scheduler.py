"""Async collective scheduler: readiness-ordered, backprop-overlapped
group allreduce.

Port of `kungfu_tpu/collective/scheduler.py`. The synchronous step loop
launches `group_all_reduce` at step end, so the engine idles through the
whole backward and then walks every bucket at once. Here:

- callers :meth:`~CollectiveScheduler.submit` one workspace per tensor
  as its gradient becomes ready and :meth:`~CollectiveScheduler.flush`
  once per step;
- a background launcher assembles the SAME deterministic buckets the
  fused pipeline builds (`pipeline.py::_make_buckets`, driven by
  ``KF_CONFIG_GROUP_BUCKET_BYTES``/``KF_CONFIG_GROUP_FUSE_MIN``) and
  launches each bucket's pack → walk → unpack as soon as its members
  arrived, while the caller is still producing later gradients.

**Ordering guarantee.** Readiness order is local, but peers must walk
identical bucket sequences. So the launch order is negotiated ONCE per
session epoch: the first round's submission order (shaped by the
optional ``priority`` argument) becomes the **registered tensor order**,
the bucket plan is derived from it exactly like the synchronous path,
and a consensus over the knob-independent star walk (`_bytes_agree`)
verifies every peer registered the identical ordered set; a diverging
peer raises a named RuntimeError instead of deadlocking. After
registration, submissions may arrive in ANY order; buckets launch in
registered order as they complete, with wire names stamped by a round
counter (``:r{n}``, ZeRO's ``:zrs:r{n}``/``:zag:r{n}``) so back-to-back
rounds never collide. The registry digest, the plan and the names are
the reference's, so port and reference peers share one scheduler world.

**Results are bit-identical to the synchronous path**: same bucket
membership, same pack layout, same walk engine, same unpack; only the
launch *time* moves.

**Epoch lifecycle.** The scheduler lives exactly as long as its session:
`Peer._update_to` calls `HostSession.close()` before swapping sessions,
which drains in-flight buckets (bounded) and cancels the rest.

**Sharded (ZeRO-1) units.** A submission carrying a ``handler`` (a
:class:`~kungfu_tpu_torch.collective.zero.ShardedUpdateSession`)
registers as a *sharded* tensor: its buckets run reduce-scatter →
shard update → weight all-gather → scatter across the 4 stage threads.
``flush()`` returns once every sharded bucket's SHARD has updated;
:meth:`~CollectiveScheduler.wait_gather` waits for the weight
all-gathers.

Telemetry, as the reference's: the stage threads enter
``trace.step_scope(epoch, round)`` of the round they run, so their
``sched.*`` spans carry a ``step`` arg; with metrics on the scheduler
keeps ``kungfu_scheduler_queued_buckets``,
``kungfu_scheduler_overlap_seconds_total`` and
``kungfu_scheduler_flush_wait_seconds``. Not ported: the step timelines
and the memory-plane accountant (ROADMAP items 1e-iii and 1e-iv).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective.codec import dtype_str
from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import metrics as tmetrics
from kungfu_tpu_torch.utils import trace
from kungfu_tpu_torch.utils.handoff import HandoffQueue
from kungfu_tpu_torch.utils.stall import stall_detect

# every thread this module starts; close() joins exactly these
_KF_JOINABLE_THREADS = (
    "kf-sched-launch", "kf-sched-walk", "kf-sched-gather", "kf-sched-unpack",
)

# registered-tensor identity: (name, size, numpy dtype str, op, kind),
# "ar" allreduce or "zero" sharded update; the consensus digest is built
# from these, byte for byte the reference's
_Key = Tuple[str, int, str, int, str]


def _key_of(w: Workspace, kind: str = "ar") -> _Key:
    return (w.name, int(w.send.numel()), dtype_str(w.send.dtype), int(w.op), kind)


class SchedulerClosed(RuntimeError):
    """Raised by submit/flush after the session epoch ended (resize or
    explicit close): the caller must fetch the NEW session's scheduler."""


class _Unit:
    """One launch unit of the negotiated plan: a fused allreduce bucket,
    a single workspace, or a sharded-update (ZeRO-1) bucket whose layout
    the registered handler owns."""

    __slots__ = ("index", "keys", "fused", "kind", "zindex")

    def __init__(self, index: int, keys: List[_Key], fused: bool,
                 kind: str = "ar", zindex: int = -1):
        self.index = index
        self.keys = keys
        self.fused = fused
        self.kind = kind  # "ar" | "zero"
        self.zindex = zindex  # handler bucket index for zero units


class CollectiveScheduler:
    """Per-session background scheduler for asynchronous group
    allreduce. Thread-safe submit; one flush caller per round."""

    def __init__(self, sess):
        self.sess = sess
        # the session epoch, stamped with the round on every stage span
        self.epoch_id = int(getattr(sess, "cluster_version", 0))
        self.queue_depth = max(1, int(knobs.get("KF_CONFIG_ASYNC_QUEUE")))
        self._unit_bytes: Dict[int, int] = {}  # unit index -> payload bytes
        self._cond = threading.Condition()
        self._abort = threading.Event()
        self._errors: List[BaseException] = []
        self._closed = False
        # registration (per session epoch, negotiated at first flush)
        self._registry: Optional[List[_Key]] = None
        self._known: set = set()
        self._plan: List[_Unit] = []
        # (prio, seq, workspace, kind) of pre-registration submissions
        self._first_round: List[Tuple[int, int, Workspace, str]] = []
        # the sharded-update handler (ZeRO-1), one per scheduler epoch
        self._handler = None
        # per-round state (all under _cond)
        self._round = 0
        self._pending: Dict[_Key, Workspace] = {}
        self._submitted: set = set()
        self._next_unit = 0
        # flush barrier: units whose GRADIENT work finished this round
        self._grad_done = 0
        # sharded units whose weight all-gather has not landed yet
        self._gather_outstanding = 0
        self._busy_s = 0.0  # pack+walk+gather+unpack seconds this round
        self._queued = 0  # units packed but not yet unpacked (gauge)
        self._inflight_bytes = 0  # payload bytes of those units
        self._stat = {
            "rounds": 0, "units": 0, "buckets": 0, "zero_units": 0,
            "flush_wait_s": 0.0, "busy_s": 0.0, "overlap_s": 0.0,
        }
        self._threads: List[threading.Thread] = []
        self._walkq = HandoffQueue(maxsize=self.queue_depth, abort=self._abort)
        self._gatherq = HandoffQueue(maxsize=1, abort=self._abort)
        self._unpackq = HandoffQueue(maxsize=1, abort=self._abort)
        if tconfig.metrics_enabled():
            self._queued_gauge = tmetrics.gauge(
                "kungfu_scheduler_queued_buckets",
                "Async-scheduler launch units currently packed or "
                "walking (not yet unpacked)",
            )
            self._overlap_ctr = tmetrics.counter(
                "kungfu_scheduler_overlap_seconds_total",
                "Scheduler engine-busy seconds that overlapped caller "
                "compute (busy time minus flush wait, per round)",
            )
            self._flush_wait_ctr = tmetrics.counter(
                "kungfu_scheduler_flush_wait_seconds",
                "Seconds flush() blocked waiting for in-flight buckets",
            )
        else:
            self._queued_gauge = self._overlap_ctr = self._flush_wait_ctr = None

    def inflight_bytes(self) -> int:
        """Payload bytes of units packed but not yet unpacked."""
        with self._cond:
            return self._inflight_bytes

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, w: Workspace, priority: Optional[int] = None,
               handler=None) -> None:
        """Hand one tensor's workspace to the scheduler as it becomes
        ready. Thread-safe; returns immediately. `w.send` and `w.recv`
        must stay valid until the round's `flush()` returns, and `w.name`
        must be STABLE across rounds (the scheduler stamps its own round
        counter into wire names).

        `priority` shapes the negotiated launch order during the FIRST
        round only (lower launches earlier, default = arrival order).

        `handler` (a ShardedUpdateSession) marks this tensor as a
        sharded-update (ZeRO-1) gradient; `w.recv` is then NOT written.
        Pass it on EVERY submit of a sharded tensor."""
        if w.is_empty:
            return
        kind = "ar" if handler is None else "zero"
        key = _key_of(w, kind)
        with self._cond:
            self._raise_if_dead_locked()
            if handler is not None:
                if self._handler is None:
                    self._handler = handler
                elif self._handler is not handler:
                    raise ValueError(
                        "a scheduler epoch supports ONE sharded-update "
                        "handler — rebuild the ShardedUpdateSession "
                        "instead of mixing two")
            if self._registry is None:
                seq = len(self._first_round)
                prio = seq if priority is None else int(priority)
                self._first_round.append((prio, seq, w, kind))
                return
            if key not in self._known:
                raise ValueError(
                    f"submit of unregistered tensor {key[0]!r} "
                    f"(size={key[1]}, dtype={key[2]}, op={key[3]}, "
                    f"kind={key[4]}) — the registered set is negotiated "
                    "at the first flush and fixed for the session epoch; "
                    "resize to change it")
            if key in self._submitted:
                raise ValueError(
                    f"tensor {key[0]!r} submitted twice in round "
                    f"{self._round} — call flush() between rounds")
            self._submitted.add(key)
            self._pending[key] = w
            self._cond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every workspace submitted this round has been
        reduced and scattered back, then advance the round. Re-raises the
        scheduler's REAL error (walk failure, abort) if one occurred. The
        first flush of a session epoch performs the registration
        handshake."""
        t0 = time.perf_counter()
        with trace.span("sched.flush"), stall_detect("scheduler.flush"):
            with self._cond:
                self._raise_if_dead_locked()
                if self._registry is None and not self._first_round:
                    # nothing was ever submitted: registering an empty set
                    # would freeze the epoch's registry as {}
                    return
                if self._registry is not None and not self._submitted:
                    return  # clean round boundary, zero submissions
            if self._registry is None:
                self._register()
            with self._cond:
                self._raise_if_dead_locked()
                missing = self._known - self._submitted
                if missing:
                    names = sorted(k[0] for k in missing)[:8]
                    raise RuntimeError(
                        f"flush() with {len(missing)} registered tensors "
                        f"not submitted this round (e.g. {names}) — every "
                        "registered tensor must be submitted exactly once "
                        "per round")
            if timeout is None:
                timeout = self.sess.timeout * max(1, len(self._plan))
            deadline = time.monotonic() + timeout
            with self._cond:
                while True:
                    if self._errors:
                        raise self._errors[0]
                    if self._closed:
                        raise SchedulerClosed(
                            "collective scheduler closed (session epoch "
                            "ended) during flush")
                    if self._grad_done >= len(self._plan):
                        break
                    if time.monotonic() >= deadline:
                        self._abort.set()
                        raise TimeoutError(
                            f"scheduler flush timed out: "
                            f"{self._grad_done}/{len(self._plan)} units "
                            f"done in round {self._round}")
                    self._cond.wait(0.2)
                # advance the round (sharded units' weight all-gathers
                # may still be walking; wait_gather is their barrier)
                wait = time.perf_counter() - t0
                busy = self._busy_s
                self._round += 1
                self._pending.clear()
                self._submitted.clear()
                self._next_unit = 0
                self._grad_done = 0
                self._busy_s = 0.0
                self._stat["rounds"] += 1
                self._stat["flush_wait_s"] += wait
                self._stat["busy_s"] += busy
                self._stat["overlap_s"] += max(0.0, busy - wait)
                self._cond.notify_all()
        if self._flush_wait_ctr is not None:
            self._flush_wait_ctr.inc(wait)
        if self._overlap_ctr is not None:
            self._overlap_ctr.inc(max(0.0, busy - wait))

    def round_index(self) -> int:
        """The current (not-yet-flushed) round number."""
        with self._cond:
            return self._round

    def flush_round(self, round_index: Optional[int],
                    timeout: Optional[float] = None) -> None:
        """Flush only if round `round_index` has not been flushed yet
        (the idempotent form behind AsyncGroupResult.wait). `None`
        flushes unconditionally."""
        if round_index is not None:
            with self._cond:
                if self._round > round_index:
                    return
        self.flush(timeout=timeout)

    def wait_gather(self, timeout: Optional[float] = None) -> None:
        """Barrier for the sharded units' weight all-gathers: block until
        every in-flight gather has walked and its weights have been
        scattered back. Call before the next forward consumes the params.
        Re-raises the scheduler's real error like flush."""
        if timeout is None:
            timeout = self.sess.timeout * max(1, len(self._plan))
        deadline = time.monotonic() + timeout
        with trace.span("sched.wait_gather"), stall_detect("scheduler.wait_gather"):
            with self._cond:
                while True:
                    if self._errors:
                        raise self._errors[0]
                    if self._gather_outstanding == 0:
                        return
                    if self._closed:
                        raise SchedulerClosed(
                            "collective scheduler closed (session epoch "
                            "ended) with weight all-gathers in flight — "
                            "the resize drained or cancelled them; "
                            "restore params via the elastic state sync")
                    if time.monotonic() >= deadline:
                        self._abort.set()
                        raise TimeoutError(
                            f"wait_gather timed out with "
                            f"{self._gather_outstanding} weight "
                            "all-gathers in flight")
                    self._cond.wait(0.2)

    def stats(self) -> dict:
        """Lifetime stats: rounds, units/buckets walked, flush-wait vs
        engine-busy seconds and the overlapped share."""
        with self._cond:
            out = dict(self._stat)
        busy = out["busy_s"]
        out["overlap_frac"] = out["overlap_s"] / busy if busy > 0 else 0.0
        return out

    def close(self, timeout: float = 30.0) -> None:
        """End the scheduler: drain in-flight units (bounded by
        `timeout`), cancel everything not yet launched, join the worker
        threads. Idempotent."""
        with self._cond:
            if self._closed:
                started = False
            else:
                self._closed = True
                started = bool(self._threads)
            self._cond.notify_all()
        if not started:
            return
        deadline = time.monotonic() + max(1.0, timeout)
        for t in self._threads:
            t.join(max(0.1, deadline - time.monotonic()))
        if any(t.is_alive() for t in self._threads):
            # drain exceeded its budget: hard-cancel (in-flight walks
            # observe the abort before mutating caller buffers)
            self._abort.set()
            for t in self._threads:
                t.join(5.0)
        with self._cond:
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # registration (once per session epoch)
    # ------------------------------------------------------------------

    def _register(self) -> None:
        """First flush: freeze the submission order into the registered
        tensor order, consensus-check it across peers, derive the bucket
        plan, and start the worker threads."""
        with self._cond:
            self._raise_if_dead_locked()
            if self._registry is not None:
                return
            snapshot = list(self._first_round)
            entries = sorted(snapshot, key=lambda e: (e[0], e[1]))
            registry = [_key_of(w, kd) for _, _, w, kd in entries]
            if len(set(registry)) != len(registry):
                dupes = sorted({k[0] for k in registry if registry.count(k) > 1})[:4]
                raise ValueError(
                    f"duplicate tensors in first round: {dupes} — "
                    "registered names must be unique")
            if any(k[4] == "zero" for k in registry) and self._handler is None:
                raise ValueError(
                    "sharded tensors registered without a sharded-update "
                    "handler — submit them through "
                    "ShardedUpdateSession.submit_grad")
        # consensus OUTSIDE the lock: real collectives on the
        # knob-independent star walk
        digest = ";".join(f"{n}:{s}:{d}:{o}:{kd}" for n, s, d, o, kd in registry).encode()
        if not self.sess._bytes_agree(digest, ":sched:registry", self.sess._fixed_allreduce):
            raise RuntimeError(
                "async scheduler registration diverged across peers: the "
                "first round's (name, size, dtype, op) submission order "
                "must be identical cluster-wide — it becomes the "
                "negotiated launch order (check tensor naming and "
                "per-rank model divergence)")
        plan = self._build_plan(registry)
        known = set(registry)
        unit_bytes = {u.index: sum(k[1] * np.dtype(k[2]).itemsize for k in u.keys)
                      for u in plan}
        with self._cond:
            # validate everything before committing any state; submissions
            # that raced into the consensus window are checked against the
            # registry they were not part of
            pending: Dict[_Key, Workspace] = {}
            submitted: set = set()
            for _, _, w, kd in snapshot:
                pending[_key_of(w, kd)] = w
                submitted.add(_key_of(w, kd))
            for _, _, w, kd in self._first_round[len(snapshot):]:
                key = _key_of(w, kd)
                if key not in known:
                    raise ValueError(
                        f"tensor {key[0]!r} submitted during the "
                        "registration handshake but absent from the "
                        "negotiated set — quiesce submissions around "
                        "the first flush()")
                if key in submitted:
                    raise ValueError(
                        f"tensor {key[0]!r} submitted twice in the "
                        "registration round")
                pending[key] = w
                submitted.add(key)
            self._registry = registry
            self._known = known
            self._plan = plan
            self._unit_bytes = unit_bytes
            self._pending.update(pending)
            self._submitted |= submitted
            self._first_round.clear()
            self._start_threads_locked()
            self._cond.notify_all()

    def _build_plan(self, registry: List[_Key]) -> List[_Unit]:
        """The synchronous path's grouping over registered indices:
        same-(dtype, op) runs of >= FUSE_MIN_TENSORS fuse into <=
        GROUP_BUCKET_BYTES buckets (`_make_buckets`' greedy
        order-preserving packing); smaller groups launch as singles.
        Sharded tensors map onto the handler's own bucket layout. Units
        launch ordered by their first member's registered index."""
        sess = self.sess
        groups: Dict[Tuple[str, int], List[_Key]] = {}
        zero_keys: List[_Key] = []
        for key in registry:
            if key[4] == "zero":
                zero_keys.append(key)
            else:
                groups.setdefault((key[2], key[3]), []).append(key)
        units: List[_Unit] = []
        singles: List[_Key] = []
        for members in groups.values():
            if len(members) < sess.FUSE_MIN_TENSORS:
                singles.extend(members)
                continue
            cur: List[_Key] = []
            cur_bytes = 0
            isize = np.dtype(members[0][2]).itemsize
            for key in members:
                nbytes = key[1] * isize
                if cur and cur_bytes + nbytes > sess.GROUP_BUCKET_BYTES:
                    units.append(_Unit(len(units), cur, fused=True))
                    cur, cur_bytes = [], 0
                cur.append(key)
                cur_bytes += nbytes
            if cur:
                units.append(_Unit(len(units), cur, fused=True))
        for key in singles:
            units.append(_Unit(len(units), [key], fused=False))
        if zero_keys:
            for zi, keys in enumerate(self._handler.plan_units(zero_keys)):
                units.append(_Unit(len(units), list(keys), fused=False, kind="zero", zindex=zi))
        pos = {k: i for i, k in enumerate(registry)}
        units.sort(key=lambda u: pos[u.keys[0]])
        for i, u in enumerate(units):
            u.index = i
        return units

    # ------------------------------------------------------------------
    # worker threads
    # ------------------------------------------------------------------

    def _start_threads_locked(self) -> None:
        self._spawn_registered("kf-sched-launch", self._launch_loop)
        self._spawn_registered("kf-sched-walk", self._walk_loop)
        self._spawn_registered("kf-sched-gather", self._gather_loop)
        self._spawn_registered("kf-sched-unpack", self._unpack_loop)

    def _spawn_registered(self, name: str, target) -> None:
        """The only place this module starts a thread: named in
        `_KF_JOINABLE_THREADS` and kept in `self._threads`, which
        `close()` joins."""
        assert name in _KF_JOINABLE_THREADS
        t = threading.Thread(target=target, name=name, daemon=True)
        self._threads.append(t)
        t.start()

    def _record_error(self, e: BaseException) -> None:
        with self._cond:
            self._errors.append(e)
            self._cond.notify_all()
        self._abort.set()

    def _raise_if_dead_locked(self) -> None:
        if self._errors:
            raise self._errors[0]
        if self._closed:
            raise SchedulerClosed(
                "collective scheduler closed (session epoch ended) — "
                "fetch the current session's scheduler and resubmit")

    def _claim_next(self):
        """Launcher: block until the next unit in plan order has all its
        members submitted; returns (unit, members, round) or None to exit.
        Launch STRICTLY in registered order: the cross-peer determinism
        contract."""
        with self._cond:
            while True:
                if self._abort.is_set() or self._closed:
                    # drain: stop LAUNCHING; in-flight units finish downstream
                    return None
                if self._next_unit < len(self._plan):
                    unit = self._plan[self._next_unit]
                    if all(k in self._pending for k in unit.keys):
                        self._next_unit += 1
                        members = [self._pending.pop(k) for k in unit.keys]
                        return unit, members, self._round
                self._cond.wait(0.2)

    def _launch_loop(self) -> None:
        try:
            while True:
                claimed = self._claim_next()
                if claimed is None:
                    return
                unit, members, rnd = claimed
                t0 = time.perf_counter()
                for w in members:
                    if w.ready is not None:
                        w.ready.synchronize()  # its staging copy has landed
                with trace.step_scope(self.epoch_id, rnd), \
                        trace.span("sched.pack", unit=unit.index):
                    if unit.kind == "zero":
                        # the handler packs into pooled staging and stamps
                        # its own round-qualified wire names (:zrs:/:zag:)
                        item = self._handler.pack(unit.zindex, members, rnd)
                    elif unit.fused:
                        # round-stamped fused name: a fast peer's round r+1
                        # must never be consumed by a slow peer's round r
                        item = self.sess._pack_bucket(unit.index, members,
                                                      name_prefix=f"r{rnd}:")
                    else:
                        w = members[0]
                        item = (Workspace(send=w.send, recv=w.recv, op=w.op,
                                          name=f"{w.name}::as:r{rnd}"),
                                None, None, members)
                self._add_busy(time.perf_counter() - t0, queued=+1,
                               nbytes=self._unit_bytes[unit.index])
                if not self._walkq.put((unit, rnd, item)):
                    return  # aborted while the queue was full
        except BaseException as e:  # noqa: BLE001 - channeled to flush()
            self._record_error(e)
        finally:
            self._walkq.put(None)

    def _walk_loop(self) -> None:
        try:
            while True:
                got = self._walkq.get()
                if got is None:
                    return
                if self._abort.is_set():
                    continue  # drain to the sentinel
                unit, rnd, item = got
                t0 = time.perf_counter()
                if unit.kind == "zero":
                    with trace.step_scope(self.epoch_id, rnd), \
                            trace.span("sched.walk", unit=unit.index):
                        item = self._handler.reduce_and_update(item, cancel=self._abort)
                    self._add_busy(time.perf_counter() - t0)
                    # the shard is updated: the gradients are consumed, so
                    # this unit passes the flush barrier now; its weight
                    # all-gather overlaps the caller's next-step compute
                    with self._cond:
                        self._grad_done += 1
                        self._gather_outstanding += 1
                        self._cond.notify_all()
                    if not self._gatherq.put((unit, rnd, item)):
                        return
                    continue
                with trace.step_scope(self.epoch_id, rnd), \
                        trace.span("sched.walk", unit=unit.index):
                    if unit.fused:
                        deferred = self.sess._allreduce_ws(item[0], cancel=self._abort,
                                                           defer_decode=True)
                    else:
                        self.sess._allreduce_ws(item[0], cancel=self._abort)
                        deferred = None
                self._add_busy(time.perf_counter() - t0)
                if not self._gatherq.put((unit, rnd, item + (deferred,))):
                    return
        except BaseException as e:  # noqa: BLE001 - channeled to flush()
            self._record_error(e)
        finally:
            self._gatherq.put(None)

    def _gather_loop(self) -> None:
        """Weight all-gather stage (sharded units only; allreduce units
        pass straight through, so the chain stays linear)."""
        try:
            while True:
                got = self._gatherq.get()
                if got is None:
                    return
                if self._abort.is_set():
                    continue  # drain to the sentinel
                unit, rnd, item = got
                if unit.kind == "zero":
                    t0 = time.perf_counter()
                    with trace.step_scope(self.epoch_id, rnd), \
                            trace.span("sched.gather", unit=unit.index):
                        item = self._handler.gather(item, cancel=self._abort)
                    self._add_busy(time.perf_counter() - t0)
                if not self._unpackq.put((unit, rnd, item)):
                    return
        except BaseException as e:  # noqa: BLE001 - channeled to flush()
            self._record_error(e)
        finally:
            self._unpackq.put(None)

    def _unpack_loop(self) -> None:
        try:
            while True:
                got = self._unpackq.get()
                if got is None:
                    return
                if self._abort.is_set():
                    continue  # aborted: must not touch caller buffers
                unit, rnd, item = got
                t0 = time.perf_counter()
                nbytes = self._unit_bytes[unit.index]
                if unit.kind == "zero":
                    with trace.step_scope(self.epoch_id, rnd), \
                            trace.span("sched.unpack", unit=unit.index):
                        self._handler.scatter(item, cancel=self._abort)
                    self._add_busy(time.perf_counter() - t0, queued=-1, nbytes=-nbytes)
                    with self._cond:
                        self._gather_outstanding -= 1
                        self._stat["units"] += 1
                        self._stat["zero_units"] += 1
                        self._cond.notify_all()
                    continue
                if unit.fused:
                    with trace.step_scope(self.epoch_id, rnd), \
                            trace.span("sched.unpack", unit=unit.index):
                        self.sess._unpack_bucket(item, self._abort)
                elif item[4] is not None:
                    # single: the walk wrote w.recv in place
                    item[4].close()
                self._add_busy(time.perf_counter() - t0, queued=-1, nbytes=-nbytes)
                with self._cond:
                    self._grad_done += 1
                    self._stat["units"] += 1
                    if unit.fused:
                        self._stat["buckets"] += 1
                    self._cond.notify_all()
        except BaseException as e:  # noqa: BLE001 - channeled to flush()
            self._record_error(e)

    def _add_busy(self, seconds: float, queued: int = 0, nbytes: int = 0) -> None:
        """Engine-busy seconds; a unit enters (pack: `queued` +1) or
        leaves (unpack: -1) the queue with its `nbytes` of payload."""
        with self._cond:
            self._busy_s += seconds
            self._queued += queued
            self._inflight_bytes = max(0, self._inflight_bytes + nbytes)
            q = self._queued
        if queued and self._queued_gauge is not None:
            self._queued_gauge.set(q)
