"""Steptrace: per-step cross-peer critical-path timelines.

Port of `kungfu_tpu/telemetry/steptrace.py`. After the link table (per-edge bandwidth), the walk profiler (per-walk
wait/compute/send) and the straggler scorer (per-peer z-scores), the
question every adaptation policy actually asks was still unanswerable:
*"for step N, which bucket on which peer over which edge was the long
pole, and how much of the step did overlap hide?"* This module is that
plane:

- worker side, a bounded ring (``KF_STEP_TIMELINE_KEEP``) of
  :class:`StepRecorder` timelines, one per scheduler round, fed by the
  async collective scheduler (submit → launch queue delay per bucket,
  walk wall/wait/send with the successor-edge attribution the walk
  engine already computes for the profiler, unpack, the ZeRO weight
  all-gather tail) and served at ``/steptrace``;
- pure merge math (:func:`merge_steps`, :func:`critical_path`) the
  cluster aggregator applies over every worker's timelines, aligned by
  the NTP-style clock offsets it already estimates for /cluster/trace —
  electing each step's **critical (peer, bucket, edge)** chain and its
  overlap fraction (comm hidden under compute / total comm);
- lane rendering (:func:`render_step`, :func:`render_timeline`) shared
  by the ``info steps`` view and the flight recorder's postmortem view.

Sampling: ``KF_TELEMETRY_SPAN_SAMPLE`` thins recording with the same
deterministic evenly-spaced sampler the per-step walk spans use; a
sampled-out step allocates NO timeline (asserted by a subprocess
overhead guard in the tests). Times are perf_counter
microseconds — the span tracer's timebase — so the aggregator's clock
offsets apply unchanged.

This module must stay import-light (telemetry-only imports): the walk
engine consults :func:`current_sink` on every allreduce walk. The store
registers a memory-plane accountant (:meth:`StepStore.footprint_bytes`,
the ring's cap) in the ``telemetry`` bucket.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import memory as tmemory

_US = 1e6


def _now_us() -> float:
    return time.perf_counter() * _US


class _Sampler:
    """Deterministic evenly-spaced sampler (the SpanSampler math, local
    so the telemetry layer never imports the collective package): step n
    records iff the integer part of n*rate advances."""

    __slots__ = ("_n", "_lock")

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def sample(self, rate: float) -> bool:
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        with self._lock:
            self._n += 1
            n = self._n
        return int(n * rate) != int((n - 1) * rate)


class BucketLane:
    """One launch unit's lane of a step timeline. Mutated from several
    scheduler threads (launcher/walker/gatherer/unpacker touch disjoint
    fields; ``add_walk`` may be fed from pool threads) — the single
    small lock keeps the JSON rendering consistent."""

    __slots__ = (
        "index", "kind", "name", "nbytes", "members",
        "t_submit_us", "t_ready_us", "t_launch_us",
        "t_walk_us", "walk_us", "wait_us", "send_us",
        "unpack_us", "t_gather_us", "gather_us", "gather_wait_us",
        "edge", "gather_edge", "strategy", "_lock",
    )

    def __init__(self, index: int, kind: str = "ar", name: str = "",
                 nbytes: int = 0, members: int = 0):
        self.index = index
        self.kind = kind
        self.name = name
        self.nbytes = nbytes
        self.members = members
        self.t_submit_us: Optional[float] = None  # first member submitted
        self.t_ready_us: Optional[float] = None  # last member submitted
        self.t_launch_us: Optional[float] = None  # launcher claimed it
        self.t_walk_us: Optional[float] = None  # walk began
        self.walk_us = 0.0
        self.wait_us = 0.0  # blocked on predecessor receives
        self.send_us = 0.0  # blocked on successor sends
        self.unpack_us = 0.0
        self.t_gather_us: Optional[float] = None  # ZeRO weight all-gather
        self.gather_us = 0.0
        self.gather_wait_us = 0.0
        self.edge: Optional[str] = None  # successor/slowest dst of the walk
        self.gather_edge: Optional[str] = None
        self.strategy: Optional[str] = None
        self._lock = threading.Lock()

    # -- scheduler feed points ------------------------------------------
    def note_submit(self, t_us: float) -> None:
        with self._lock:
            if self.t_submit_us is None or t_us < self.t_submit_us:
                self.t_submit_us = t_us
            if self.t_ready_us is None or t_us > self.t_ready_us:
                self.t_ready_us = t_us

    def note_launch(self, t_us: float) -> None:
        self.t_launch_us = t_us

    def note_walk_span(self, t0_us: float, dur_us: float) -> None:
        with self._lock:
            if self.t_walk_us is None:
                self.t_walk_us = t0_us
            self.walk_us += dur_us

    def note_unpack(self, dur_us: float) -> None:
        with self._lock:
            self.unpack_us += dur_us

    def note_gather_span(self, t0_us: float, dur_us: float) -> None:
        with self._lock:
            if self.t_gather_us is None:
                self.t_gather_us = t0_us
            self.gather_us += dur_us

    # -- walk-engine feed (via the thread-ambient sink) -----------------
    def add_walk(self, strategy: str, wall_s: float, wait_s: float,
                 send_s: float, edge: Optional[str],
                 gather: bool = False) -> None:
        """One finished walk's attribution (the same numbers the walk
        profiler gets), accumulated into the lane. `gather=True` routes
        a ZeRO weight all-gather's split into the gather fields."""
        with self._lock:
            if gather:
                self.gather_wait_us += wait_s * _US
                if edge:
                    self.gather_edge = edge
            else:
                self.wait_us += wait_s * _US
                self.send_us += send_s * _US
                if edge:
                    self.edge = edge
            if strategy:
                self.strategy = strategy

    # -- derived --------------------------------------------------------
    def queue_delay_us(self) -> float:
        if self.t_launch_us is None or self.t_ready_us is None:
            return 0.0
        return max(0.0, self.t_launch_us - self.t_ready_us)

    def _blocked_scaled(self) -> Tuple[float, float]:
        """(wait, send) clamped so their sum never exceeds the walk's
        wall span — the WalkProfiler clamp, needed here because CHUNKED
        graph walks accumulate each parallel chunk's blocked time into
        one lane whose walk_us is a single wall-clock window: k chunks
        waiting ~W concurrently sum to k*W > walk_us, and an unclamped
        subtraction would zero a genuinely-blocking peer's self time
        (electing the wrong critical peer). Scaling preserves the
        wait:send ratio, which is the signal."""
        blocked = self.wait_us + self.send_us
        if blocked <= self.walk_us or blocked <= 0.0:
            return self.wait_us, self.send_us
        f = self.walk_us / blocked
        return self.wait_us * f, self.send_us * f

    def _gather_wait_scaled(self) -> float:
        return min(self.gather_wait_us, self.gather_us)

    def self_us(self) -> float:
        """Seconds this bucket was the long pole rather than a victim:
        non-wait walk time (compute + send-blocked — a slow OUTGOING
        edge blocks the sender, a slow peer inflates compute) plus the
        gather's non-wait share and the unpack."""
        wait, _ = self._blocked_scaled()
        walk_self = max(0.0, self.walk_us - wait)
        gather_self = max(0.0, self.gather_us - self._gather_wait_scaled())
        return walk_self + gather_self + self.unpack_us

    def to_json(self) -> dict:
        with self._lock:
            wait, send = self._blocked_scaled()
            compute = max(0.0, self.walk_us - wait - send)
            d = {
                "index": self.index,
                "kind": self.kind,
                "name": self.name,
                "bytes": self.nbytes,
                "members": self.members,
                "t_submit_us": _r(self.t_submit_us),
                "t_ready_us": _r(self.t_ready_us),
                "t_launch_us": _r(self.t_launch_us),
                "queue_delay_us": _r(self.queue_delay_us()),
                "t_walk_us": _r(self.t_walk_us),
                "walk_us": _r(self.walk_us),
                "wait_us": _r(wait),
                "send_us": _r(send),
                "compute_us": _r(compute),
                "unpack_us": _r(self.unpack_us),
                "self_us": _r(self.self_us()),
                "edge": self.edge,
                "strategy": self.strategy,
            }
            if self.t_gather_us is not None or self.gather_us:
                d["t_gather_us"] = _r(self.t_gather_us)
                d["gather_us"] = _r(self.gather_us)
                d["gather_wait_us"] = _r(self._gather_wait_scaled())
                d["gather_edge"] = self.gather_edge
            return d


def _r(v: Optional[float]) -> Optional[int]:
    return int(round(v)) if isinstance(v, (int, float)) else None


class StepRecorder:
    """One scheduler round's timeline on this worker. Created by the
    store (subject to sampling), fed by the scheduler, finished at
    flush; the ZeRO gather tail keeps landing after finish() — the ring
    holds the recorder and renders at export time, so late gathers
    still appear."""

    # allocation counter for the sampling overhead guard (a subprocess
    # test asserts it stays 0 when KF_TELEMETRY_SPAN_SAMPLE=0)
    allocations = 0

    __slots__ = (
        "epoch", "round", "t_begin_us", "t_end_us",
        "flush_wait_us", "busy_us", "buckets", "_lock", "flush_seq",
    )

    def __init__(self, epoch: int, round_: int):
        StepRecorder.allocations += 1
        self.epoch = int(epoch)
        self.round = int(round_)
        self.t_begin_us = _now_us()
        self.t_end_us: Optional[float] = None
        # delta-scrape cursor: assigned by the store at the
        # first export AFTER the timeline flushed — transport metadata,
        # deliberately kept out of to_json so merged lanes are identical
        # whether the scraper used a cursor or not
        self.flush_seq: Optional[int] = None
        self.flush_wait_us = 0.0
        self.busy_us = 0.0
        self.buckets: Dict[int, BucketLane] = {}
        self._lock = threading.Lock()

    def bucket(self, index: int, kind: str = "ar", name: str = "",
               nbytes: int = 0, members: int = 0) -> BucketLane:
        with self._lock:
            b = self.buckets.get(index)
            if b is None:
                b = self.buckets[index] = BucketLane(
                    index, kind, name, nbytes, members
                )
            return b

    def finish(self, flush_wait_s: float, busy_s: float) -> None:
        self.flush_wait_us = flush_wait_s * _US
        self.busy_us = busy_s * _US
        self.t_end_us = _now_us()

    def overlap_frac(self) -> Optional[float]:
        """Comm hidden under compute / total comm for this step: the
        engine-busy time not surfaced as flush wait (the scheduler's own
        overlap measure)."""
        if self.busy_us <= 0:
            return None
        return max(0.0, self.busy_us - self.flush_wait_us) / self.busy_us

    def queue_delay_frac(self) -> Optional[float]:
        if self.busy_us <= 0:
            return None
        # copy under the lock: submit threads insert lanes into the live
        # dict while scrapes/snapshots/policy signals read the recorder
        # (it sits in the ring from begin_step on) — iterating the dict
        # itself would intermittently raise "changed size during
        # iteration" exactly on busy steps
        with self._lock:
            lanes = list(self.buckets.values())
        return sum(b.queue_delay_us() for b in lanes) / self.busy_us

    def to_json(self) -> dict:
        with self._lock:
            buckets = sorted(self.buckets.values(), key=lambda b: b.index)
        return {
            "epoch": self.epoch,
            "round": self.round,
            "t_begin_us": _r(self.t_begin_us),
            "t_end_us": _r(self.t_end_us),
            "flush_wait_us": _r(self.flush_wait_us),
            "busy_us": _r(self.busy_us),
            "overlap_frac": self.overlap_frac(),
            "queue_delay_frac": self.queue_delay_frac(),
            "buckets": [b.to_json() for b in buckets],
        }


class StepStore:
    """Bounded ring of recent step timelines (KF_STEP_TIMELINE_KEEP)."""

    def __init__(self, keep: Optional[int] = None):
        self._keep = keep if keep is not None else max(
            0, int(knobs.get("KF_STEP_TIMELINE_KEEP"))
        )
        self._ring: "deque[StepRecorder]" = deque(maxlen=max(1, self._keep))
        self._lock = threading.Lock()
        self._sampler = _Sampler()
        self._stats = {"recorded": 0, "sampled_out": 0}
        # delta-scrape cursor space: monotonically increasing across the
        # store's lifetime (clear() keeps it), stamped onto timelines at
        # the first export after they flush — `?since=N` re-scrapes ship
        # only newly-flushed timelines
        self._seq = 0
        # memory plane: the ring is a long-lived buffer owner reporting its cap
        tmemory.register_owner("steptrace", "telemetry", self, lambda st: st.footprint_bytes())

    def footprint_bytes(self) -> int:
        """Capacity estimate of the step ring in bytes (the memory plane's
        `telemetry` bucket): the mean timeline size x the ring's maxlen,
        so a filling ring reports a constant."""
        with self._lock:
            ring = list(self._ring)
        return tmemory.ring_cap_bytes(deque(ring, maxlen=self._ring.maxlen))

    def begin_step(self, epoch: int, round_: int) -> Optional[StepRecorder]:
        """Start recording one round, or None when the ring is disabled
        (keep=0) or the deterministic sampler thins this step — the None
        path allocates nothing (overhead-guard contract)."""
        if self._keep <= 0:
            return None
        if not self._sampler.sample(tconfig.span_sample()):
            with self._lock:
                self._stats["sampled_out"] += 1
            return None
        rec = StepRecorder(epoch, round_)
        with self._lock:
            self._ring.append(rec)
            self._stats["recorded"] += 1
        return rec

    def timelines(self) -> List[dict]:
        with self._lock:
            recs = list(self._ring)
        return [r.to_json() for r in recs]

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._stats = {"recorded": 0, "sampled_out": 0}

    def export(self, peer: str = "", since: Optional[int] = None) -> dict:
        """The /steptrace document: the ring plus the clock anchors the
        aggregator needs (perf_now_us matches the X-KF-Perf-Now-Us
        header timebase).

        ``since`` is the delta-scrape cursor: each timeline
        is stamped with a monotonic flush seq at its first post-flush
        export, carried transport-side as ``seq`` (NOT in the merged
        lanes); ``since=N`` ships only flushed timelines with seq > N,
        and ``next_since`` is the cursor for the next scrape. A
        timeline that falls off the ring before it is ever shipped is
        lost — the same bounded-ring contract the full export has."""
        with self._lock:
            recs = list(self._ring)
            for r in recs:
                if r.t_end_us is not None and r.flush_seq is None:
                    self._seq += 1
                    r.flush_seq = self._seq
            next_since = self._seq
        timelines = []
        for r in recs:
            if since is not None and (
                r.t_end_us is None
                or (r.flush_seq or 0) <= since
            ):
                continue
            d = r.to_json()
            if r.flush_seq is not None:
                d["seq"] = r.flush_seq
            timelines.append(d)
        return {
            "peer": peer or knobs.raw("KF_SELF_SPEC"),
            "perf_now_us": _now_us(),
            "wall_time_s": time.time(),
            "keep": self._keep,
            "next_since": next_since,
            "stats": self.stats(),
            "timelines": timelines,
        }

    def local_signals(self) -> Dict[str, float]:
        """Worker-local adaptation signals (the cluster-wide merge
        overrides these in PolicyContext.metrics when a runner
        aggregator is live): the mean overlap and queue-delay fractions
        of the recent recorded steps."""
        with self._lock:
            recs = list(self._ring)
        ov = [r.overlap_frac() for r in recs]
        qd = [r.queue_delay_frac() for r in recs]
        ov = [v for v in ov if v is not None]
        qd = [v for v in qd if v is not None]
        out: Dict[str, float] = {}
        if ov:
            out["step/overlap_frac"] = sum(ov) / len(ov)
        if qd:
            out["step/queue_delay_frac"] = sum(qd) / len(qd)
        return out


_store: Optional[StepStore] = None
_store_lock = threading.Lock()


def get_store() -> StepStore:
    global _store
    with _store_lock:
        if _store is None:
            _store = StepStore()
        return _store


def reset_store() -> None:
    """Drop the process store (tests flip knobs at runtime)."""
    global _store
    with _store_lock:
        _store = None


# ---------------------------------------------------------------------------
# thread-ambient walk sink: the scheduler parks the active bucket lane
# here around each walk; the walk engine's _record_walk feeds it the
# same wait/send/edge attribution the profiler gets. Read once per walk
# on the walking thread (chunked graph walks fan out to pool threads,
# so the engine captures the sink before dispatching).
# ---------------------------------------------------------------------------

_sink_tls = threading.local()


class _SinkScope:
    __slots__ = ("lane", "gather", "prev")

    def __init__(self, lane: Optional[BucketLane], gather: bool):
        self.lane = lane
        self.gather = gather

    def __enter__(self):
        self.prev = getattr(_sink_tls, "cur", None)
        _sink_tls.cur = (
            None if self.lane is None else (self.lane, self.gather)
        )
        return self

    def __exit__(self, *exc):
        _sink_tls.cur = self.prev
        return False


def walk_sink(lane: Optional[BucketLane], gather: bool = False) -> _SinkScope:
    """Route walk attribution on this thread into `lane` (None = no-op
    scope, the sampled-out path)."""
    return _SinkScope(lane, gather)


def current_sink() -> Optional[Tuple[BucketLane, bool]]:
    return getattr(_sink_tls, "cur", None)


def note_walk(sink: Optional[Tuple[BucketLane, bool]], strategy: str,
              wall_s: float, wait_s: float, send_s: float,
              edge: Optional[str]) -> None:
    """Feed one finished walk's attribution to a captured sink (the walk
    engine calls this next to its profiler feed)."""
    if sink is None:
        return
    lane, gather = sink
    lane.add_walk(strategy, wall_s, wait_s, send_s, edge, gather=gather)


# ---------------------------------------------------------------------------
# merge math (pure: the aggregator and the property tests drive it)
# ---------------------------------------------------------------------------

_ALIGN_KEYS = (
    "t_submit_us", "t_ready_us", "t_launch_us", "t_walk_us", "t_gather_us",
)


def align_timeline(tl: dict, offset_us: float) -> dict:
    """A copy of one timeline with every absolute perf_counter stamp
    shifted by `offset_us` onto the merger's timeline (the aggregator's
    NTP-style clock offset: runner_time = worker_time + offset)."""
    out = dict(tl)
    # the delta-scrape cursor is transport metadata between
    # one store and one scraper — merged lanes must be identical whether
    # the scraper used a cursor or not
    out.pop("seq", None)
    for key in ("t_begin_us", "t_end_us"):
        if isinstance(out.get(key), (int, float)):
            out[key] = out[key] + offset_us
    buckets = []
    for b in tl.get("buckets", []):
        nb = dict(b)
        for key in _ALIGN_KEYS:
            if isinstance(nb.get(key), (int, float)):
                nb[key] = nb[key] + offset_us
        buckets.append(nb)
    out["buckets"] = buckets
    return out


def critical_path(peer_timelines: Dict[str, dict],
                  chain_min_frac: float = 0.25,
                  chain_max: int = 5) -> dict:
    """Elect one step's blocking chain from its per-peer timelines.

    Per (peer, bucket) the blocking contribution is ``self_us``: walk
    time NOT spent waiting on a predecessor (compute + send-blocked —
    under synchronous collectives the waiters are victims; the peer
    whose time went to compute or to a blocked send toward a slow edge
    is the cause) plus the gather's non-wait share and the unpack. The
    critical element is the max; the chain is every contribution within
    ``chain_min_frac`` of it, largest first (the cross-peer tail of the
    same slow edge shows up here)."""
    contribs: List[dict] = []
    for peer, tl in peer_timelines.items():
        for b in tl.get("buckets", []):
            self_us = b.get("self_us")
            if self_us is None:
                walk = b.get("walk_us") or 0.0
                wait = b.get("wait_us") or 0.0
                gather = b.get("gather_us") or 0.0
                gwait = b.get("gather_wait_us") or 0.0
                self_us = (
                    max(0.0, walk - wait)
                    + max(0.0, gather - gwait)
                    + (b.get("unpack_us") or 0.0)
                )
            contribs.append({
                "peer": peer,
                "bucket": b.get("index"),
                "name": b.get("name"),
                "edge": b.get("edge") or b.get("gather_edge"),
                "strategy": b.get("strategy"),
                "self_us": float(self_us),
            })
    if not contribs:
        return {"critical": None, "chain": []}
    contribs.sort(key=lambda c: -c["self_us"])
    top = contribs[0]
    cut = top["self_us"] * chain_min_frac
    chain = [c for c in contribs if c["self_us"] >= cut][:chain_max]
    return {"critical": top, "chain": chain}


def merge_steps(peer_docs: Dict[str, dict],
                offsets_us: Dict[str, float],
                limit: Optional[int] = None) -> List[dict]:
    """Merge every peer's /steptrace document into per-step records,
    oldest first: group timelines by (epoch, round), align each peer's
    stamps by its clock offset, elect the critical chain and compute
    the step-wide overlap / queue-delay fractions (busy-weighted across
    peers). Peers missing a step (sampling thins independently) simply
    don't contribute; a step nobody recorded doesn't exist."""
    grouped: Dict[Tuple[int, int], Dict[str, dict]] = {}
    for peer, doc in peer_docs.items():
        off = offsets_us.get(peer) or 0.0
        for tl in (doc or {}).get("timelines", []):
            key = (int(tl.get("epoch", 0)), int(tl.get("round", 0)))
            grouped.setdefault(key, {})[peer] = align_timeline(tl, off)
    steps: List[dict] = []
    for (epoch, rnd) in sorted(grouped):
        peers = grouped[(epoch, rnd)]
        busy = sum((tl.get("busy_us") or 0.0) for tl in peers.values())
        flush = sum((tl.get("flush_wait_us") or 0.0) for tl in peers.values())
        qdelay = sum(
            (b.get("queue_delay_us") or 0.0)
            for tl in peers.values()
            for b in tl.get("buckets", [])
        )
        begins = [
            tl["t_begin_us"] for tl in peers.values()
            if isinstance(tl.get("t_begin_us"), (int, float))
        ]
        # the step window extends past the flush seal to cover ZeRO
        # gather tails (which land after flush by design) — otherwise
        # the lanes clip the 'g' cells the legend advertises while the
        # election still counts the full gather time
        ends = [
            tl["t_end_us"] for tl in peers.values()
            if isinstance(tl.get("t_end_us"), (int, float))
        ]
        for tl in peers.values():
            for b in tl.get("buckets", []):
                g0 = b.get("t_gather_us")
                if isinstance(g0, (int, float)):
                    ends.append(g0 + (b.get("gather_us") or 0.0))
        elected = critical_path(peers)
        steps.append({
            "epoch": epoch,
            "round": rnd,
            "peers": peers,
            "t_begin_us": min(begins) if begins else None,
            "t_end_us": max(ends) if ends else None,
            "wall_us": (
                max(ends) - min(begins) if begins and ends else None
            ),
            "overlap_frac": (
                max(0.0, busy - flush) / busy if busy > 0 else None
            ),
            "queue_delay_frac": qdelay / busy if busy > 0 else None,
            "critical": elected["critical"],
            "chain": elected["chain"],
        })
    if limit is not None and len(steps) > limit:
        steps = steps[-limit:]
    return steps


# ---------------------------------------------------------------------------
# lane rendering (info steps + the flight postmortem's final step)
# ---------------------------------------------------------------------------

_LANE_W = 40


def _lane(tl: dict, t0: float, t1: float, width: int = _LANE_W) -> str:
    """One peer's timeline as a fixed-width lane over [t0, t1]:
    '·' queued (submitted, not launched), '≈' wait-on-recv, '■' compute,
    '>' send-blocked, 'g' gather tail, ' ' idle."""
    span = max(1.0, t1 - t0)
    cells = [" "] * width

    def paint(a: Optional[float], dur: float, ch: str) -> None:
        if not isinstance(a, (int, float)) or dur <= 0:
            return
        lo = int((a - t0) / span * width)
        hi = int((a + dur - t0) / span * width)
        for i in range(max(0, lo), min(width, max(hi, lo + 1))):
            if cells[i] == " ":
                cells[i] = ch

    for b in tl.get("buckets", []):
        walk0 = b.get("t_walk_us")
        wait = b.get("wait_us") or 0.0
        send = b.get("send_us") or 0.0
        walk = b.get("walk_us") or 0.0
        # phase order inside one bucket's walk window is interleaved in
        # reality; the lane shows wait first, then compute, then send —
        # proportions right, sequence schematic
        paint(b.get("t_ready_us"), b.get("queue_delay_us") or 0.0, "·")
        if isinstance(walk0, (int, float)):
            paint(walk0, wait, "≈")
            paint(walk0 + wait, max(0.0, walk - wait - send), "■")
            paint(walk0 + max(0.0, walk - send), send, ">")
        paint(b.get("t_gather_us"), b.get("gather_us") or 0.0, "g")
    return "".join(cells)


def render_step(step: dict) -> List[str]:
    """One merged step as aligned per-peer lanes with the critical chain
    called out (the `info steps` frame unit)."""
    crit = step.get("critical") or {}
    ov = step.get("overlap_frac")
    qd = step.get("queue_delay_frac")
    head = f"step e{step.get('epoch')}:r{step.get('round')}"
    if crit:
        edge = f" edge →{crit['edge']}" if crit.get("edge") else ""
        head += (
            f"  critical {crit.get('peer')} bucket {crit.get('bucket')}"
            f"{edge} ({(crit.get('self_us') or 0.0) / 1e3:.1f} ms)"
        )
    if ov is not None:
        head += f"  overlap {ov:.0%}"
    if qd is not None:
        head += f"  queue {qd:.0%}"
    lines = [head]
    peers = step.get("peers", {})
    t0 = step.get("t_begin_us")
    t1 = step.get("t_end_us")
    if not isinstance(t0, (int, float)) or not isinstance(t1, (int, float)):
        return lines
    crit_peer = crit.get("peer")
    for peer in sorted(peers):
        mark = "*" if peer == crit_peer else " "
        lines.append(f"  {mark}{peer}  |{_lane(peers[peer], t0, t1)}|")
    return lines


def render_timeline(tl: dict, peer: str = "") -> List[str]:
    """One UNMERGED worker timeline (the postmortem's final step: no
    cluster view exists for a dead worker, so the lane is its own)."""
    t0 = tl.get("t_begin_us")
    t1 = tl.get("t_end_us")
    ov = tl.get("overlap_frac")
    head = f"step e{tl.get('epoch')}:r{tl.get('round')}"
    if ov is not None:
        head += f"  overlap {ov:.0%}"
    if not isinstance(t1, (int, float)):
        head += "  (UNFLUSHED — the step was in flight at death)"
        ends = [
            (b.get("t_walk_us") or 0.0) + (b.get("walk_us") or 0.0)
            for b in tl.get("buckets", [])
        ]
        t1 = max(ends) if ends else None
    lines = [head]
    if isinstance(t0, (int, float)) and isinstance(t1, (int, float)):
        label = peer or "self"
        lines.append(f"   {label}  |{_lane(tl, t0, t1)}|")
    for b in tl.get("buckets", []):
        state = "done"
        if b.get("t_launch_us") is None:
            state = "queued (never launched)"
        elif b.get("walk_us") in (None, 0):
            state = "launched, walk never finished"
        elif b.get("kind") == "zero" and not b.get("gather_us"):
            state = "shard updated, weight all-gather outstanding"
        edge = f" edge →{b['edge']}" if b.get("edge") else ""
        lines.append(
            f"   bucket {b.get('index')} [{b.get('kind')}] "
            f"{(b.get('name') or '?')[:40]}{edge}: {state}"
        )
    return lines
