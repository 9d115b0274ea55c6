"""Cluster observability plane: runner-side telemetry aggregation.

Port of `kungfu_tpu/telemetry/cluster.py`. Every worker serves its own
``/metrics`` + ``/trace`` + ``/audit`` endpoint on ``peer_port + 10000``;
this module is the runner-side :class:`TelemetryAggregator` that periodically
scrapes every live worker (it learns the cluster from the elastic
watcher's Stages), merges the results into one cluster snapshot, and
serves it from the watcher's debug endpoint:

- ``/cluster/metrics`` — federated Prometheus exposition, every sample
  labelled ``peer="host:port"`` (collisions become ``exported_peer``,
  the Prometheus federation rule);
- ``/cluster/trace``   — all workers' Chrome traces merged onto the
  runner's timeline, per-peer clock offsets estimated NTP-style from
  the scrape round trip (each response carries the worker's monotonic
  clock in an ``X-KF-Perf-Now-Us`` header; offset error <= RTT/2, and
  the stored offset only improves as lower-RTT scrapes land);
- ``/cluster/health``  — JSON: per-peer step rate, step-time p50/p99,
  bytes tx/rx, last-scrape age, straggler score/flag;
- ``/cluster/links``   — the k×k link matrix: every worker's
  ``kungfu_link_*`` row (passive per-destination EWMA bandwidth/latency
  from real collective traffic) merged into one document, with the
  slowest edge called out — the input signal for straggler-adaptive
  topology re-planning;
- ``/cluster/steps``   — the step plane: every worker's
  ``/steptrace`` ring merged per (session_epoch, round) with the same
  clock offsets, each step carrying its elected critical (peer, bucket,
  edge) chain, overlap fraction and queue-delay fraction — "which
  bucket on which peer over which edge was the long pole" as data;
- ``/cluster/resources`` — the resource plane: every worker's
  ``/resources`` per-thread CPU attribution merged into one view with the
  saturated (compute-bound) peers elected — the input that lets
  straggler events carry ``cause=compute`` vs ``network``;
- ``/cluster/memory`` — the memory plane: every worker's ``/memory``
  bucket decomposition, headroom forecast and thrash flag merged into one
  view with the minimum-headroom peer elected — the grow-gate input and
  the feed for ``cause=memory`` straggler attribution;
- ``/cluster/decisions`` — the decision plane: every
  worker's ``/decisions`` ledger merged into one NTP-aligned causal
  timeline — each adaptation (strategy/wire vote, re-plan, mode flip,
  resize) with its trigger, predicted gain and MEASURED outcome
  (realized gain, verdict, regression flag) — "the cluster adapted;
  did it help?" as data;

On top of the snapshot the aggregator runs straggler detection
(:mod:`~kungfu_tpu_torch.telemetry.straggler`): rolling per-peer step-time
medians, robust-z flagging of slow peers and RTT outliers. Flags are
published three ways so every consumer sees the same truth:
``kungfu_cluster_*`` gauges (the aggregator's own registry, appended to
``/cluster/metrics``), ``telemetry.audit`` events on flag transitions,
and adaptation-facing signals (``monitor.cluster_health()`` →
``PolicyContext.metrics``) that let a ``BasePolicy`` trigger a resize
or strategy switch on skew.

The aggregator scrapes a port worker and a reference worker alike: both
serve the same ``/metrics`` exposition and the same ``/steptrace``,
``/decisions``, ``/resources``, ``/memory`` and ``/host/telemetry``
documents. The aggregator's own state is accounted in its process's
memory plane (``footprint_bytes``, the ``aggregator`` accountant).
"""

from __future__ import annotations

import collections
import json
import math
import threading
import time
import urllib.request
from urllib.parse import urlsplit
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import audit, log, metrics, promparse
from kungfu_tpu_torch.telemetry import decisions as tdecisions
from kungfu_tpu_torch.telemetry import link as tlink
from kungfu_tpu_torch.telemetry import memory as tmemory
from kungfu_tpu_torch.telemetry import resource as tresource
from kungfu_tpu_torch.telemetry import steptrace as tstep
from kungfu_tpu_torch.telemetry import straggler as tstraggler
from kungfu_tpu_torch.telemetry.straggler import StragglerScorer

# metric families scraped off each worker's exposition
STEPS_TOTAL = "kungfu_steps_total"
STEP_SECONDS = "kungfu_step_duration_seconds"
COLLECTIVE_SECONDS = "kungfu_collective_latency_seconds"
EGRESS_BYTES = "kungfu_egress_bytes_total"
INGRESS_BYTES = "kungfu_ingress_bytes_total"
PEER_RTT = "kungfu_peer_rtt_seconds"
# link-plane families: each worker's exposition carries its
# own ROW of the link matrix; the aggregator assembles the k x k view
LINK_BW = "kungfu_link_bandwidth_bytes_per_second"
LINK_LAT = "kungfu_link_latency_seconds"
LINK_BYTES = "kungfu_link_tx_bytes_total"
LINK_MSGS = "kungfu_link_tx_messages_total"
# active-ring families: each worker exports its position in
# the current segmented-ring order and its successor edge, so
# /cluster/links can render the ACTIVE ring next to the measured matrix
RING_POS = "kungfu_topology_ring_position"
RING_NEXT = "kungfu_topology_ring_next"
# two-level plan role: each worker exports its level ("inter"
# head / "intra" member / "flat") and role, value = host-group index, so
# the links view can render the ACTIVE hierarchy (groups, heads, demoted)
RING_ROLE = "kungfu_topology_ring_role"
# active wire precision: each worker exports the RUNNING
# codec mode of its collective session (off/bf16/f16/int8/int4 — config
# + lockstep precision votes), so `info links` can render what the
# cluster's payloads actually cross the transport as
WIRE_MODE = "kungfu_collective_wire_mode"

CLOCK_HEADER = "X-KF-Perf-Now-Us"

# step plane: how many merged steps the aggregator retains
# for /cluster/steps and the info-top critical columns, and how many
# consecutive merged steps the same (peer, edge) must dominate before a
# `step_critical_path` audit event fires (matches StragglerPolicy's
# default patience — one noisy step is weather, three is a bottleneck)
STEP_KEEP = 64
STEP_CRIT_PATIENCE = 3

DEFAULT_INTERVAL = 5.0
INTERVAL_ENV = "KF_CLUSTER_SCRAPE_INTERVAL"
HEALTH_URL_ENV = "KF_CLUSTER_HEALTH_URL"

# lock hierarchy: the host sub-aggregator's serialization lock
# wraps its cache lock in digest(); never acquire them the other way
_KF_LOCK_ORDER = ("_refresh_lock", "_lock")

# the per-worker plane documents a sweep merges (path, digest key)
PLANE_PATHS = (("/steptrace", "steptrace"), ("/decisions", "decisions"),
               ("/resources", "resources"), ("/memory", "memory"))

# the worker endpoint a host head's digest pre-merges
HOST_DIGEST_PATH = "/host/telemetry"

# every /cluster/* route the watcher's debug server exposes, in one
# place: watch.py builds its dispatch from this, so a route added to the
# aggregator can't silently miss the server
CLUSTER_ROUTES = (
    "/cluster/metrics",
    "/cluster/trace",
    "/cluster/health",
    "/cluster/links",
    "/cluster/steps",
    "/cluster/decisions",
    "/cluster/resources",
    "/cluster/memory",
    "/cluster/audit",
    "/cluster/postmortem",
)


def scrape_interval() -> float:
    v = float(knobs.get(INTERVAL_ENV))
    return v if v > 0 else DEFAULT_INTERVAL


def hier_min_peers() -> int:
    """Scale-mode threshold: at or above this many scrape
    targets the aggregator switches to the hierarchical/sampled/delta
    plane; 0 disables scale mode entirely."""
    try:
        return int(knobs.get("KF_AGG_HIER_MIN_PEERS"))
    except (TypeError, ValueError):
        return 32


class _HistSnapshot:
    """Cumulative histogram state parsed from one exposition page."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds, counts, total_sum, count):
        self.bounds = bounds  # sorted finite bucket bounds
        self.counts = counts  # cumulative counts aligned to bounds + [+Inf]
        self.sum = total_sum
        self.count = count

    @classmethod
    def from_samples(cls, samples, family) -> Optional["_HistSnapshot"]:
        buckets = []
        total_sum = total_count = None
        for s in samples:
            if s.name == family + "_bucket":
                le = s.labels_dict().get("le", "")
                bound = math.inf if le == "+Inf" else float(le)
                buckets.append((bound, s.value))
            elif s.name == family + "_sum":
                total_sum = s.value
            elif s.name == family + "_count":
                total_count = s.value
        if not buckets or total_count is None:
            return None
        buckets.sort(key=lambda b: b[0])
        bounds = [b for b, _ in buckets if b != math.inf]
        counts = [c for _, c in buckets]
        return cls(bounds, counts, total_sum or 0.0, total_count)

    def delta(self, prev: Optional["_HistSnapshot"]) -> "_HistSnapshot":
        """Windowed histogram since `prev` (same buckets), or self."""
        if (
            prev is None
            or prev.bounds != self.bounds
            or prev.count > self.count  # worker restarted: counters reset
        ):
            return self
        return _HistSnapshot(
            self.bounds,
            [c - p for c, p in zip(self.counts, prev.counts)],
            self.sum - prev.sum,
            self.count - prev.count,
        )

    def quantile(self, q: float) -> float:
        """Interpolated quantile (histogram_quantile semantics)."""
        total = self.counts[-1] if self.counts else 0
        if total <= 0:
            return math.nan
        rank = q * total
        prev_cum = 0.0
        for i, cum in enumerate(self.counts):
            if cum >= rank and cum > prev_cum:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else math.inf
                if hi == math.inf:
                    return lo
                frac = (rank - prev_cum) / (cum - prev_cum)
                return lo + (hi - lo) * frac
            prev_cum = cum
        return self.bounds[-1] if self.bounds else math.nan

    def to_doc(self) -> dict:
        """JSON-portable form (the host digest ships pre-parsed
        histograms so the root never re-parses k exposition pages)."""
        return {
            "bounds": list(self.bounds),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }

    @classmethod
    def from_doc(cls, doc) -> Optional["_HistSnapshot"]:
        if not isinstance(doc, dict) or "counts" not in doc:
            return None
        bounds = [float(b) for b in doc.get("bounds") or []]
        counts = [float(c) for c in doc.get("counts") or []]
        if not counts:
            return None
        return cls(bounds, counts, float(doc.get("sum") or 0.0),
                   float(doc.get("count") or 0.0))


def parse_worker_page(text: str) -> dict:
    """One pass over a worker's /metrics exposition -> the derived
    fields the aggregator tracks per peer. Factored out of
    _scrape_peer so a host head can pre-parse its local
    siblings' pages and ship the result in its digest: the root then
    ingests k summaries at C-speed JSON cost instead of running the
    pure-Python exposition parser k times per sweep."""
    samples = promparse.parse_text(text)
    tx = rx = None
    coll_sum = None
    rtts: List[float] = []
    links: Dict[str, dict] = {}
    ring_pos = None
    ring_next = None
    ring_role = None
    wire_mode = None
    _link_key = {
        LINK_BW: "bw", LINK_LAT: "latency_s",
        LINK_BYTES: "tx_bytes", LINK_MSGS: "tx_messages",
    }
    for s in samples:
        if s.name == EGRESS_BYTES:
            tx = (tx or 0.0) + s.value
        elif s.name == INGRESS_BYTES:
            rx = (rx or 0.0) + s.value
        elif s.name == COLLECTIVE_SECONDS + "_sum":
            # summed across the per-kind label children: total
            # seconds this worker has spent inside host collectives
            coll_sum = (coll_sum or 0.0) + s.value
        elif s.name == PEER_RTT and math.isfinite(s.value) and s.value > 0:
            rtts.append(s.value)
        elif s.name == RING_POS:
            ring_pos = int(s.value)
        elif s.name == RING_NEXT and s.value:
            ring_next = s.labels_dict().get("dst") or ring_next
        elif s.name == RING_ROLE:
            d = s.labels_dict()
            ring_role = {"level": d.get("level"), "role": d.get("role"),
                         "group": int(s.value)}
        elif s.name == WIRE_MODE and s.value:
            wire_mode = s.labels_dict().get("mode") or wire_mode
        elif s.name in _link_key:
            dst = s.labels_dict().get("dst")
            if dst:
                links.setdefault(dst, {})[_link_key[s.name]] = s.value
    return {
        "steps_total": promparse.sample_value(samples, STEPS_TOTAL),
        "step_hist": _HistSnapshot.from_samples(samples, STEP_SECONDS),
        "coll_sum": coll_sum,
        "bytes_tx": tx,
        "bytes_rx": rx,
        "reported_rtt": sorted(rtts)[len(rtts) // 2] if rtts else None,
        "links": links,
        "ring_pos": ring_pos,
        "ring_next": ring_next,
        "ring_role": ring_role,
        "wire_mode": wire_mode,
    }


def parsed_to_doc(parsed: dict) -> dict:
    """JSON-portable form of a parse_worker_page result (digest wire
    format)."""
    doc = dict(parsed)
    h = doc.get("step_hist")
    doc["step_hist"] = h.to_doc() if isinstance(h, _HistSnapshot) else None
    return doc


def parsed_from_doc(doc: dict) -> dict:
    parsed = dict(doc)
    h = parsed.get("step_hist")
    if not isinstance(h, _HistSnapshot):
        parsed["step_hist"] = _HistSnapshot.from_doc(h)
    parsed.setdefault("steps_total", None)
    parsed.setdefault("coll_sum", None)
    parsed.setdefault("bytes_tx", None)
    parsed.setdefault("bytes_rx", None)
    parsed.setdefault("reported_rtt", None)
    parsed.setdefault("links", {})
    parsed.setdefault("ring_pos", None)
    parsed.setdefault("ring_next", None)
    parsed.setdefault("ring_role", None)
    parsed.setdefault("wire_mode", None)
    return parsed


def _note_clock(
    st: "PeerState", rtt: float, clock: Optional[str],
    t0: float, t1: float,
) -> None:
    """NTP midpoint update shared by the root aggregator and a host
    head: assume the worker stamped its clock header halfway through
    the round trip. perf_counter epochs are fixed per process, so the
    TRUE offset is constant — keep the estimate from the lowest-RTT
    scrape ever seen (its error bound, RTT/2, is the tightest)."""
    if clock is None:
        return
    if rtt <= st.best_rtt_s or st.clock_offset_us is None:
        st.best_rtt_s = rtt
        mid_us = (t0 + t1) / 2.0 * 1e6
        try:
            st.clock_offset_us = mid_us - float(clock)
        except ValueError:
            pass


class _RefreshedPlane:
    """One serialized-refresh + staleness-cache unit: each merged plane
    carries a refresh lock, a monotonic stamp and an inline-staleness
    block — this is that block, once.

    `refresh()` runs the plane's refresh function under the plane's own
    lock (NOT the aggregator state lock: a refresh spans HTTP fetches)
    and stamps the monotonic refresh time on success — two concurrent
    runs would compute freshness against the same baseline and
    double-apply. `ensure_fresh()` is the inline path for one-shot
    consumers (`info X` without a runner loop): refresh when the cache
    is older than the scrape interval, serving the cache over a 500 if
    the refresh fails."""

    def __init__(self, name: str, refresh_fn: Callable[[], None],
                 interval_fn: Callable[[], float]):
        self.name = name
        self._refresh_fn = refresh_fn
        self._interval_fn = interval_fn
        self._lock = threading.Lock()
        self.at: Optional[float] = None  # monotonic, last completed refresh

    def refresh(self) -> None:
        with self._lock:
            try:
                self._refresh_fn()
            finally:
                # stamp even when the fetch round yielded nothing: an
                # empty cluster must not retry on every request
                self.at = time.monotonic()

    def age_s(self) -> Optional[float]:
        return None if self.at is None else time.monotonic() - self.at

    def stale(self) -> bool:
        age = self.age_s()
        return age is None or age >= self._interval_fn()

    def ensure_fresh(self) -> None:
        if not self.stale():
            return
        try:
            self.refresh()
        except Exception as e:  # noqa: BLE001 - serve the cache over a 500
            log.warn(
                "cluster: inline %s refresh failed: %s", self.name, e
            )


class PeerState:
    """Everything the aggregator knows about one scrape target."""

    def __init__(self, label: str, url: str):
        self.label = label
        self.url = url.rstrip("/")
        self.last_ok: Optional[float] = None  # monotonic
        self.last_error: str = ""
        self.scrapes = 0
        self.errors = 0
        # a scrape thread is working this peer; the next sweep skips it
        # rather than interleave prev/current swaps on the same state
        self.inflight = False
        self.rtt_s = math.inf  # last scrape round trip
        self.best_rtt_s = math.inf
        self.clock_offset_us: Optional[float] = None
        self.metrics_text = ""
        # step accounting across scrapes
        self.steps_total: Optional[float] = None
        self.step_hist: Optional[_HistSnapshot] = None
        self.prev_steps: Optional[float] = None
        self.prev_hist: Optional[_HistSnapshot] = None
        self.prev_t: Optional[float] = None
        self.step_rate: Optional[float] = None
        self.step_p50: Optional[float] = None
        self.step_p99: Optional[float] = None
        # collective-wait accounting: in SYNCHRONOUS training every
        # peer's wall-clock step converges to the straggler's (the fast
        # peers spend the difference waiting inside collectives), so the
        # straggler signal is compute time = step - collective wait
        self.coll_sum: Optional[float] = None
        self.coll_count: Optional[float] = None
        self.prev_coll_sum: Optional[float] = None
        self.compute_mean: Optional[float] = None
        self.bytes_tx: Optional[float] = None
        self.bytes_rx: Optional[float] = None
        self.reported_rtt: Optional[float] = None  # median of its probes
        # this peer's link-matrix row, parsed off its last exposition:
        # {dst: {"bw":, "latency_s":, "tx_bytes":, "tx_messages":}}
        self.links: Dict[str, dict] = {}
        # active-ring view: this peer's position in the
        # current ring order and its successor peer label
        self.ring_pos: Optional[int] = None
        self.ring_next: Optional[str] = None
        # two-level role: {"level","role","group"} or None
        self.ring_role: Optional[dict] = None
        # active wire precision: the RUNNING codec mode
        self.wire_mode: Optional[str] = None
        # per-(peer, endpoint) freshness: a peer failing
        # ONE endpoint mid-sweep used to leave that plane's previous
        # payload silently current — last_ok only tracked /metrics.
        # endpoint_at maps "/steptrace" etc. -> monotonic stamp of the
        # last SUCCESSFUL fetch; endpoint_err keeps the last per-
        # endpoint error so health can say which plane went dark.
        self.endpoint_at: Dict[str, float] = {}
        self.endpoint_err: Dict[str, str] = {}
        # delta-scrape cursors: path -> last next_since (or
        # max useq for /audit) this aggregator has ingested from this
        # peer incarnation
        self.since: Dict[str, int] = {}


class TelemetryAggregator:
    """Scrapes every worker's telemetry endpoint, keeps the merged
    cluster snapshot, publishes straggler signals."""

    def __init__(
        self,
        interval: Optional[float] = None,
        timeout: float = 2.0,
        registry: Optional[metrics.Registry] = None,
        scorer: Optional[StragglerScorer] = None,
        rtt_scorer: Optional[StragglerScorer] = None,
        fetch: Optional[Callable[[str, str, float], Tuple[bytes, dict]]] = None,
    ):
        self.interval = interval if interval is not None else scrape_interval()
        self.timeout = timeout
        # injectable transport: fetch(base_url, path, timeout)
        # -> (body_bytes, headers_dict). The k=256 harness swaps in an
        # in-process hook (256 real HTTP servers per test is a fork
        # bomb); production uses urllib. RTT/clock/payload accounting
        # stays in _fetch either way.
        self._transport = fetch
        self._peers: Dict[str, PeerState] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.scorer = scorer or StragglerScorer()
        # RTT outliers: interconnect trouble shows up before step times
        # do; a laxer z with a hard ratio floor suits the heavier tail
        self.rtt_scorer = rtt_scorer or StragglerScorer(
            window=8, z_threshold=3.0, ratio_threshold=2.0
        )
        self._flagged: set = set()
        self._rtt_flagged: set = set()
        # the measured cause behind each currently-flagged straggler
        # (network/compute/unknown), classified once at the flag
        # transition — /cluster/health serves it so `info top` renders
        # the same cause the audit event recorded
        self._causes: Dict[str, str] = {}
        self._scraped_at: Optional[float] = None  # wall time of last sweep
        # crash forensics: postmortems harvested by the
        # watcher, served at /cluster/postmortem. Deliberately NOT keyed
        # off the scrape membership — dead peers leave the cluster, and
        # their postmortems are the entire point. Bounded overall.
        self._postmortems: "collections.deque" = collections.deque(maxlen=64)
        # a PRIVATE registry by default, not the process-global one: the
        # runner's own transport metrics carry peer labels that mean "a
        # remote peer of the runner" — mixing them into the federated
        # page (where peer means "the scraped worker") would make the
        # label ambiguous. /cluster/metrics appends this exposition.
        reg = registry if registry is not None else metrics.Registry()
        self.registry = reg
        self._g_step_rate = reg.gauge(
            "kungfu_cluster_step_rate",
            "Steps/sec per peer, from scrape-to-scrape deltas",
            ("peer",),
        )
        self._g_step_time = reg.gauge(
            "kungfu_cluster_step_time_seconds",
            "Windowed step-time quantiles per peer",
            ("peer", "quantile"),
        )
        self._g_score = reg.gauge(
            "kungfu_cluster_straggler_score",
            "Robust z-score of each peer's step time vs the cluster median",
            ("peer",),
        )
        self._g_stragglers = reg.gauge(
            "kungfu_cluster_stragglers",
            "Number of peers currently flagged as stragglers",
        )
        self._g_age = reg.gauge(
            "kungfu_cluster_scrape_age_seconds",
            "Seconds since the last successful scrape per peer",
            ("peer",),
        )
        self._c_scrapes = reg.counter(
            "kungfu_cluster_scrapes_total",
            "Aggregator scrape sweeps completed",
        )
        self._c_errors = reg.counter(
            "kungfu_cluster_scrape_errors_total",
            "Failed peer scrapes",
            ("peer",),
        )
        # aggregator self-observability: the telemetry plane
        # watches itself — at k=256 the aggregator is the next
        # bottleneck, and "the monitoring is down" must be a measured
        # fact, not a dashboard gap
        self._g_sweep_s = reg.gauge(
            "kungfu_aggregator_sweep_seconds",
            "Wall-clock duration of the last scrape sweep",
        )
        self._g_scraped = reg.gauge(
            "kungfu_aggregator_scraped_peers",
            "Peers successfully scraped in the last sweep",
        )
        self._g_stale = reg.gauge(
            "kungfu_aggregator_stale_peers",
            "Peers whose last successful scrape is older than twice the "
            "effective interval",
        )
        self._c_payload = reg.counter(
            "kungfu_aggregator_payload_bytes_total",
            "Bytes fetched from workers, by endpoint",
            ("endpoint",),
        )
        self._c_deadline = reg.counter(
            "kungfu_aggregator_deadline_misses_total",
            "Peer scrapes still in flight when their sweep deadline "
            "passed",
        )
        # step plane: merged per-step critical-path records,
        # refreshed from every worker's /steptrace on each sweep
        self._steps: "collections.deque" = collections.deque(maxlen=STEP_KEEP)
        self._steps_last: Optional[Tuple[int, int]] = None  # newest (e, r)
        self._crit_streak: Tuple[Optional[Tuple[str, str]], int] = (None, 0)
        # delta mode only: flushed-but-unpublished timelines
        # per peer — a ?since= scrape ships each timeline once, but the
        # merge holds the globally-newest round back, so held-back
        # deltas must pool here until a newer round releases them
        self._steps_pending: Dict[str, Dict[Tuple[int, int], dict]] = {}
        # decision plane: every worker's /decisions ledger
        # merged into one causal timeline, keyed (peer, seq, open wall
        # time) so a later scrape of the SAME record (now closed, or
        # regressed) updates it in place instead of duplicating it —
        # while a RESPAWNED worker's fresh ledger (seq restarting at 0
        # on the same label) cannot overwrite the dead incarnation's
        # records: its records carry new open stamps. Bounded like a
        # ring: oldest merged entries drop past KF_DECISION_KEEP.
        self._decisions: Dict[Tuple[str, int, float], dict] = {}
        _dkeep = int(knobs.get("KF_DECISION_KEEP"))
        self._decisions_keep = _dkeep if _dkeep > 0 else 64
        # resource plane: the latest merged cluster view of every
        # worker's /resources document — a CURRENT-STATE view (like
        # health), so each refresh REPLACES it wholesale: a dead peer's
        # frozen saturation flag steering straggler causes hours later
        # would be worse than no data
        self._resources: dict = {}
        # memory plane: the same current-state contract
        self._memory: dict = {}
        # one refresh unit per merged plane: each
        # used to carry its own refresh lock + monotonic stamp + inline
        # staleness block; _RefreshedPlane is that block, once. The
        # plane names keep the historical log strings ("inline step
        # refresh failed").
        eff = self.effective_interval
        self._planes: Dict[str, _RefreshedPlane] = {
            "steps": _RefreshedPlane(
                "step", self._refresh_steps_locked, eff),
            "decisions": _RefreshedPlane(
                "decision", self._refresh_decisions_locked, eff),
            "resources": _RefreshedPlane(
                "resource", self._refresh_resources_locked, eff),
            "memory": _RefreshedPlane(
                "memory", self._refresh_memory_locked, eff),
        }
        # scale mode: flat below KF_AGG_HIER_MIN_PEERS
        # (exact historical behavior), hierarchical/sampled/delta above
        self._scale = False
        self._hier_active = False
        self._last_sweep_s: Optional[float] = None
        self._sweep_mono: Optional[float] = None
        self._backoff = 1.0  # interval multiplier while the plane is hot
        # sampled link matrix (scale mode): src -> (row, monotonic_at,
        # wall_at); only the rotation slice + the retained slowest-edge
        # rows re-ingest per sweep, so merge cost is O(k), not O(k^2)
        self._link_cache: Dict[str, Tuple[dict, float, float]] = {}
        self._link_sweep = 0
        self._ingested_links: List[str] = []  # srcs refreshed this sweep
        self._slow_edges: List[dict] = []  # retained slowest edges
        # host digests (hier mode): plane path -> {label: doc} pulled
        # via the heads' /host/telemetry this sweep, consumed by the
        # plane refreshes in place of direct per-worker fetches
        self._digest_planes: Dict[str, Dict[str, dict]] = {}
        self._digest_at: Optional[float] = None
        # delta-audit cache (scale mode): (peer, kind, seq) -> record;
        # ?since= scrapes ship only new/annotated records, so the
        # merged view must accumulate (bounded below)
        self._audit_cache: Dict[Tuple, dict] = {}
        self._audit_cache_keep = 4096

        # the aggregator's own tracked state is a long-lived buffer owner
        # too: account it under its process's `telemetry` bucket, weakly
        self._mem_acct = tmemory.register_owner("aggregator", "telemetry", self,
                                                lambda agg: agg.footprint_bytes())
        self._g_step_overlap = reg.gauge(
            "kungfu_step_overlap_ratio",
            "Latest merged step's overlap fraction: scheduler-busy comm "
            "time hidden under caller compute / total comm time",
        )
        self._g_step_critical = reg.gauge(
            "kungfu_step_critical_seconds",
            "Latest merged step's critical-path blocking seconds, "
            "labelled with the elected (peer, edge)",
            ("peer", "edge"),
        )

    # -- membership ----------------------------------------------------
    @staticmethod
    def targets_for_workers(workers) -> List[Tuple[str, str]]:
        """PeerIDs -> (label, telemetry base URL) on peer_port+10000."""
        out = []
        for w in workers:
            port = w.port + 10000
            if port > 65535:
                # mirror of the worker-side OverflowError guard in
                # peer.py — but say so: an invisible peer can never be
                # flagged, and a silent skip reads as a healthy cluster
                log.warn(
                    "cluster: %s has no telemetry port (peer_port+10000 "
                    "> 65535); excluded from the cluster plane", w,
                )
                continue
            out.append((str(w), f"http://{w.host}:{port}"))
        return out

    def set_peers(self, targets: Sequence[Tuple[str, str]]) -> None:
        """Replace the scrape set (the watcher calls this on every
        Stage). Surviving peers keep their scrape history and clock
        offsets; departed peers drop out of the scorers so they can't
        skew the population as ghosts."""
        with self._lock:
            fresh: Dict[str, PeerState] = {}
            for label, url in targets:
                st = self._peers.get(label)
                if st is None or st.url != url.rstrip("/"):
                    st = PeerState(label, url)
                fresh[label] = st
            self._peers = fresh
            # scale-mode caches follow the membership: a departed
            # peer's sampled row or pooled timelines must not survive
            # it (its audit history MAY — that log is the point)
            for cache in (self._link_cache, self._steps_pending):
                for label in list(cache):
                    if label not in fresh:
                        del cache[label]
            self._slow_edges = [
                e for e in self._slow_edges if e["src"] in fresh
            ]
        live = list(fresh)
        self.scorer.forget(live)
        self.rtt_scorer.forget(live)
        self._flagged &= set(live)
        self._rtt_flagged &= set(live)
        # per-peer gauge children follow the membership (bounded
        # cardinality across elastic resizes)
        for g in (self._g_step_rate, self._g_step_time, self._g_score,
                  self._g_age):
            g.clear_children()

    def peers(self) -> List[PeerState]:
        with self._lock:
            return list(self._peers.values())

    # -- scale mode ----------------------------------------------------
    def effective_interval(self) -> float:
        """The interval the plane is actually running at: the
        configured interval times the overload backoff multiplier."""
        return self.interval * self._backoff

    def _scale_mode(self, k: int) -> bool:
        thresh = hier_min_peers()
        return thresh > 0 and k >= thresh

    def _delta_enabled(self) -> bool:
        """Whether ring-backed endpoints scrape with ?since= cursors:
        KF_AGG_DELTA on/off forces it, auto (the default) follows
        scale mode — below the threshold the flat plane stays
        byte-identical to its historical behavior."""
        mode = str(knobs.get("KF_AGG_DELTA"))
        if mode == "on":
            return True
        if mode == "off":
            return False
        return self._scale

    # -- scraping ------------------------------------------------------
    def _fetch(
        self, st: PeerState, path: str, record_rtt: bool = True
    ) -> Tuple[bytes, dict]:
        """GET one peer endpoint. record_rtt=False for the on-demand
        trace/audit pulls: their multi-MB bodies measure transfer time,
        not the network — writing that into rtt_s would paint a phantom
        'network problem' in /cluster/health whenever someone looks at
        traces (the clock-offset update stays safe either way: it only
        accepts estimates that BEAT the best RTT seen)."""
        endpoint = path.split("?", 1)[0]
        t0 = time.perf_counter()
        try:
            if self._transport is not None:
                body, headers = self._transport(st.url, path, self.timeout)
                clock = headers.get(CLOCK_HEADER)
            else:
                with urllib.request.urlopen(
                    st.url + path, timeout=self.timeout
                ) as r:
                    body = r.read()
                    clock = r.headers.get(CLOCK_HEADER)
        except (OSError, ValueError) as e:
            st.endpoint_err[endpoint] = str(e)
            raise
        t1 = time.perf_counter()
        rtt = t1 - t0
        if record_rtt:
            st.rtt_s = rtt
        _note_clock(st, rtt, clock, t0, t1)
        st.endpoint_at[endpoint] = time.monotonic()
        st.endpoint_err.pop(endpoint, None)
        self._c_payload.labels(endpoint).inc(len(body))
        return body, {"rtt_s": rtt}

    def _mark_scrape_failed(self, st: PeerState, err) -> None:
        """Null a peer's derived state on scrape failure. A peer that
        stopped answering must not keep serving its last-known-healthy
        numbers: a dashboard or policy reading step_rate would see a
        live peer hours after it died. The delta baselines reset too,
        so a comeback doesn't compute a rate smeared across the outage
        — and its SCORER series goes with it: a frozen window would
        keep the peer flagged (or keep skewing the population) off
        hours-old data, and straggler_cleared would never fire. The
        window rebuilds within min_samples scrapes if the endpoint
        comes back."""
        st.last_error = str(err)
        st.errors += 1
        self._c_errors.labels(st.label).inc()
        st.step_rate = st.step_p50 = st.step_p99 = None
        st.compute_mean = None
        st.prev_steps = st.prev_t = None
        st.prev_hist = None
        st.prev_coll_sum = None
        # the CUMULATIVE snapshots go too, not just the prev_*
        # baselines: the success path copies current into prev_*
        # before overwriting, so a surviving pre-outage snapshot
        # would become the baseline for a possibly-restarted worker
        # — cross-epoch deltas (negative buckets, garbage quantiles)
        # once the new epoch's counts pass the old ones
        st.steps_total = None
        st.step_hist = None
        st.coll_sum = None
        # the frozen exposition page goes too: cluster_metrics()
        # federates whatever is stored, and a dead peer's last page
        # would keep it looking alive on the Prometheus view
        st.metrics_text = ""
        # and its link row: a dead peer's frozen bandwidth estimates
        # would keep steering topology re-planning hours later
        st.links = {}
        st.ring_pos = st.ring_next = st.ring_role = None
        st.wire_mode = None
        # scale mode: the sampled-matrix cache row too, for the same
        # reason (and a dead incarnation's delta cursors are garbage
        # to the respawn's restarted seq spaces)
        with self._lock:
            self._link_cache.pop(st.label, None)
        st.since.clear()
        self.scorer.drop(st.label)
        self.rtt_scorer.drop(st.label)

    def _apply_parsed(self, st: PeerState, parsed: dict, now: float) -> None:
        """Fold one parsed /metrics page (parse_worker_page output —
        local or shipped pre-parsed in a host digest) into the peer's
        derived state: scrape-to-scrape rates, windowed quantiles and
        the straggler scorers."""
        st.prev_steps, st.prev_hist = st.steps_total, st.step_hist
        st.prev_coll_sum = st.coll_sum
        st.steps_total = parsed.get("steps_total")
        st.step_hist = parsed.get("step_hist")
        st.links = parsed.get("links") or {}
        st.ring_pos = parsed.get("ring_pos")
        st.ring_next = parsed.get("ring_next")
        st.ring_role = parsed.get("ring_role")
        st.wire_mode = parsed.get("wire_mode")
        st.coll_sum = parsed.get("coll_sum")
        st.bytes_tx, st.bytes_rx = parsed.get("bytes_tx"), parsed.get("bytes_rx")
        st.reported_rtt = parsed.get("reported_rtt")
        # step rate + windowed quantiles from scrape-to-scrape deltas
        if (
            st.steps_total is not None
            and st.prev_steps is not None
            and st.prev_t is not None
            and now > st.prev_t
            and st.steps_total >= st.prev_steps  # restart resets to 0
        ):
            st.step_rate = (st.steps_total - st.prev_steps) / (now - st.prev_t)
        st.prev_t = now
        if st.step_hist is not None:
            window = st.step_hist.delta(st.prev_hist)
            if window.count > 0:
                st.step_p50 = window.quantile(0.50)
                st.step_p99 = window.quantile(0.99)
                step_mean = window.sum / window.count
                # score COMPUTE time (step minus collective wait) when
                # the worker publishes collective latencies: under
                # synchronous training wall-clock step times converge to
                # the slowest peer's, and the straggler is the one whose
                # time went to compute instead of waiting
                compute = step_mean
                if (
                    st.coll_sum is not None
                    and st.prev_coll_sum is not None
                    and st.coll_sum >= st.prev_coll_sum  # restart guard
                ):
                    wait = (st.coll_sum - st.prev_coll_sum) / window.count
                    compute = max(step_mean - wait, 0.0)
                st.compute_mean = compute
                self.scorer.observe(st.label, compute)
        # outlier scoring uses ONLY the worker-published probe RTTs
        # (kungfu_peer_rtt_seconds): the HTTP scrape duration measures
        # TCP setup + body transfer, an order of magnitude above a probe
        # RTT — mixing the two in one population would flag any peer
        # that simply hasn't probed yet. The scrape RTT stays visible in
        # health as rtt_ms, it just doesn't vote.
        if st.reported_rtt is not None:
            self.rtt_scorer.observe(st.label, st.reported_rtt)

    def _scrape_peer(self, st: PeerState) -> None:
        now = time.monotonic()
        try:
            body, _ = self._fetch(st, "/metrics")
        except (OSError, ValueError) as e:
            self._mark_scrape_failed(st, e)
            return
        st.scrapes += 1
        st.last_ok = now
        st.last_error = ""
        st.metrics_text = body.decode(errors="replace")
        self._apply_parsed(st, parse_worker_page(st.metrics_text), now)

    # -- hierarchical fan-in ------------------------
    @staticmethod
    def _host_groups(
        targets: Sequence[PeerState],
    ) -> Optional[Dict[str, List[PeerState]]]:
        """Group scrape targets by URL hostname — the same host grouping
        targets_for_workers encodes. None when any URL fails to parse
        (fall back to the flat sweep rather than sweep half a cluster
        hierarchically)."""
        groups: Dict[str, List[PeerState]] = {}
        for st in targets:
            host = urlsplit(st.url).hostname
            if not host:
                return None
            groups.setdefault(host, []).append(st)
        return groups

    def _sweep_host(
        self, sts: List[PeerState],
        digest_planes: Dict[str, Dict[str, dict]],
    ) -> None:
        """Sweep one host through its elected head's /host/telemetry
        digest: one fetch replaces len(sts) x len(planes) direct
        fetches, with the head's pre-parsed summaries saving the root
        the pure-Python exposition parse. Election is deterministic on
        both sides (lowest label on the host), so no coordination
        round: a head that isn't serving the role yet (or died) answers
        {"enabled": false} / an error, and the whole host falls back to
        direct scrapes this sweep."""
        head = min(sts, key=lambda s: s.label)
        doc = None
        if len(sts) > 1:
            try:
                body, _ = self._fetch(head, HOST_DIGEST_PATH)
                doc = json.loads(body.decode())
            except (OSError, ValueError):
                doc = None
        if not isinstance(doc, dict) or not doc.get("enabled") \
                or not isinstance(doc.get("workers"), dict):
            for st in sts:
                self._scrape_peer(st)
            return
        now = time.monotonic()
        head_off = head.clock_offset_us or 0.0
        workers = doc["workers"]
        by_label = {st.label: st for st in sts}
        for label, st in by_label.items():
            w = workers.get(label)
            if not isinstance(w, dict):
                # the head doesn't know this worker (membership skew
                # between root and head): scrape it directly rather
                # than black-hole it for a sweep
                self._scrape_peer(st)
                continue
            err = w.get("error")
            if err:
                self._mark_scrape_failed(st, err)
                continue
            st.scrapes += 1
            st.last_ok = now
            st.last_error = ""
            # two-hop NTP composition: offset(root->worker) =
            # offset(root->head) + offset(head->worker); each hop's
            # error is bounded by its RTT/2, so the composed error is
            # bounded by the SUM of the hop bounds
            off_hw = w.get("clock_offset_us")
            if isinstance(off_hw, (int, float)):
                st.clock_offset_us = head_off + off_hw
            rtt = w.get("rtt_s")
            if isinstance(rtt, (int, float)):
                st.rtt_s = rtt
            st.metrics_text = w.get("metrics_text") or ""
            if st.metrics_text:
                st.endpoint_at["/metrics"] = now
            self._apply_parsed(
                st, parsed_from_doc(w.get("parsed") or {}), now
            )
            for path, key in PLANE_PATHS:
                pd = w.get(key)
                if isinstance(pd, dict):
                    digest_planes[path][label] = pd
                    st.endpoint_at[path] = now
                    st.endpoint_err.pop(path, None)
                else:
                    st.endpoint_err[path] = "missing from host digest"

    def _run_staggered(self, jobs: List[Tuple[str, Callable[[], None]]]) -> int:
        """Run scrape jobs in parallel with staggered per-job deadlines
        spread across the sweep budget: every job still gets
        at least the HTTP timeout, but the join points are spaced so
        one slow peer can't absorb the whole budget before the others
        are even checked. Returns the number of deadline misses (jobs
        still in flight when their deadline passed — the threads are
        daemons and finish on their own; the miss is counted and the
        peer reads as stale until it lands)."""
        budget = self.timeout + 1.0
        if self._scale and self.interval > 0:
            # scale mode budgets the sweep against the scrape interval:
            # at k=256 one unreachable host must not stall the plane
            # past its own cadence
            budget = min(budget, max(self.interval, 0.5))
        t0 = time.monotonic()
        threads = [
            threading.Thread(target=fn, name=f"kf-scrape-{label}",
                             daemon=True)
            for label, fn in jobs
        ]
        if not threads:
            return 0
        for t in threads:
            t.start()
        misses = 0
        n = len(threads)
        for i, t in enumerate(threads):
            deadline = t0 + budget * (i + 1) / n
            t.join(max(0.0, deadline - time.monotonic()))
        # one final grace pass at the full budget: the stagger bounds
        # the SWEEP, not any single fetch
        final = t0 + budget
        for t in threads:
            t.join(max(0.0, final - time.monotonic()))
            if t.is_alive():
                misses += 1
                self._c_deadline.inc()
        return misses

    def scrape_once(self) -> dict:
        """One sweep over every target (parallel, bounded by the HTTP
        timeout), then re-score stragglers and publish. Returns the
        fresh health snapshot. A peer whose previous scrape thread is
        still in flight (a server dripping bytes under the timeout) is
        skipped this sweep — two threads swapping the same peer's
        prev/current baselines would corrupt its rates.

        Scale mode (at or above KF_AGG_HIER_MIN_PEERS
        targets): hosts with an elected head are swept via ONE
        /host/telemetry digest each (O(hosts) fan-in, offsets composed
        across the two hops), the link matrix ingests only the rotation
        slice plus the retained slowest edges, and the sweep is
        budgeted against the scrape interval with the loop backing off
        when it runs hot. Below the threshold the flat sweep is the
        exact historical behavior."""
        t_start = time.perf_counter()
        targets = self.peers()
        self._scale = self._scale_mode(len(targets))
        groups = self._host_groups(targets) if self._scale else None
        hier = groups is not None and any(
            len(g) > 1 for g in groups.values()
        )

        def scrape_and_clear(st: PeerState) -> None:
            try:
                self._scrape_peer(st)
            finally:
                st.inflight = False

        jobs: List[Tuple[str, Callable[[], None]]] = []
        if hier:
            digest_planes: Dict[str, Dict[str, dict]] = {
                path: {} for path, _ in PLANE_PATHS
            }
            for host in sorted(groups):
                sts = [st for st in groups[host] if not st.inflight]
                if not sts:
                    continue
                for st in sts:
                    st.inflight = True

                def sweep_host(sts=sts):
                    try:
                        self._sweep_host(sts, digest_planes)
                    finally:
                        for st in sts:
                            st.inflight = False

                jobs.append((host, sweep_host))
        else:
            for st in targets:
                if st.inflight:
                    continue
                st.inflight = True
                jobs.append(
                    (st.label,
                     lambda st=st: scrape_and_clear(st))
                )
        misses = self._run_staggered(jobs)
        if hier:
            with self._lock:
                self._digest_planes = digest_planes
                self._digest_at = time.monotonic()
        self._hier_active = hier
        self._c_scrapes.inc()
        self._scraped_at = time.time()
        if self._scale:
            self._ingest_links_sampled(targets)
        for plane in self._planes.values():
            try:
                plane.refresh()
            except Exception as e:  # noqa: BLE001 - the sweep must outlive a bad merge
                log.warn(
                    "cluster: %s-plane refresh failed: %s", plane.name, e
                )
        self._publish()
        sweep_s = time.perf_counter() - t_start
        self._note_sweep(sweep_s, len(targets), misses)
        return self.cluster_health()

    def _note_sweep(self, sweep_s: float, k: int, misses: int) -> None:
        """Publish the aggregator's self-observability gauges and run
        the overload backoff: a sweep that overruns the interval means
        the plane can't keep up at this cadence — double the effective
        interval (audited, bounded by KF_AGG_MAX_BACKOFF) rather than
        let sweeps pile onto each other; recover by halving once
        sweeps drop under half the interval again."""
        self._last_sweep_s = sweep_s
        self._sweep_mono = time.monotonic()
        stale = self._stale_peers()
        self._g_sweep_s.set(round(sweep_s, 6))
        self._g_scraped.set(k - len(stale))
        self._g_stale.set(len(stale))
        # the backoff loop is a scale-mode behavior: flat test rigs run
        # millisecond intervals where any real sweep would read as an
        # overload, and flat mode's contract is exact historical
        # behavior
        if not self._scale or self.interval <= 0:
            return
        if sweep_s > self.interval or misses > 0 and sweep_s > 0.8 * self.interval:
            try:
                max_backoff = float(knobs.get("KF_AGG_MAX_BACKOFF"))
            except (TypeError, ValueError):
                max_backoff = 8.0
            nb = min(self._backoff * 2.0, max(1.0, max_backoff))
            if nb > self._backoff:
                self._backoff = nb
                audit.record_event(
                    "aggregator_overload",
                    trigger="cluster_scrape",
                    sweep_s=round(sweep_s, 3),
                    interval_s=self.interval,
                    effective_interval_s=round(self.interval * nb, 3),
                    peers=k,
                    deadline_misses=misses,
                )
        elif sweep_s < 0.5 * self.interval and self._backoff > 1.0:
            self._backoff = max(1.0, self._backoff / 2.0)

    def _stale_peers(self) -> List[str]:
        """Labels whose last successful scrape is older than twice the
        effective interval (or that never succeeded)."""
        now = time.monotonic()
        horizon = 2.0 * max(self.effective_interval(), 1e-9)
        return sorted(
            st.label for st in self.peers()
            if st.last_ok is None or now - st.last_ok > horizon
        )

    # -- sampled link matrix ------------------------
    def _ingest_links_sampled(self, targets: Sequence[PeerState]) -> None:
        """Scale-mode link ingest: refresh only a rotating slice of
        source rows per sweep (every row within KF_AGG_LINK_ROTATION_SWEEPS
        sweeps) PLUS the sources of the retained top-N slowest edges —
        the edges steering re-planning can never rotate out of
        freshness. Cache rows carry their ingest stamps, so consumers
        see per-row age instead of mistaking a sampled matrix for a
        fresh one."""
        labels = sorted(st.label for st in targets)
        by_label = {st.label: st for st in targets}
        k = len(labels)
        if k == 0:
            with self._lock:
                self._link_cache.clear()
                self._slow_edges = []
                self._ingested_links = []
            return
        try:
            rot = int(knobs.get("KF_AGG_LINK_ROTATION_SWEEPS"))
        except (TypeError, ValueError):
            rot = 8
        rot = max(1, rot)
        try:
            top_n = int(knobs.get("KF_AGG_LINK_TOP_EDGES"))
        except (TypeError, ValueError):
            top_n = 16
        rows_per = max(1, math.ceil(k / rot))
        start = (self._link_sweep * rows_per) % k
        chosen = {
            labels[(start + i) % k] for i in range(min(rows_per, k))
        }
        chosen |= {
            e["src"] for e in self._slow_edges if e["src"] in by_label
        }
        now_m = time.monotonic()
        now_w = time.time()
        ingested = []
        with self._lock:
            # departed peers' rows go first: a dead source must not
            # keep its frozen row in the election
            for src in list(self._link_cache):
                if src not in by_label:
                    del self._link_cache[src]
            for src in sorted(chosen):
                st = by_label[src]
                if st.links:
                    row = {dst: dict(info) for dst, info in st.links.items()}
                    self._link_cache[src] = (row, now_m, now_w)
                    ingested.append(src)
                elif st.last_error:
                    self._link_cache.pop(src, None)
            self._link_sweep += 1
            self._ingested_links = ingested
            # re-elect the retained slowest edges over the whole cache:
            # O(cached edges) = O(k x row), done once per sweep
            cand = []
            for src, (row, at, _) in self._link_cache.items():
                for dst, info in row.items():
                    bw = info.get("bw")
                    if isinstance(bw, (int, float)) and bw > 0:
                        cand.append(
                            {"src": src, "dst": dst, "bw": bw,
                             "at": at}
                        )
            cand.sort(key=lambda e: e["bw"])
            self._slow_edges = cand[:max(0, top_n)]

    def _link_cache_view(self) -> Tuple[Dict[str, dict], Dict[str, float]]:
        """(rows, per-row age seconds) snapshot of the sampled cache."""
        now_m = time.monotonic()
        with self._lock:
            rows = {src: row for src, (row, _, _) in self._link_cache.items()}
            ages = {
                src: round(now_m - at, 3)
                for src, (_, at, _) in self._link_cache.items()
            }
        return rows, ages

    def _publish(self) -> None:
        scores = self.scorer.scores()
        rtt_scores = self.rtt_scorer.scores()
        flagged = {p for p, s in scores.items() if s.flagged}
        rtt_flagged = {p for p, s in rtt_scores.items() if s.flagged}
        cluster_median = self.scorer.cluster_median()
        # rebuild the per-peer gauge children every sweep: set() without
        # a clear would leave a dead peer's last-known-healthy values
        # frozen in the exposition forever (the JSON view nulls them,
        # and the metrics view must agree)
        for g in (self._g_step_rate, self._g_step_time, self._g_score):
            g.clear_children()
        for st in self.peers():
            if st.step_rate is not None:
                self._g_step_rate.labels(st.label).set(st.step_rate)
            if st.step_p50 is not None:
                self._g_step_time.labels(st.label, "0.5").set(st.step_p50)
            if st.step_p99 is not None:
                self._g_step_time.labels(st.label, "0.99").set(st.step_p99)
            sc = scores.get(st.label)
            if sc is not None:
                self._g_score.labels(st.label).set(sc.score)
            if st.last_ok is not None:
                self._g_age.labels(st.label).set(
                    time.monotonic() - st.last_ok
                )
        self._g_stragglers.set(len(flagged))
        # audit on TRANSITIONS only: the log answers "when did peer X
        # become slow", not "is it still slow every 5 seconds"
        newly_flagged = sorted(flagged - self._flagged)
        links_doc = None
        steps: List[dict] = []
        resources: Optional[dict] = None
        memory: Optional[dict] = None
        if newly_flagged:
            # measured attribution for the event: the step plane's
            # elected edge when this peer was recently critical, else
            # the memory plane's thrash flag, the resource plane's
            # saturation view, else the slowest link touching it — all
            # inputs computed once per transition batch, never per peer
            links_doc = tlink.merge_matrix(
                {st.label: st.links for st in self.peers()},
                copy_edges=False,
            )
            with self._lock:
                steps = list(self._steps)
                resources = self._resources or None
                memory = self._memory or None
        for peer in newly_flagged:
            sc = scores[peer]
            cause, edge = tstraggler.classify_cause(peer, steps, links_doc, resources, memory)
            self._causes[peer] = cause
            log.warn(
                "cluster: straggler detected: %s step_time=%.1fms "
                "(cluster median %.1fms, z=%.1f, cause=%s, blocking edge %s)",
                peer, sc.value * 1e3, (cluster_median or 0) * 1e3, sc.score,
                cause,
                "->".join(str(e) for e in edge) if edge else "unknown",
            )
            audit.record_event(
                "straggler",
                peer=peer,
                trigger="cluster_scrape",
                score=round(sc.score, 2),
                step_time_ms=round(sc.value * 1e3, 3),
                cluster_median_ms=round((cluster_median or 0) * 1e3, 3),
                blocking_edge=edge,
                cause=cause,
            )
        for peer in sorted(self._flagged - flagged):
            self._causes.pop(peer, None)
            audit.record_event(
                "straggler_cleared", peer=peer, trigger="cluster_scrape"
            )
        for peer in sorted(rtt_flagged - self._rtt_flagged):
            sc = rtt_scores[peer]
            audit.record_event(
                "rtt_outlier",
                peer=peer,
                trigger="cluster_scrape",
                score=round(sc.score, 2),
                rtt_ms=round(sc.value * 1e3, 3),
            )
        self._flagged = flagged
        self._rtt_flagged = rtt_flagged

    # -- background loop -----------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            # wait the EFFECTIVE interval: the overload backoff slows
            # the loop down rather than queueing hot sweeps
            while not self._stop.wait(self.effective_interval()):
                try:
                    self.scrape_once()
                except Exception as e:  # noqa: BLE001 - the plane must outlive a bad sweep
                    log.warn("cluster: scrape sweep failed: %s", e)

        self._thread = threading.Thread(
            target=loop, name="kf-cluster-scrape", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(self.timeout + 1.0)
        self._mem_acct.close()

    # -- merged views ---------------------------------------------------
    def cluster_metrics(self) -> str:
        """Federated exposition of every worker's last-scraped /metrics,
        plus the aggregator's own registry (the kungfu_cluster_* gauges
        and scrape counters — already peer-labelled, no injection) so
        one Prometheus target sees the whole plane."""
        pages: List[Tuple[Optional[str], str]] = [
            (st.label, st.metrics_text)
            for st in self.peers()
            if st.metrics_text
        ]
        pages.append((None, self.registry.render()))
        return promparse.merge_expositions(pages)

    def _fetch_all(
        self, path: str, since_key: Optional[str] = None
    ) -> List[Tuple["PeerState", bytes]]:
        """Parallel fetch of one endpoint from every peer (the serial
        version made /cluster/trace block for N x timeout with a few
        unreachable workers — at exactly the moment an operator is
        debugging a sick cluster). Failures record last_error and drop
        out of the result. since_key appends each peer's stored delta
        cursor as ?since= — callers pass it ONLY in delta
        mode, so flat-mode test stubs keep the historical
        one-positional-argument signature."""
        targets = sorted(self.peers(), key=lambda s: s.label)
        results: List[Optional[bytes]] = [None] * len(targets)

        def one(i: int, st: PeerState) -> None:
            p = path
            if since_key is not None:
                cur = st.since.get(since_key)
                if cur is not None:
                    p = f"{path}?since={cur}"
            try:
                body, _ = self._fetch(st, p, record_rtt=False)
                results[i] = body
            except (OSError, ValueError) as e:
                st.last_error = str(e)

        threads = [
            threading.Thread(target=one, args=(i, st), daemon=True)
            for i, st in enumerate(targets)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout + 1.0)
        return [
            (st, body) for st, body in zip(targets, results) if body is not None
        ]

    def cluster_trace(self) -> dict:
        """Live-fetch every worker's /trace and merge onto the runner's
        monotonic timeline: each peer becomes a Chrome-trace process
        (pid = peer index, process_name metadata), and its timestamps
        shift by the estimated clock offset so cross-peer causality
        (e.g. "every peer's allreduce stalls when peer 3 is late") is
        visible in one view."""
        merged: List[dict] = []
        for idx, (st, body) in enumerate(self._fetch_all("/trace")):
            try:
                doc = json.loads(body.decode())
            except ValueError as e:
                st.last_error = str(e)
                continue
            offset = st.clock_offset_us or 0.0
            merged.append({
                "name": "process_name", "ph": "M", "pid": idx, "tid": 0,
                "args": {"name": st.label},
            })
            merged.append({
                "name": "process_sort_index", "ph": "M", "pid": idx,
                "tid": 0, "args": {"sort_index": idx},
            })
            for ev in doc.get("traceEvents", []):
                ev = dict(ev)
                ev["pid"] = idx
                if isinstance(ev.get("ts"), (int, float)):
                    ev["ts"] = ev["ts"] + offset
                merged.append(ev)
        return {"traceEvents": merged, "displayTimeUnit": "ms"}

    def cluster_audit(self) -> List[dict]:
        """Merged audit timeline: every worker's /audit plus the
        runner's own records, sorted by wall time. Delta mode: each pull ships only records created or annotated past the
        per-peer cursor, accumulated in a bounded cache keyed (peer,
        kind, seq) — an annotated record (new useq, same seq) updates
        its cached copy in place."""
        if self._delta_enabled():
            for st, body in self._fetch_all("/audit", since_key="/audit"):
                try:
                    peer_records = json.loads(body.decode())
                except ValueError:
                    continue
                for rec in peer_records:
                    rec = dict(rec)
                    rec.setdefault("peer", st.label)
                    useq = rec.get("useq")
                    if isinstance(useq, (int, float)):
                        st.since["/audit"] = max(
                            st.since.get("/audit", 0), int(useq)
                        )
                    key = (
                        rec.get("peer", ""), rec.get("kind", ""),
                        rec.get("seq"), rec.get("wall_time"),
                    )
                    with self._lock:
                        self._audit_cache[key] = rec
            with self._lock:
                if len(self._audit_cache) > self._audit_cache_keep:
                    ordered = sorted(
                        self._audit_cache.items(),
                        key=lambda kv: kv[1].get("wall_time", 0.0),
                    )
                    for key, _ in ordered[:-self._audit_cache_keep]:
                        del self._audit_cache[key]
                records = list(audit.to_json()) + [
                    dict(r) for r in self._audit_cache.values()
                ]
            records.sort(key=lambda r: r.get("wall_time", 0.0))
            return records
        records = list(audit.to_json())
        for st, body in self._fetch_all("/audit"):
            try:
                peer_records = json.loads(body.decode())
            except ValueError:
                continue
            for rec in peer_records:
                rec = dict(rec)
                rec.setdefault("peer", st.label)
                records.append(rec)
        records.sort(key=lambda r: r.get("wall_time", 0.0))
        return records

    def add_postmortem(self, label: str, pm: dict) -> None:
        """Record a harvested worker postmortem (watcher calls this on
        every worker death it recovers from)."""
        with self._lock:
            self._postmortems.append((str(label), dict(pm)))

    def cluster_postmortem(self) -> dict:
        """The /cluster/postmortem view: every harvested death this
        run, newest last, grouped per peer."""
        with self._lock:
            items = list(self._postmortems)
        peers: Dict[str, List[dict]] = {}
        for label, pm in items:
            peers.setdefault(label, []).append(pm)
        return {
            "wall_time": time.time(),
            "deaths": len(items),
            "peers": peers,
        }

    def cluster_links(self) -> dict:
        """The /cluster/links view: the k×k link matrix assembled from
        every worker's exported row (no extra scrape — rows ride the
        /metrics pages the aggregator already holds), plus the per-peer
        clock offsets already estimated for /cluster/trace so offline
        tooling can align link events without re-deriving them.

        Scale mode: the full k×k document is replaced by a
        SAMPLED one — only the rows ingested this sweep ship as edges
        (payload O(k)/sweep instead of O(k²)), while min_bw and the
        slowest-edge election run over the whole row cache, every row
        carries its age and the retained slowest edges are listed with
        theirs. Consumers that vote on freshness (ReplanPolicy) gate on
        the ages instead of assuming a full fresh matrix."""
        if self._scale:
            return self._cluster_links_sampled()
        doc = tlink.merge_matrix({st.label: st.links for st in self.peers()})
        doc["wall_time"] = self._scraped_at
        doc["clock_offset_us"] = {
            st.label: st.clock_offset_us for st in self.peers()
        }
        # active-ring view: reconstruct the ring order the
        # workers are actually walking from their exported positions;
        # only published when every scraped peer reported a distinct
        # position (mid-re-plan or partially-scraped clusters return
        # null rather than a half-true ring)
        doc["ring"] = self._ring_doc()
        doc["plane"] = self.plane_envelope()
        return doc

    def _ring_doc(self) -> dict:
        """Active-ring reconstruction, shared by the flat and
        sampled links views: published only when every scraped peer
        reported a distinct position."""
        positions = {
            st.label: st.ring_pos for st in self.peers()
            if st.ring_pos is not None
        }
        order = None
        if positions and len(positions) == len(self.peers()):
            by_pos = sorted(positions.items(), key=lambda kv: kv[1])
            if [p for _, p in by_pos] == list(range(len(by_pos))):
                order = [label for label, _ in by_pos]
        return {
            "order": order,
            "position": positions,
            "next": {
                st.label: st.ring_next for st in self.peers()
                if st.ring_next is not None
            },
            # two-level roles: per-peer {level, role, group}
            # — "inter"/"head" marks a host head, "intra"/"demoted" a
            # demoted peer; all-"flat" (or absent) = no hierarchy
            "role": {
                st.label: st.ring_role for st in self.peers()
                if st.ring_role is not None
            },
            # active wire precision: cluster-agreed by the
            # lockstep votes, so these normally all match — a divergence
            # here is a scrape straddling a flip (or a real bug)
            "wire": {
                st.label: st.wire_mode for st in self.peers()
                if st.wire_mode is not None
            },
        }

    def _cluster_links_sampled(self) -> dict:
        """Scale-mode /cluster/links (see cluster_links)."""
        rows, ages = self._link_cache_view()
        with self._lock:
            slow = [dict(e) for e in self._slow_edges]
            ingested = list(self._ingested_links)
        # the ELECTION spans the whole cache (merge_matrix stays the
        # single election authority); only the shipped edges are the
        # sampled slice
        elected = tlink.merge_matrix(rows, copy_edges=False)
        now_m = time.monotonic()
        for e in slow:
            e["age_s"] = round(now_m - e.pop("at"), 3)
        k = len(self.peers())
        doc = {
            "mode": "sampled",
            "peers": sorted(st.label for st in self.peers()),
            # this sweep's rotation slice only — O(k) bytes per sweep
            "edges": {
                src: {dst: dict(info) for dst, info in rows[src].items()}
                for src in ingested if src in rows
            },
            "min_bw": elected["min_bw"],
            "slowest_edge": elected["slowest_edge"],
            "slowest_edges": slow,
            "row_age_s": ages,
            "oldest_row_age_s": max(ages.values()) if ages else None,
            "coverage": round(len(rows) / k, 4) if k else None,
            "wall_time": self._scraped_at,
            "clock_offset_us": {
                st.label: st.clock_offset_us for st in self.peers()
            },
            "ring": self._ring_doc(),
            "plane": self.plane_envelope(),
        }
        return doc

    # -- step plane ------------------------------------------

    # merged step records older than this keep only their election; the
    # newest few retain the per-peer lanes `info steps` renders (full
    # lanes for all STEP_KEEP records would hold k x buckets dicts per
    # step on the runner forever)
    STEP_LANES_KEEP = 8

    def _plane_docs(
        self, path: str
    ) -> Tuple[Dict[str, dict], Dict[str, float]]:
        """Per-worker documents + clock offsets for one merged-plane
        refresh. Flat mode: direct parallel fetch of every worker (the
        historical path, via _fetch_all so tests can stub the
        transport). Hier mode: the sweep already pulled the documents
        through the host digests — consume that set while it's fresh,
        falling back to direct fetches when it isn't (inline refresh
        with no runner loop). Delta mode adds ?since= cursors to the
        direct fetches and advances them off each document's
        next_since."""
        if self._hier_active:
            with self._lock:
                cached = self._digest_planes.get(path)
                at = self._digest_at
                states = dict(self._peers)
            if cached and at is not None and (
                time.monotonic() - at < 2.0 * self.effective_interval()
            ):
                docs = {}
                offsets = {}
                for label, doc in cached.items():
                    st = states.get(label)
                    if st is None:
                        continue
                    docs[label] = doc
                    offsets[label] = st.clock_offset_us or 0.0
                return docs, offsets
        docs = {}
        offsets = {}
        delta = (
            path in ("/steptrace", "/decisions") and self._delta_enabled()
        )
        results = (
            self._fetch_all(path, since_key=path)
            if delta else self._fetch_all(path)
        )
        for st, body in results:
            try:
                doc = json.loads(body.decode())
            except ValueError as e:
                st.last_error = str(e)
                continue
            docs[st.label] = doc
            offsets[st.label] = st.clock_offset_us or 0.0
            if delta and isinstance(doc.get("next_since"), int):
                st.since[path] = doc["next_since"]
        return docs, offsets

    def _refresh_steps(self) -> None:
        """Pull every worker's /steptrace, align timelines with the
        clock offsets already estimated for /cluster/trace, merge into
        per-step critical-path records, publish the gauges and track the
        patience window behind `step_critical_path` audit events. Only
        steps NEWER than the last refresh append (workers keep a ring;
        re-reading it must not replay old steps into the streak), and
        whole refreshes serialize — the sweep thread and an HTTP
        handler's inline refresh racing here would append the same
        fresh steps twice."""
        self._planes["steps"].refresh()

    def _refresh_steps_locked(self) -> None:
        docs, offsets = self._plane_docs("/steptrace")
        # delta/hier scrapes ship each flushed timeline ONCE, but the
        # merge below holds the globally-newest round back — so shipped
        # timelines pool per peer until a newer round releases them.
        # Flat mode never pools: workers re-serve their whole ring, and
        # the pool would only duplicate state.
        delta = self._hier_active or self._delta_enabled()
        if not docs and not (delta and self._steps_pending):
            return
        # merge only FLUSHED timelines (an in-flight round's partial
        # lanes belong to the worker/postmortem views, not a cluster
        # election), and ALWAYS hold the globally-newest flushed round
        # back until a newer one exists: a step merges exactly once, so
        # electing it while some peer is still walking (or unscraped)
        # would freeze a half-flushed critical path into the ring
        # forever (seen live: edge=None, overlap=None). Cost: one
        # step of publication lag, and a fully-quiesced run never
        # publishes its final round — the price of never publishing a
        # partial election.
        for doc in docs.values():
            doc["timelines"] = [
                t for t in doc.get("timelines", [])
                if t.get("t_end_us") is not None
            ]
        if delta:
            with self._lock:
                pool = self._steps_pending
                for label, doc in docs.items():
                    per = pool.setdefault(label, {})
                    for t in doc["timelines"]:
                        key = (int(t.get("epoch", 0)),
                               int(t.get("round", 0)))
                        if (
                            self._steps_last is not None
                            and key <= self._steps_last
                        ):
                            continue
                        per[key] = t
                    # bounded like the worker rings: a peer that stops
                    # flushing must not pool forever
                    if len(per) > STEP_KEEP:
                        for k_ in sorted(per)[:-STEP_KEEP]:
                            del per[k_]
                live = {st.label for st in self._peers.values()}
                for label in list(pool):
                    if label not in live:
                        del pool[label]
                docs = {
                    label: {"timelines": list(per.values())}
                    for label, per in pool.items() if per
                }
                # offsets for ALL pooled peers, not just this round's
                # respondents: a pooled timeline from a peer that
                # failed this fetch still aligns with its last-known
                # offset
                offsets = {
                    st.label: st.clock_offset_us or 0.0
                    for st in self._peers.values()
                }
            if not docs:
                return
        keys = {
            (int(t.get("epoch", 0)), int(t.get("round", 0)))
            for doc in docs.values()
            for t in doc["timelines"]
        }
        merged = tstep.merge_steps(docs, offsets)
        if keys:
            newest = max(keys)
            merged = [
                s for s in merged if (s["epoch"], s["round"]) < newest
            ]
        fresh = [
            s for s in merged
            if self._steps_last is None
            or (s["epoch"], s["round"]) > self._steps_last
        ]
        if not fresh:
            return
        with self._lock:
            for s in fresh:
                rec = dict(s)
                rec["peer_count"] = len(s.get("peers", {}))
                self._steps.append(rec)
            # beyond the lane window, keep only the election (the full
            # lanes are bulky and already served by the workers)
            for old in list(self._steps)[:-self.STEP_LANES_KEEP]:
                old.pop("peers", None)
            self._steps_last = (fresh[-1]["epoch"], fresh[-1]["round"])
            # delta pool: published rounds are merged for good — only
            # the held-back tail stays pooled
            for per in self._steps_pending.values():
                for k_ in [k for k in per if k <= self._steps_last]:
                    del per[k_]
        latest = fresh[-1]
        if latest.get("overlap_frac") is not None:
            self._g_step_overlap.set(latest["overlap_frac"])
        crit = latest.get("critical")
        self._g_step_critical.clear_children()
        if crit:
            self._g_step_critical.labels(
                str(crit.get("peer")), str(crit.get("edge") or "?")
            ).set((crit.get("self_us") or 0.0) / 1e6)
        # patience window: the SAME (peer, edge) dominating consecutive
        # merged steps is a standing bottleneck, not weather — audit it
        # once per streak, at the moment patience fills
        for s in fresh:
            c = s.get("critical")
            key = (
                (str(c.get("peer")), str(c.get("edge") or ""))
                if c else None
            )
            streak_key, count = self._crit_streak
            count = count + 1 if key is not None and key == streak_key else 1
            self._crit_streak = (key, count)
            if key is not None and count == STEP_CRIT_PATIENCE:
                audit.record_event(
                    "step_critical_path",
                    peer=key[0],
                    edge=key[1] or None,
                    bucket=c.get("bucket"),
                    trigger="step_merge",
                    blocking_ms=round((c.get("self_us") or 0.0) / 1e3, 3),
                    steps=STEP_CRIT_PATIENCE,
                    epoch=s["epoch"],
                    round=s["round"],
                )

    def cluster_steps(self) -> dict:
        """The /cluster/steps view: recent merged per-step critical-path
        records, newest last — the newest STEP_LANES_KEEP still carry
        their per-peer lanes (the `info steps` rendering), older ones
        only the election. Refreshes inline when the cached merge is
        older than a scrape interval, so one-shot consumers (`info
        steps` without a runner loop) still see fresh steps."""
        self._planes["steps"].ensure_fresh()
        with self._lock:
            # shallow copies: a later refresh pops "peers" off aged
            # records in place, and serialization must not iterate a
            # dict mid-mutation
            steps = [dict(s) for s in self._steps]
        return {
            "wall_time": time.time(),
            "count": len(steps),
            "patience": STEP_CRIT_PATIENCE,
            "steps": steps,
            "plane": self.plane_envelope(),
        }

    # -- decision plane --------------------------------------

    def _refresh_decisions(self) -> None:
        """Pull every worker's /decisions ledger, align the perf stamps
        with the clock offsets already estimated for /cluster/trace and
        merge keyed (peer, seq, open wall time): re-scraping an
        unchanged ledger is idempotent, a record that closed (or
        regressed) since the last sweep UPDATES its merged copy in
        place, and a respawned worker's restarted seq space cannot
        collide with its dead incarnation's records. Whole refreshes
        serialize like the step plane's. Delta scrapes (?since=) compose
        naturally with the keyed merge: an unshipped-because-unchanged
        record simply keeps its merged copy."""
        self._planes["decisions"].refresh()

    def _refresh_decisions_locked(self) -> None:
        docs, offsets = self._plane_docs("/decisions")
        if not docs:
            return
        merged = tdecisions.merge_decisions(docs, offsets)
        with self._lock:
            for rec in merged:
                self._decisions[(
                    rec.get("peer", ""),
                    int(rec.get("seq", 0)),
                    float(rec.get("wall_time") or 0.0),
                )] = rec
            if len(self._decisions) > self._decisions_keep:
                ordered = sorted(
                    self._decisions.items(),
                    key=lambda kv: kv[1].get("t_us") or 0.0,
                )
                for key, _ in ordered[:-self._decisions_keep]:
                    del self._decisions[key]

    def cluster_decisions(self) -> dict:
        """The /cluster/decisions view: the merged causal adaptation
        timeline, oldest first. Refreshes inline when the cached merge
        is older than a scrape interval, so one-shot consumers (`info
        decisions` without a runner loop) still see fresh outcomes."""
        self._planes["decisions"].ensure_fresh()
        with self._lock:
            recs = sorted(
                self._decisions.values(),
                key=lambda r: r.get("t_us") or r.get("wall_time") or 0.0,
            )
        return {
            "wall_time": time.time(),
            "count": len(recs),
            "open": sum(1 for r in recs if r.get("status") != "closed"),
            "regressed": sum(1 for r in recs if r.get("regressed")),
            "decisions": recs,
            "plane": self.plane_envelope(),
        }

    def _steps_summary(self) -> Optional[dict]:
        """Compact step signal for /cluster/health (the full records
        stay on /cluster/steps): the latest step's election plus each
        peer's share of recent steps it was critical in."""
        with self._lock:
            steps = list(self._steps)
        if not steps:
            return None
        latest = steps[-1]
        crit_counts: Dict[str, int] = {}
        crit_edges: Dict[str, str] = {}
        for s in steps:
            c = s.get("critical")
            if not c or c.get("peer") is None:
                continue
            peer = str(c["peer"])
            crit_counts[peer] = crit_counts.get(peer, 0) + 1
            if c.get("edge"):
                crit_edges[peer] = str(c["edge"])
        n = len(steps)
        crit = latest.get("critical") or {}
        return {
            "steps": n,
            "critical_peer": crit.get("peer"),
            "critical_edge": crit.get("edge"),
            "critical_ms": (
                round((crit.get("self_us") or 0.0) / 1e3, 3)
                if crit else None
            ),
            "overlap_frac": latest.get("overlap_frac"),
            "queue_delay_frac": latest.get("queue_delay_frac"),
            "crit_frac": {
                p: round(c / n, 3) for p, c in sorted(crit_counts.items())
            },
            "crit_edge": crit_edges,
        }

    def _links_summary(self) -> dict:
        """Compact link signal for /cluster/health (the full matrix
        stays on /cluster/links): the slowest measured edge and how many
        edges have estimates at all. The election itself lives in ONE
        place — tlink.merge_matrix — so this summary can never disagree
        with /cluster/links about which edge is slowest. copy_edges=False:
        this runs on every /cluster/health request (polled by every
        worker), and a k=64 matrix is ~4k edge dicts we would copy only
        to throw away. Scale mode summarizes the SAMPLED cache instead
        and reports its coverage and oldest row age, so freshness-gated
        consumers (ReplanPolicy) can refuse to vote on stale rows."""
        if self._scale:
            rows, ages = self._link_cache_view()
            doc = tlink.merge_matrix(rows, copy_edges=False)
            edges = sum(
                1
                for row in doc["edges"].values()
                for info in row.values()
                if isinstance(info.get("bw"), (int, float))
                and info["bw"] > 0
            )
            k = len(self.peers())
            return {
                "min_bw": doc["min_bw"],
                "slowest_edge": doc["slowest_edge"],
                "edges": edges,
                "oldest_row_age_s": (
                    max(ages.values()) if ages else None
                ),
                "coverage": round(len(rows) / k, 4) if k else None,
            }
        doc = tlink.merge_matrix(
            {st.label: st.links for st in self.peers()}, copy_edges=False
        )
        edges = sum(
            1
            for row in doc["edges"].values()
            for info in row.values()
            if isinstance(info.get("bw"), (int, float)) and info["bw"] > 0
        )
        return {
            "min_bw": doc["min_bw"],
            "slowest_edge": doc["slowest_edge"],
            "edges": edges,
        }

    # -- resource plane --------------------------------------

    def _refresh_resources(self) -> None:
        """Pull every worker's /resources document, align the perf
        anchors with the clock offsets already estimated for
        /cluster/trace and REPLACE the merged view (current state, not a
        log: a vanished peer's stale saturation flag must not keep
        classifying straggler causes). Whole refreshes serialize like
        the step plane's."""
        self._planes["resources"].refresh()

    def _refresh_resources_locked(self) -> None:
        docs, offsets = self._plane_docs("/resources")
        merged = tresource.merge_resources(docs, offsets)
        with self._lock:
            self._resources = merged

    def cluster_resources(self) -> dict:
        """The /cluster/resources view: every live worker's resource
        attribution document merged NTP-aligned, plus the cluster
        election (saturated peers, max CPU fraction). Refreshes inline
        when the cached merge is older than a scrape interval, so
        one-shot consumers (`info resources` without a runner loop)
        still see fresh attribution."""
        self._planes["resources"].ensure_fresh()
        with self._lock:
            merged = dict(self._resources)
        doc = {
            "wall_time": time.time(),
            "count": len(merged.get("peers") or {}),
        }
        doc.update(merged)
        doc["plane"] = self.plane_envelope()
        return doc

    def _resources_summary(self) -> Optional[dict]:
        """Compact resource signal for /cluster/health (the full
        documents stay on /cluster/resources): per peer the window CPU
        fraction, the training bucket's share of the busy window, the
        engine share and the saturation flag — exactly the columns
        `info top` renders."""
        with self._lock:
            merged = self._resources
            if not merged or not merged.get("peers"):
                return None
            peers = {}
            for label, doc in merged["peers"].items():
                buckets = doc.get("buckets") or {}
                peers[label] = {
                    "cpu_frac": doc.get("cpu_frac"),
                    "train_frac": (buckets.get("train") or {}).get("frac"),
                    "engine_frac": doc.get("engine_frac"),
                    "saturated": bool(doc.get("saturated")),
                }
            return {
                "peers": peers,
                "saturated": list(merged.get("saturated") or []),
                "max_cpu_frac": merged.get("max_cpu_frac"),
            }

    # -- memory plane ----------------------------------------

    def _refresh_memory(self) -> None:
        """Pull every worker's /memory document, align the perf anchors
        with the clock offsets already estimated for /cluster/trace and
        REPLACE the merged view (current state, not a log: a vanished
        peer's stale pressure flag must not keep gating resizes).
        Whole refreshes serialize like the resource plane's."""
        self._planes["memory"].refresh()

    def _refresh_memory_locked(self) -> None:
        docs, offsets = self._plane_docs("/memory")
        merged = tmemory.merge_memory(docs, offsets)
        with self._lock:
            self._memory = merged

    def cluster_memory(self) -> dict:
        """The /cluster/memory view: every live worker's memory
        attribution document merged NTP-aligned, plus the cluster
        elections (minimum headroom + its peer, the pressure and
        thrashing sets, leak suspects). Refreshes inline when the
        cached merge is older than a scrape interval, so one-shot
        consumers (`info memory` without a runner loop) still see
        fresh attribution."""
        self._planes["memory"].ensure_fresh()
        with self._lock:
            merged = dict(self._memory)
        doc = {
            "wall_time": time.time(),
            "count": len(merged.get("peers") or {}),
        }
        doc.update(merged)
        doc["plane"] = self.plane_envelope()
        return doc

    def _memory_summary(self) -> Optional[dict]:
        """Compact memory signal for /cluster/health (the full
        documents stay on /cluster/memory): per peer the used fraction,
        headroom, thrash/pressure flags — exactly the columns `info
        top` renders — plus the cluster elections."""
        with self._lock:
            merged = self._memory
            if not merged or not merged.get("peers"):
                return None
            peers = {}
            for label, doc in merged["peers"].items():
                hf = doc.get("headroom_frac")
                peers[label] = {
                    "rss_bytes": doc.get("rss_bytes"),
                    "headroom_frac": hf,
                    "used_frac": (
                        round(1.0 - hf, 6)
                        if isinstance(hf, (int, float)) else None
                    ),
                    "pressure": bool(doc.get("pressure")),
                    "thrashing": bool(doc.get("thrashing")),
                }
            return {
                "peers": peers,
                "min_headroom_frac": merged.get("min_headroom_frac"),
                "min_headroom_peer": merged.get("min_headroom_peer"),
                "pressure": list(merged.get("pressure") or []),
                "thrashing": list(merged.get("thrashing") or []),
                "leak_suspects": dict(merged.get("leak_suspects") or {}),
            }

    def footprint_bytes(self) -> int:
        """The aggregator's OWN tracked-state footprint: deep size of
        the link matrix, step ring, decision log and the merged
        resource/memory views: the state that grows with the cluster,
        measured and registered under the `telemetry` bucket of its
        process's memory plane."""
        with self._lock:
            state = (
                {st.label: st.links for st in self._peers.values()},
                list(self._steps),
                dict(self._decisions),
                dict(self._resources),
                dict(self._memory),
                dict(self._link_cache),
                dict(self._steps_pending),
                dict(self._audit_cache),
            )
        return tmemory.deep_sizeof(state)

    def plane_envelope(self) -> dict:
        """Telemetry-plane health: one shared envelope every
        /cluster/* JSON document carries as `plane`, so any consumer —
        `info top --json`, a policy, an operator — can tell "the
        cluster is fine" from "the MONITORING is behind" without
        cross-referencing endpoints."""
        now_m = time.monotonic()
        stale = self._stale_peers()
        k = len(self.peers())
        env = {
            "mode": (
                "hier" if self._hier_active
                else ("sampled" if self._scale else "flat")
            ),
            "interval_s": self.interval,
            "effective_interval_s": round(self.effective_interval(), 3),
            "sweep_seconds": (
                round(self._last_sweep_s, 6)
                if self._last_sweep_s is not None else None
            ),
            "sweep_age_s": (
                round(now_m - self._sweep_mono, 3)
                if self._sweep_mono is not None else None
            ),
            "scraped_peers": k - len(stale),
            "stale_peers": len(stale),
        }
        if self._scale:
            _, ages = self._link_cache_view()
            env["oldest_link_row_age_s"] = (
                max(ages.values()) if ages else None
            )
        return env

    def _stale_endpoints(self, st: PeerState, now: float) -> Optional[List[str]]:
        """Per-(peer, endpoint) staleness: endpoints
        this peer HAS served whose last success is older than twice the
        effective interval — i.e. planes silently serving their
        previous payload. None when every known endpoint is fresh."""
        horizon = 2.0 * max(self.effective_interval(), 1e-9)
        out = sorted(
            ep for ep, at in st.endpoint_at.items()
            if now - at > horizon
        )
        out += sorted(
            ep for ep in st.endpoint_err
            if ep not in st.endpoint_at
        )
        return out or None

    def cluster_health(self) -> dict:
        """The JSON health snapshot behind /cluster/health and
        monitor.cluster_health()."""
        now = time.monotonic()
        scores = self.scorer.scores()
        rtt_scores = self.rtt_scorer.scores()
        peers = {}
        for st in self.peers():
            sc = scores.get(st.label)
            rsc = rtt_scores.get(st.label)
            peers[st.label] = {
                "url": st.url,
                "step_rate": st.step_rate,
                "step_time_p50_ms": (
                    round(st.step_p50 * 1e3, 3) if st.step_p50 is not None
                    else None
                ),
                "step_time_p99_ms": (
                    round(st.step_p99 * 1e3, 3) if st.step_p99 is not None
                    else None
                ),
                # the SCORED series' rolling median: compute time (step
                # minus collective wait) when the worker publishes
                # collective latencies, else wall-clock step time
                "step_time_ms": (
                    round(sc.value * 1e3, 3) if sc is not None else None
                ),
                "compute_time_ms": (
                    round(st.compute_mean * 1e3, 3)
                    if st.compute_mean is not None else None
                ),
                "bytes_tx": st.bytes_tx,
                "bytes_rx": st.bytes_rx,
                "rtt_ms": (
                    round(st.rtt_s * 1e3, 3)
                    if math.isfinite(st.rtt_s) else None
                ),
                "clock_offset_us": st.clock_offset_us,
                "last_scrape_age_s": (
                    round(now - st.last_ok, 3)
                    if st.last_ok is not None else None
                ),
                "error": st.last_error or None,
                "straggler": bool(sc.flagged) if sc is not None else False,
                "straggler_score": (
                    round(sc.score, 2) if sc is not None else None
                ),
                "rtt_outlier": bool(rsc.flagged) if rsc is not None else False,
                # the measured cause classified at the flag transition
                # (network/compute/unknown); None while unflagged
                "straggler_cause": self._causes.get(st.label),
                # endpoints whose last success predates the staleness
                # horizon — the plane is serving their previous payload
                "stale_endpoints": self._stale_endpoints(st, now),
            }
        med = self.scorer.cluster_median()
        return {
            # wall_time is the LAST SCRAPE's stamp, not request time:
            # consumers debounce refreshes on it (cluster/updated_at),
            # so re-reading an unchanged snapshot must not look fresh
            "wall_time": self._scraped_at,
            "interval_s": self.interval,
            "peers": peers,
            "stragglers": sorted(self._flagged),
            "rtt_outliers": sorted(self._rtt_flagged),
            "cluster_step_time_ms": (
                round(med * 1e3, 3) if med is not None else None
            ),
            "step_skew": self.scorer.skew(),
            "links": self._links_summary(),
            "steps": self._steps_summary(),
            "resources": self._resources_summary(),
            "memory": self._memory_summary(),
            "plane": self.plane_envelope(),
        }


# -- host sub-aggregator ---------------------------


class HostSubAggregator:
    """Per-host telemetry pre-merger: the worker elected head of its
    host scrapes its LOCAL siblings (loopback round trips, microsecond
    clock-offset error) and serves one ``/host/telemetry`` digest —
    every sibling's pre-parsed /metrics summary, raw exposition page
    (for federation) and delta-cursored plane documents. The root
    aggregator then sweeps O(hosts) digests instead of O(k) x O(planes)
    worker endpoints, composing clock offsets across the two hops.

    Election is deterministic (lowest peer label on the host, the same
    host grouping targets_for_workers encodes) and recomputed on every
    membership change — no coordination round, no extra process. The
    digest caches for half the scrape interval, so the root's poll
    cadence drives refreshes 1:1; delta cursors advance host-side, and
    the root's keyed/pooled merges make re-served digests idempotent.
    A digest the root never picks up (root died mid-sweep) loses those
    deltas to the root's view — the worker rings still hold them."""

    def __init__(
        self,
        host: str,
        timeout: float = 2.0,
        interval: Optional[float] = None,
        fetch: Optional[Callable[[str, str, float], Tuple[bytes, dict]]] = None,
    ):
        self.host = host
        self.timeout = timeout
        self.interval = (
            interval if interval is not None else scrape_interval()
        )
        self._transport = fetch
        self._lock = threading.Lock()  # targets/states + cache swap
        self._refresh_lock = threading.Lock()  # serialize whole sweeps
        self._states: Dict[str, PeerState] = {}
        self._cache: Optional[dict] = None
        self._cache_at: Optional[float] = None  # monotonic

    def set_targets(self, targets: Sequence[Tuple[str, str]]) -> None:
        """Replace the local scrape set (the election hook calls this
        on every membership change). Surviving siblings keep their
        clock offsets and delta cursors."""
        with self._lock:
            fresh: Dict[str, PeerState] = {}
            for label, url in targets:
                st = self._states.get(label)
                if st is None or st.url != url.rstrip("/"):
                    st = PeerState(label, url)
                fresh[label] = st
            self._states = fresh

    def _fetch(self, st: PeerState, path: str) -> bytes:
        t0 = time.perf_counter()
        if self._transport is not None:
            body, headers = self._transport(st.url, path, self.timeout)
            clock = headers.get(CLOCK_HEADER)
        else:
            with urllib.request.urlopen(
                st.url + path, timeout=self.timeout
            ) as r:
                body = r.read()
                clock = r.headers.get(CLOCK_HEADER)
        t1 = time.perf_counter()
        rtt = t1 - t0
        st.rtt_s = rtt
        _note_clock(st, rtt, clock, t0, t1)
        return body

    def _scrape_worker(self, st: PeerState) -> dict:
        try:
            body = self._fetch(st, "/metrics")
        except (OSError, ValueError) as e:
            return {"url": st.url, "error": str(e)}
        text = body.decode(errors="replace")
        entry: dict = {
            "url": st.url,
            "metrics_text": text,
            "parsed": parsed_to_doc(parse_worker_page(text)),
            "rtt_s": st.rtt_s,
            "clock_offset_us": st.clock_offset_us,
        }
        for path, key in PLANE_PATHS:
            p = path
            cur = st.since.get(path)
            if cur is not None:
                p = f"{path}?since={cur}"
            try:
                doc = json.loads(self._fetch(st, p).decode())
            except (OSError, ValueError) as e:
                # a sibling failing ONE endpoint still ships the rest;
                # the root's per-(peer, endpoint) staleness surfaces it
                st.endpoint_err[path] = str(e)
                continue
            st.endpoint_err.pop(path, None)
            if isinstance(doc.get("next_since"), int):
                st.since[path] = doc["next_since"]
            entry[key] = doc
        return entry

    def refresh(self) -> None:
        """One parallel sweep over the local siblings, building the
        digest cache."""
        with self._lock:
            states = sorted(self._states.values(), key=lambda s: s.label)
        workers: Dict[str, dict] = {}
        threads = [
            threading.Thread(
                target=lambda st=st: workers.__setitem__(
                    st.label, self._scrape_worker(st)
                ),
                daemon=True,
            )
            for st in states
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(self.timeout + 1.0)
        doc = {
            "enabled": True,
            "host": self.host,
            "wall_time": time.time(),
            "workers": workers,
        }
        with self._lock:
            self._cache = doc
            self._cache_at = time.monotonic()

    def digest(self) -> dict:
        """The /host/telemetry document, refreshed when older than half
        the scrape interval — the root polling at its interval always
        gets a this-cycle sweep, and a double poll inside one window
        re-serves the cache (the root's keyed merges dedupe)."""
        with self._refresh_lock:
            with self._lock:
                at = self._cache_at
            if (
                at is None
                or time.monotonic() - at >= 0.5 * self.interval
            ):
                self.refresh()
        with self._lock:
            return self._cache or {
                "enabled": True, "host": self.host, "workers": {},
            }


_host_sub: Optional[HostSubAggregator] = None
_host_sub_lock = threading.Lock()


def set_host_sub(sub: Optional[HostSubAggregator]) -> None:
    """Install/clear this process's host sub-aggregator (the election
    hook does this; tests may too)."""
    global _host_sub
    with _host_sub_lock:
        _host_sub = sub


def get_host_sub() -> Optional[HostSubAggregator]:
    with _host_sub_lock:
        return _host_sub


def host_digest_doc() -> dict:
    """The /host/telemetry view: the digest when this worker holds the
    host-head role, {"enabled": false} otherwise (the root probes the
    role cheaply and falls back to direct scrapes)."""
    sub = get_host_sub()
    if sub is None:
        return {"enabled": False}
    return sub.digest()


def update_host_role(self_id, workers) -> None:
    """(Re-)elect this worker's host sub-aggregator role; the peer
    calls this on start and on every membership change. The role
    engages only at scale (>= KF_AGG_HIER_MIN_PEERS targets, matching
    the root's threshold), on the worker whose label sorts lowest among
    its host's >= 2 local targets — the same deterministic choice the
    root's _sweep_host makes, so both sides agree without a
    coordination round."""
    targets = TelemetryAggregator.targets_for_workers(workers)
    thresh = hier_min_peers()
    label = str(self_id)
    url_by_label = dict(targets)
    mine: Optional[List[Tuple[str, str]]] = None
    my_host = None
    if thresh > 0 and len(targets) >= thresh and label in url_by_label:
        my_host = urlsplit(url_by_label[label]).hostname
        if my_host:
            local = [
                (lab, url) for lab, url in targets
                if urlsplit(url).hostname == my_host
            ]
            if len(local) > 1 and min(lab for lab, _ in local) == label:
                mine = local
    global _host_sub
    with _host_sub_lock:
        if mine is None:
            _host_sub = None
        else:
            if _host_sub is None or _host_sub.host != my_host:
                _host_sub = HostSubAggregator(host=my_host)
            _host_sub.set_targets(mine)


# -- adaptation-facing accessors ---------------------------------------

_aggregator: Optional[TelemetryAggregator] = None
_agg_lock = threading.Lock()
# remote /cluster/health cache: "t" = monotonic time of the last
# SUCCESSFUL fetch (a failed refresh must NOT re-stamp stale flags as
# fresh), "attempt_t" rate-limits refresh attempts, "fetching" holds the
# single in-flight refresh thread flag
_remote_cache: dict = {
    "t": 0.0, "attempt_t": 0.0, "data": None, "url": "", "fetching": False,
}


def set_aggregator(agg: Optional[TelemetryAggregator]) -> None:
    """Install the process-wide aggregator (the elastic watcher does
    this; tests may too)."""
    global _aggregator
    with _agg_lock:
        _aggregator = agg


def get_aggregator() -> Optional[TelemetryAggregator]:
    with _agg_lock:
        return _aggregator


def _refresh_remote(url: str) -> None:
    try:
        with urllib.request.urlopen(url, timeout=2.0) as r:
            data = json.loads(r.read().decode())
        with _agg_lock:
            if _remote_cache["url"] == url:
                _remote_cache.update(t=time.monotonic(), data=data)
    except (OSError, ValueError):
        pass  # keep the old data AND its old timestamp: stale is stale
    finally:
        with _agg_lock:
            _remote_cache["fetching"] = False


def health_snapshot(max_age: float = 5.0, wait: bool = False) -> Optional[dict]:
    """The latest cluster-health dict, from the in-process aggregator
    when this process hosts one (the runner), else fetched from
    ``KF_CLUSTER_HEALTH_URL`` (workers; the watcher injects the env var
    pointing at its own /cluster/health).

    The remote path NEVER blocks the caller (it sits on the training-step
    path via PolicyRunner): it returns the cached snapshot immediately —
    possibly stale, possibly None on the very first call — and refreshes
    in a background thread at most every ``max_age`` seconds. A snapshot
    older than the last scrape keeps its original ``wall_time``, so
    debounced consumers (cluster/updated_at) never mistake a dead
    runner's last flags for news. ``wait=True`` (tests, one-shot CLIs)
    runs an overdue refresh inline instead."""
    agg = get_aggregator()
    if agg is not None:
        return agg.cluster_health()
    url = knobs.raw(HEALTH_URL_ENV)
    if not url:
        return None
    now = time.monotonic()
    with _agg_lock:
        if _remote_cache["url"] != url:
            _remote_cache.update(
                t=0.0, attempt_t=0.0, data=None, url=url, fetching=False
            )
        data = _remote_cache["data"]
        fresh = data is not None and now - _remote_cache["t"] < max_age
        due = (
            not fresh
            and not _remote_cache["fetching"]
            and now - _remote_cache["attempt_t"] >= max_age
        )
        if due:
            _remote_cache["fetching"] = True
            _remote_cache["attempt_t"] = now
    if due:
        if wait:
            _refresh_remote(url)
            with _agg_lock:
                return _remote_cache["data"]
        threading.Thread(
            target=_refresh_remote, args=(url,),
            name="kf-health-refresh", daemon=True,
        ).start()
    return data


def health_signals(
    max_age: float = 5.0, self_peer: str = "", wait: bool = False
) -> dict:
    """Flatten the health snapshot into the signal dict policies see in
    ``PolicyContext.metrics`` (namespaced ``cluster/``)."""
    snap = health_snapshot(max_age, wait=wait)
    if not snap:
        return {}
    me = self_peer or knobs.raw("KF_SELF_SPEC")
    stragglers = snap.get("stragglers", [])
    signals = {
        # refresh marker: consumers that must count SCRAPES (not steps)
        # key off this — flag lists are identical between refreshes for
        # a steady straggler
        "cluster/updated_at": snap.get("wall_time"),
        "cluster/stragglers": stragglers,
        "cluster/rtt_outliers": snap.get("rtt_outliers", []),
        "cluster/step_skew": snap.get("step_skew"),
        "cluster/step_time_ms": snap.get("cluster_step_time_ms"),
        "cluster/straggler_score": {
            p: info.get("straggler_score")
            for p, info in snap.get("peers", {}).items()
            if info.get("straggler_score") is not None
        },
        "cluster/self_straggler": me in stragglers if me else False,
        # the measured cause behind each flagged straggler — the demotion policy only acts on
        # non-network causes: a slow LINK is the flat re-planner's job,
        # demotion is for peers that are themselves the bottleneck
        "cluster/straggler_causes": {
            p: info.get("straggler_cause")
            for p, info in snap.get("peers", {}).items()
            if info.get("straggler_cause")
        },
    }
    links = snap.get("links") or {}
    if links.get("min_bw") is not None:
        signals["links/min_bw"] = links["min_bw"]
        signals["links/slowest_edge"] = links.get("slowest_edge")
    # sampled-matrix freshness (scale mode only): consumers
    # voting on link data (ReplanPolicy) gate on row age — a rotation
    # that stopped refreshing must not keep steering re-plans
    if links.get("oldest_row_age_s") is not None:
        signals["links/oldest_row_age_s"] = links["oldest_row_age_s"]
    # telemetry-plane self-health: "the monitoring is
    # behind" as a signal, distinct from "the cluster is slow"
    plane = snap.get("plane") or {}
    if plane:
        signals["plane/mode"] = plane.get("mode")
        signals["plane/stale_peers"] = plane.get("stale_peers")
        if plane.get("sweep_seconds") is not None:
            signals["plane/sweep_seconds"] = plane["sweep_seconds"]
    # step plane: the measured per-step attribution signals
    # re-planning and priority feedback consume — cluster-wide values
    # override the worker-local steptrace fallbacks on the shared keys
    steps = snap.get("steps") or {}
    if steps.get("steps"):
        signals["step/critical_peer"] = steps.get("critical_peer")
        signals["step/critical_edge"] = steps.get("critical_edge")
        if steps.get("overlap_frac") is not None:
            signals["step/overlap_frac"] = steps["overlap_frac"]
        if steps.get("queue_delay_frac") is not None:
            signals["step/queue_delay_frac"] = steps["queue_delay_frac"]
    # resource plane: the cluster view of MY OWN attribution
    # overrides the worker-local fallback on the shared resource/* keys
    # (same precedence as the step plane) — policies on any peer also
    # see the cluster-wide compute-bound election
    res = snap.get("resources") or {}
    mine = (res.get("peers") or {}).get(me) if me else None
    if mine:
        if mine.get("cpu_frac") is not None:
            signals["resource/cpu_frac"] = mine["cpu_frac"]
        if mine.get("engine_frac") is not None:
            signals["resource/engine_frac"] = mine["engine_frac"]
        signals["resource/saturated"] = bool(mine.get("saturated"))
    if res.get("saturated") is not None:
        signals["resource/saturated_peers"] = list(res["saturated"])
    # memory plane: the cluster view of MY OWN headroom
    # overrides the worker-local fallback on the shared memory/* keys;
    # policies on any peer also see the cluster's weakest-headroom
    # election — the grow-gate input
    mem = snap.get("memory") or {}
    mem_mine = (mem.get("peers") or {}).get(me) if me else None
    if mem_mine:
        if mem_mine.get("headroom_frac") is not None:
            signals["memory/headroom_frac"] = mem_mine["headroom_frac"]
            signals["memory/pressure"] = bool(mem_mine.get("pressure"))
    if mem.get("min_headroom_peer") is not None:
        signals["memory/min_headroom_peer"] = mem["min_headroom_peer"]
        signals["memory/min_headroom_frac"] = mem.get("min_headroom_frac")
    if mem.get("leak_suspects"):
        signals["memory/leak_suspect"] = True
    return signals
