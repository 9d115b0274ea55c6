"""Per-link network observability: passive {src,dst} transport accounting.

Port of `kungfu_tpu/telemetry/link.py`. The transport's other counters
aggregate over all peers, so "the allreduce is slow" could never become
"the 2→3 edge is the bottleneck". This module gives every worker a
**link table**: one estimator per destination peer, fed passively by the
real collective traffic as it crosses :meth:`Client.send` — no probe
rounds, no extra messages.

Per destination it keeps:

- monotonic ``tx_bytes`` / ``tx_messages`` counters,
- an **EWMA bandwidth** estimate from large sends (payload ≥
  ``KF_LINK_BW_MIN_BYTES``, default 64 KiB — small frames measure
  per-message overhead, not the pipe),
- an **EWMA latency** estimate from ping round trips.

The worker's row exports through the ordinary metrics registry
(``kungfu_link_*`` families, ``dst``-labelled, cardinality-bounded both
by the registry guard and by ``KF_LINK_MAX_PEERS``, byte for byte the
reference's exposition); :func:`merge_matrix` assembles the k×k matrix
from every worker's row, and the session's measured re-plan round
exchanges the rows directly.

Estimation notes: EWMA (``KF_LINK_EWMA_ALPHA``, default 0.2) tracks a
drifting link within ~5-10 observations while riding out single-send
jitter; bandwidth samples are payload/send-time where send time covers
frame + flush into the kernel buffer (or the shm-ring memcpy for
colocated peers) — it measures the link *as the engine experiences it*,
which is exactly the signal topology re-planning needs. Sends that had
to (re)dial the peer are counted for bytes but skipped as bandwidth
samples (connection setup is not link speed).

The table registers a memory-plane accountant (``footprint_bytes``,
bounded by ``KF_LINK_MAX_PEERS``) in the ``telemetry`` bucket.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import memory as tmemory
from kungfu_tpu_torch.telemetry import metrics as tmetrics

# minimum payload for a bandwidth sample: below this the send time is
# dominated by per-message fixed cost (framing, syscall, rendezvous).
# Read at table construction like the other knobs, not at import — the
# api imports this module transitively, so an import-time read would
# freeze the default for embedders that set the env programmatically.
def _bw_min_bytes() -> int:
    return int(knobs.get("KF_LINK_BW_MIN_BYTES"))

# EWMA smoothing factor for bandwidth/latency estimates
def _alpha() -> float:
    return min(max(float(knobs.get("KF_LINK_EWMA_ALPHA")), 0.01), 1.0)


# destination cap for the table itself (the registry's cardinality guard
# backstops the exported families independently)
def _max_peers() -> int:
    return max(1, int(knobs.get("KF_LINK_MAX_PEERS")))


def enabled() -> bool:
    """The link plane rides the metrics gate (same as the net monitor):
    its feed sits on the per-message send path."""
    return tconfig.metrics_enabled()


class LinkEstimator:
    """Passive estimator for one directed edge (this peer → dst)."""

    __slots__ = (
        "tx_bytes", "tx_messages", "bw", "bw_samples", "latency",
        "latency_samples",
    )

    def __init__(self):
        self.tx_bytes = 0
        self.tx_messages = 0
        self.bw: Optional[float] = None  # bytes/sec, EWMA
        self.bw_samples = 0
        self.latency: Optional[float] = None  # seconds, EWMA
        self.latency_samples = 0

    def observe_send(
        self, nbytes: int, seconds: float, alpha: float, min_bytes: int
    ) -> None:
        self.tx_bytes += nbytes
        self.tx_messages += 1
        if seconds > 0.0 and nbytes >= min_bytes:
            sample = nbytes / seconds
            self.bw = (
                sample if self.bw is None
                else alpha * sample + (1.0 - alpha) * self.bw
            )
            self.bw_samples += 1

    def observe_latency(self, seconds: float, alpha: float) -> None:
        if seconds <= 0.0:
            return
        self.latency = (
            seconds if self.latency is None
            else alpha * seconds + (1.0 - alpha) * self.latency
        )
        self.latency_samples += 1


class LinkTable:
    """This worker's row of the cluster link matrix: one
    :class:`LinkEstimator` per destination, mirrored into ``dst``-labelled
    registry families so the row travels on the existing /metrics page."""

    def __init__(
        self,
        registry: Optional[tmetrics.Registry] = None,
        alpha: Optional[float] = None,
        max_peers: Optional[int] = None,
        bw_min_bytes: Optional[int] = None,
    ):
        self._lock = threading.Lock()
        self._links: Dict[str, LinkEstimator] = {}
        self._alpha = alpha if alpha is not None else _alpha()
        self._max_peers = max_peers if max_peers is not None else _max_peers()
        self._bw_min = (
            bw_min_bytes if bw_min_bytes is not None else _bw_min_bytes()
        )
        self._registry = registry
        self._reg_children: Dict[str, tuple] = {}
        if registry is not None:
            self._fam_bytes = registry.counter(
                "kungfu_link_tx_bytes_total",
                "Bytes sent over each outgoing link (this peer → dst)",
                ("dst",),
            )
            self._fam_msgs = registry.counter(
                "kungfu_link_tx_messages_total",
                "Messages sent over each outgoing link (this peer → dst)",
                ("dst",),
            )
            self._fam_bw = registry.gauge(
                "kungfu_link_bandwidth_bytes_per_second",
                "EWMA link bandwidth from passive large-send timing",
                ("dst",),
            )
            self._fam_lat = registry.gauge(
                "kungfu_link_latency_seconds",
                "EWMA link latency from ping round trips",
                ("dst",),
            )
        # memory plane: the table is bounded by max_peers, so its report
        # plateaus once the cluster is discovered
        tmemory.register_owner("link_table", "telemetry", self, lambda t: t.footprint_bytes())

    def footprint_bytes(self) -> int:
        """Deep size of the per-destination estimator map (the memory
        plane's `telemetry` bucket; bounded by KF_LINK_MAX_PEERS)."""
        with self._lock:
            snap = dict(self._links)
        return tmemory.deep_sizeof(snap)

    def _est(self, dst: str) -> Optional[LinkEstimator]:
        """Get-or-create under the table lock; None past the peer cap
        (the drop is visible in the registry's dropped-series counter,
        attributed to the tx-bytes family)."""
        est = self._links.get(dst)
        if est is not None:
            return est
        if len(self._links) >= self._max_peers:
            if self._registry is not None:
                # route the drop through the same visible counter the
                # registry guard uses
                self._fam_bytes._count_drop()
            return None
        est = self._links[dst] = LinkEstimator()
        return est

    def _children(self, dst: str) -> Optional[tuple]:
        if self._registry is None:
            return None
        kids = self._reg_children.get(dst)
        if kids is None:
            kids = (
                self._fam_bytes.labels(dst),
                self._fam_msgs.labels(dst),
                self._fam_bw.labels(dst),
                self._fam_lat.labels(dst),
            )
            self._reg_children[dst] = kids
        return kids

    def observe_send(self, dst, nbytes: int, seconds: float) -> None:
        """One completed transport send to `dst` taking `seconds`
        (pass seconds<=0 to count bytes without a bandwidth sample,
        e.g. when the send included a connection dial)."""
        key = str(dst)
        with self._lock:
            est = self._est(key)
            if est is None:
                return
            est.observe_send(nbytes, seconds, self._alpha, self._bw_min)
            kids = self._children(key)
            if kids is not None:
                c_bytes, c_msgs, g_bw, _ = kids
                c_bytes.inc(nbytes)
                c_msgs.inc()
                if est.bw is not None:
                    g_bw.set(est.bw)

    def observe_latency(self, dst, seconds: float) -> None:
        key = str(dst)
        with self._lock:
            est = self._est(key)
            if est is None:
                return
            est.observe_latency(seconds, self._alpha)
            kids = self._children(key)
            if kids is not None and est.latency is not None:
                kids[3].set(est.latency)

    def bandwidth(self, dst) -> Optional[float]:
        with self._lock:
            est = self._links.get(str(dst))
            return est.bw if est is not None else None

    def latency(self, dst) -> Optional[float]:
        with self._lock:
            est = self._links.get(str(dst))
            return est.latency if est is not None else None

    def min_bandwidth(
        self, dsts: Optional[Sequence] = None
    ) -> Tuple[Optional[str], Optional[float]]:
        """(dst, bw) of the slowest estimated outgoing link, optionally
        restricted to `dsts`; (None, None) when nothing is estimated."""
        keys = None if dsts is None else {str(d) for d in dsts}
        worst: Tuple[Optional[str], Optional[float]] = (None, None)
        with self._lock:
            for dst, est in self._links.items():
                if est.bw is None or (keys is not None and dst not in keys):
                    continue
                if worst[1] is None or est.bw < worst[1]:
                    worst = (dst, est.bw)
        return worst

    def row(self) -> Dict[str, dict]:
        """This peer's link-matrix row (the JSON shape merge_matrix and
        /cluster/links use per edge)."""
        with self._lock:
            return {
                dst: {
                    "bw": est.bw,
                    "latency_s": est.latency,
                    "tx_bytes": est.tx_bytes,
                    "tx_messages": est.tx_messages,
                    "bw_samples": est.bw_samples,
                }
                for dst, est in self._links.items()
            }

    def signals(self) -> Dict[str, object]:
        """Worker-local adaptation signals (namespaced like the cluster
        plane's; the cluster-wide values override these when a runner
        aggregator is live). ``links/slowest_edge`` is always the
        ``[src, dst]`` shape the cluster plane uses — src is None here
        because the local view only knows its own outgoing row — so
        policies can unpack it regardless of which plane supplied it."""
        dst, bw = self.min_bandwidth()
        if bw is None:
            return {}
        return {"links/min_bw": bw, "links/slowest_edge": [None, dst]}

    def prune(self, keep: Sequence) -> None:
        """Drop estimators for destinations outside `keep` (called at
        every membership change): a departed peer's frozen EWMA must not
        keep winning :meth:`min_bandwidth` — and through it the
        ``links/*`` adaptation signals and walk-efficiency scoring — nor
        keep exporting stale gauges, after the peer is gone. The
        aggregator clears a dead peer's own ROW on scrape failure; this
        is the matching guard for every other peer's edge TOWARD it."""
        keep_keys = {str(d) for d in keep}
        with self._lock:
            for dst in [d for d in self._links if d not in keep_keys]:
                del self._links[dst]
                self._reg_children.pop(dst, None)
                if self._registry is not None:
                    self._fam_bytes.remove(dst)
                    self._fam_msgs.remove(dst)
                    self._fam_bw.remove(dst)
                    self._fam_lat.remove(dst)

    def clear(self) -> None:
        with self._lock:
            self._links.clear()
            self._reg_children.clear()


def merge_matrix(
    rows: Dict[str, Dict[str, dict]], copy_edges: bool = True
) -> dict:
    """Merge per-peer link rows into the cluster's k×k matrix document.

    `rows` maps a source peer label to its row (``{dst: {bw, latency_s,
    tx_bytes, ...}}``) — exactly what each worker's exposition carries.
    Tolerant by design: peers with no row yet (fresh joiner, scrape
    error) contribute no edges but still appear in ``peers`` when some
    other peer has an edge toward them; a degenerate single-peer cluster
    yields an edgeless 1×1 matrix with ``min_bw: null``.

    ``copy_edges=False`` references the caller's edge dicts instead of
    copying the full k² of them — for read-and-discard consumers (the
    /cluster/health summary) that only want the election this function
    is the single source of; anything that hands the document onward
    (e.g. /cluster/links serialization) keeps the default copy."""
    peers = set(rows)
    for row in rows.values():
        peers.update(row)
    edges: Dict[str, Dict[str, dict]] = {}
    min_bw: Optional[float] = None
    slowest: Optional[List[str]] = None
    for src in sorted(rows):
        row = rows[src]
        if not row:
            continue
        edges[src] = {
            dst: (dict(info) if copy_edges else info)
            for dst, info in sorted(row.items())
        }
        for dst, info in row.items():
            bw = info.get("bw")
            if isinstance(bw, (int, float)) and bw > 0:
                if min_bw is None or bw < min_bw:
                    min_bw = float(bw)
                    slowest = [src, dst]
    return {
        "peers": sorted(peers),
        "edges": edges,
        "min_bw": min_bw,
        "slowest_edge": slowest,
    }


_table: Optional[LinkTable] = None
_table_lock = threading.Lock()


def get_table() -> LinkTable:
    """The process-wide link table (registry-backed)."""
    global _table
    with _table_lock:
        if _table is None:
            _table = LinkTable(registry=tmetrics.get_registry())
        return _table
