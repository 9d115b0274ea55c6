"""Straggler/anomaly detection over per-peer telemetry series.

Port of `kungfu_tpu/telemetry/straggler.py`. The MLPerf TPU-pod scaling
work identified step-time skew across replicas as THE primary scaling
diagnostic: one slow peer gates every synchronous collective, so the
cluster trains at the straggler's pace. This module turns the aggregator's per-peer scrape series (step times,
RTTs) into robust outlier flags the adaptation layer can act on.

Method (robust to the exact failure it hunts): each peer keeps a
rolling window of recent observations and is represented by its window
**median** (a peer's own noise spike must not flag it). Across peers,
the score is a robust z-score against the cluster median using MAD
(median absolute deviation, scaled by 1.4826 to estimate sigma) — the
z-score/IQR family of flags, but with estimators that a single extreme
peer cannot drag. A peer is flagged when BOTH hold:

- score >= z_threshold  (statistically far from the cluster), and
- value >= ratio_threshold * cluster median  (materially slower —
  a homogeneous fast cluster with microsecond jitter stays quiet).

With fewer than ``min_peers`` reporting peers the detector stays quiet:
skew is only defined relative to a population.
"""

from __future__ import annotations

import threading
from collections import deque
from statistics import median as _median
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

MAD_SIGMA = 1.4826  # MAD -> sigma for a normal distribution


class PeerScore(NamedTuple):
    value: float  # the peer's rolling-median observation
    score: float  # robust z against the cluster median
    flagged: bool


class StragglerScorer:
    def __init__(
        self,
        window: int = 16,
        z_threshold: float = 3.0,
        ratio_threshold: float = 1.5,
        min_peers: int = 3,
        min_samples: int = 2,
    ):
        self.window = window
        self.z_threshold = z_threshold
        self.ratio_threshold = ratio_threshold
        self.min_peers = min_peers
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._series: Dict[str, deque] = {}

    def observe(self, peer: str, value: float) -> None:
        with self._lock:
            q = self._series.get(peer)
            if q is None:
                q = self._series[peer] = deque(maxlen=self.window)
            q.append(float(value))

    def forget(self, live_peers: Iterable[str]) -> None:
        """Drop series for peers no longer in the cluster (elastic
        resizes must not leave ghost peers skewing the population)."""
        live = set(live_peers)
        with self._lock:
            for p in [p for p in self._series if p not in live]:
                del self._series[p]

    def drop(self, peer: str) -> None:
        """Drop one peer's series (its data source went dark: a frozen
        window must not keep flagging — or skewing — the population)."""
        with self._lock:
            self._series.pop(peer, None)

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def _medians(self) -> Dict[str, float]:
        with self._lock:
            return {
                p: _median(list(q))
                for p, q in self._series.items()
                if len(q) >= self.min_samples
            }

    def scores(self) -> Dict[str, PeerScore]:
        """Per-peer (rolling value, robust z, flagged) for every peer
        with enough samples. Empty until min_peers peers report."""
        meds = self._medians()
        if len(meds) < self.min_peers:
            return {
                p: PeerScore(v, 0.0, False) for p, v in meds.items()
            }
        cluster = _median(list(meds.values()))
        mad = _median([abs(v - cluster) for v in meds.values()])
        # sigma floor: a perfectly homogeneous cluster has MAD 0 and a
        # bare z-score would flag nanoseconds of jitter; 5% of the
        # cluster median (or an epsilon for all-zero series) keeps the
        # score scale meaningful
        sigma = max(MAD_SIGMA * mad, 0.05 * abs(cluster), 1e-9)
        out: Dict[str, PeerScore] = {}
        for p, v in meds.items():
            z = (v - cluster) / sigma
            flagged = (
                z >= self.z_threshold
                and v >= self.ratio_threshold * cluster
            )
            out[p] = PeerScore(v, z, flagged)
        return out

    def stragglers(self) -> List[str]:
        return sorted(p for p, s in self.scores().items() if s.flagged)

    def cluster_median(self) -> Optional[float]:
        meds = self._medians()
        return _median(list(meds.values())) if meds else None

    def skew(self) -> Optional[float]:
        """max(peer median) / cluster median — 1.0 means perfectly even;
        the headline number for "how much is the slowest peer costing"."""
        meds = self._medians()
        if len(meds) < 2:
            return None
        cluster = _median(list(meds.values()))
        if cluster <= 0:
            return None
        return max(meds.values()) / cluster


def blocking_edge(
    peer: str,
    steps: Optional[List[dict]] = None,
    links: Optional[dict] = None,
) -> Optional[List[Optional[str]]]:
    """The measured edge behind a flagged straggler: a z-score says *who* is slow, this says *where* — so the straggler
    audit event can name the blocking (src, dst) instead of only a
    duration.

    Preference order: the most recent merged step whose critical peer IS
    the flagged one (its elected edge is the direct measurement), else
    the slowest estimated link touching the peer in the k×k matrix
    (``merge_matrix`` document), else None — a compute straggler has no
    edge and should not get a fabricated one."""
    for s in reversed(steps or []):
        c = s.get("critical")
        if c and str(c.get("peer")) == str(peer) and c.get("edge"):
            return [str(peer), str(c["edge"])]
    worst: Optional[List[Optional[str]]] = None
    worst_bw: Optional[float] = None
    for src, row in ((links or {}).get("edges") or {}).items():
        for dst, info in row.items():
            if str(peer) not in (str(src), str(dst)):
                continue
            bw = info.get("bw")
            if not isinstance(bw, (int, float)) or bw <= 0:
                continue
            if worst_bw is None or bw < worst_bw:
                worst_bw = float(bw)
                worst = [str(src), str(dst)]
    return worst


def classify_cause(
    peer: str,
    steps: Optional[List[dict]] = None,
    links: Optional[dict] = None,
    resources: Optional[dict] = None,
    memory: Optional[dict] = None,
) -> Tuple[str, Optional[List[Optional[str]]]]:
    """Name WHY a flagged peer is slow: ``(cause, edge)`` with cause in
    {network, memory, compute, unknown}. Every cause is backed by a
    measurement, never inferred from absence:

    - the step plane elected this peer's edge as a recent critical
      path → **network** (the direct per-step measurement, strongest);
    - the memory plane says the peer is thrashing (sustained major
      page faults — its working set is paging off disk/swap) →
      **memory** (a pegged CPU or a slow link is a SYMPTOM when every
      access is a disk read, so this outranks the compute election);
    - the resource plane says the peer burned >= its saturation
      fraction of its effective cores → **compute** (a ring re-order
      or more bandwidth cannot speed up a pegged CPU);
    - otherwise, the slowest measured link touching the peer →
      **network** (weaker — a matrix estimate, not a step election —
      so the live thrash/saturation measurements outrank it);
    - no measurement at all → **unknown** with no fabricated edge.

    ``resources``/``memory`` are the merged /cluster/resources and
    /cluster/memory documents (their ``peers[peer]["saturated"]`` and
    ``peers[peer]["thrashing"]`` flags)."""
    for s in reversed(steps or []):
        c = s.get("critical")
        if c and str(c.get("peer")) == str(peer) and c.get("edge"):
            return "network", [str(peer), str(c["edge"])]
    # lazy imports: straggler is imported by the scorer-only paths too
    from kungfu_tpu_torch.telemetry import memory as tmemory
    from kungfu_tpu_torch.telemetry import resource as tresource

    if tmemory.peer_thrashing(memory, peer):
        return "memory", None
    if tresource.peer_saturated(resources, peer):
        return "compute", None
    edge = blocking_edge(peer, steps=None, links=links)
    if edge is not None:
        return "network", edge
    return "unknown", None
