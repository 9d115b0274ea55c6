"""Collective critical-path profiler and span sampling.

Port of `kungfu_tpu/collective/profiler.py`. With metrics on, every
walk's attribution also lands in the registry
(`kungfu_collective_walk_seconds_total{collective,strategy,phase}`),
and a walk the link table has an estimate for sets
`kungfu_collective_efficiency_ratio{collective,strategy}`: the optimal
walk's time over the slowest link it used, divided by its measured
wall time. `snapshot()` and `signals()` read the same attribution.

Everything here is walk *measurement*: per-walk wait/send accumulation
(:class:`WalkProfile`), the deterministic per-step span sampler
(:class:`SpanSampler`) and the process-global :class:`WalkProfiler`
that attributes every allreduce walk's wall time and scores it against
the link plane's bandwidth estimates. The walk engines (walks.py) feed
it; benchmarks and PolicyContext read it.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from kungfu_tpu_torch.telemetry import config as tconfig
from kungfu_tpu_torch.telemetry import metrics as tmetrics


class WalkProfile:
    """Per-walk critical-path accumulator (one walk = one thread running
    one segmented ring or one chunk's graph pair): seconds the walk
    thread spent blocked on receives and blocked on sends. Everything
    else — reduce/codec kernels, pack/unpack memcpys, Python overhead —
    is compute by construction (wall − wait − send), so the three
    fractions always sum to 1."""

    __slots__ = ("wait", "send")

    def __init__(self):
        self.wait = 0.0
        self.send = 0.0


class SpanSampler:
    """Deterministic walk sampler for per-step spans
    (KF_TELEMETRY_SPAN_SAMPLE): emits per-step spans for walk n iff the
    integer part of n*rate advances — exactly rate*N of any N walks,
    evenly spaced, identical across reruns (no RNG)."""

    __slots__ = ("rate", "_n", "_lock")

    def __init__(self, rate: float):
        self.rate = rate
        self._n = 0
        self._lock = threading.Lock()

    def sample(self) -> bool:
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        with self._lock:
            self._n += 1
            n = self._n
        return int(n * self.rate) != int((n - 1) * self.rate)


class WalkProfiler:
    """Collective critical-path profiler.

    Aggregates every allreduce walk's wall-time attribution per
    (public collective, executing strategy): fractions of walk time
    spent wait-on-recv vs reduce/codec compute vs send-blocked, the
    achieved throughput against the 2·(k−1)/k·N bandwidth-optimal
    bound, and — when the link plane has a bandwidth estimate for the
    links the walk used — an **efficiency ratio**:

        efficiency = (2·(k−1)/k·N / link_bw) / wall
                   = optimal transfer time / achieved wall time

    1.0 means the walk moved its optimal byte volume at full measured
    link speed; the gap to 1.0 is the overhead the async scheduler and
    topology re-planner have to harvest. Process-global (sessions are
    rebuilt every elastic epoch, the attribution must survive them).

    Attribution caveats (documented, not bugs): on graph walks the
    pairwise receive path folds its in-place reduce into the timed
    receive block (the n-ary fan-in path separates them), and wire-mode
    fan-out encodes land in compute while the transport part of the
    fan-out lands in send. The fractions describe the walk *thread*;
    pool-thread work overlapped with a timed block is deliberately not
    double-counted.
    """

    _ALPHA = 0.2  # EWMA for the efficiency series, matches the link plane

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: Dict[Tuple[str, str], dict] = {}

    def record(
        self,
        collective: str,
        strategy: str,
        k: int,
        payload_bytes: int,
        wall: float,
        wait: float,
        send: float,
        link_bw: Optional[float] = None,
    ) -> None:
        if wall <= 0.0 or k < 2 or payload_bytes <= 0:
            return
        # clamp measurement jitter so per-walk phases never exceed wall
        # (fractions must sum to 1 by construction)
        blocked = wait + send
        if blocked > wall:
            scale = wall / blocked
            wait *= scale
            send *= scale
        opt_bytes = 2.0 * (k - 1) / k * payload_bytes
        eff = None
        if link_bw is not None and link_bw > 0:
            eff = (opt_bytes / link_bw) / wall
        key = (collective, strategy)
        with self._lock:
            a = self._acc.get(key)
            if a is None:
                a = self._acc[key] = {
                    "walks": 0, "wall": 0.0, "wait": 0.0, "send": 0.0,
                    "payload_bytes": 0.0, "opt_bytes": 0.0,
                    "eff": None, "eff_samples": 0,
                    # EWMAs of RECENT walks, for signals(): the cumulative
                    # sums above describe the whole run (snapshot/bench),
                    # but an adaptation signal weighted by all-time sums
                    # goes inert after hours — a link that degrades at
                    # walk 50,000 must move the signal within ~10 walks,
                    # like the link plane's own bandwidth EWMA does
                    "wait_frac_ewma": None, "wall_ewma": None,
                }
            a["walks"] += 1
            a["wall"] += wall
            a["wait"] += wait
            a["send"] += send
            a["payload_bytes"] += payload_bytes
            a["opt_bytes"] += opt_bytes
            wf = wait / wall
            a["wait_frac_ewma"] = (
                wf if a["wait_frac_ewma"] is None
                else self._ALPHA * wf + (1.0 - self._ALPHA) * a["wait_frac_ewma"]
            )
            a["wall_ewma"] = (
                wall if a["wall_ewma"] is None
                else self._ALPHA * wall + (1.0 - self._ALPHA) * a["wall_ewma"]
            )
            if eff is not None:
                a["eff"] = (
                    eff if a["eff"] is None
                    else self._ALPHA * eff + (1.0 - self._ALPHA) * a["eff"]
                )
                a["eff_samples"] += 1
                ewma = a["eff"]
            else:
                ewma = None
        self._publish(collective, strategy, wall, wait, send, ewma)

    def _publish(self, collective, strategy, wall, wait, send, eff) -> None:
        # re-read the gate every walk (once per walk, not per step): the
        # profiler is process-global and outlives session epochs
        if not tconfig.metrics_enabled():
            return
        phases = tmetrics.counter(
            "kungfu_collective_walk_seconds_total",
            "Walk wall time attributed to wait-on-recv / reduce+codec "
            "compute / send-blocked, per collective and strategy",
            ("collective", "strategy", "phase"),
        )
        phases.labels(collective, strategy, "wait").inc(wait)
        phases.labels(collective, strategy, "send").inc(send)
        phases.labels(collective, strategy, "compute").inc(max(wall - wait - send, 0.0))
        if eff is not None:
            tmetrics.gauge(
                "kungfu_collective_efficiency_ratio",
                "EWMA of achieved walk time vs the 2(k-1)/k*N bandwidth-"
                "optimal bound at measured link speed (1.0 = optimal)",
                ("collective", "strategy"),
            ).labels(collective, strategy).set(eff)

    def snapshot(self) -> Dict[str, dict]:
        """Per-'collective/strategy' attribution summary; fractions sum
        to ~1.0 (compute is the residual)."""
        with self._lock:
            items = {k: dict(v) for k, v in self._acc.items()}
        out: Dict[str, dict] = {}
        for (collective, strategy), a in sorted(items.items()):
            wall = a["wall"]
            if wall <= 0:
                continue
            wait_f = a["wait"] / wall
            send_f = a["send"] / wall
            out[f"{collective}/{strategy}"] = {
                "walks": a["walks"],
                "wall_s": wall,
                "payload_bytes": a["payload_bytes"],
                "wait_frac": wait_f,
                "send_frac": send_f,
                "compute_frac": max(1.0 - wait_f - send_f, 0.0),
                "achieved_gib_s": a["opt_bytes"] / wall / (1 << 30),
                "efficiency": a["eff"],
                "efficiency_samples": a["eff_samples"],
            }
        return out

    def signals(self) -> Dict[str, float]:
        """Adaptation-facing summary for PolicyContext.metrics: the
        EWMA wait fraction and efficiency of RECENT walks, weighted
        across walk families by each family's recent wall time (a family
        that stopped running stops steering the signal; one that turned
        slow dominates it — all-time sums would go inert on long runs)."""
        with self._lock:
            # copy under the lock (like snapshot): the per-key dicts are
            # mutated by record() on walk threads, and the sums below
            # must read one consistent state
            items = [dict(v) for v in self._acc.values()]
        items = [a for a in items if a["wall_ewma"]]
        wall = sum(a["wall_ewma"] for a in items)
        if wall <= 0:
            return {}
        out: Dict[str, float] = {
            "collective/wait_frac": (
                sum(a["wall_ewma"] * a["wait_frac_ewma"] for a in items) / wall
            ),
        }
        eff_wall = sum(a["wall_ewma"] for a in items if a["eff"] is not None)
        if eff_wall > 0:
            out["collective/efficiency"] = (
                sum(
                    a["wall_ewma"] * a["eff"]
                    for a in items
                    if a["eff"] is not None
                )
                / eff_wall
            )
        return out

    def reset(self) -> None:
        with self._lock:
            self._acc.clear()


_walk_profiler = WalkProfiler()


def get_walk_profiler() -> WalkProfiler:
    return _walk_profiler
