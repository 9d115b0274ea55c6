"""Adaptive strategy control: throughput stats, interference detection,
consensus strategy switching.

Port of `kungfu_tpu/collective/adaptive.py`. Capability parity: the reference's adaptation subsystem —
- per-strategy throughput stats updated by monitored collectives
  (srcs/go/kungfu/session/monitoring.go:15-35, CalcStats/LogStats in
  session/adaptiveStrategies.go:18-55);
- interference detection: when the monitored throughput falls below
  0.8x the reference window, peers vote via an allreduce and, on a
  cluster-wide majority, everyone advances to the next strategy in the
  same deterministic order (adaptiveStrategies.go:61-121).

This governs the HOST plane (collectives between hosts, where
congestion and interference are real); the device plane's collectives
are NCCL's or gloo's, so adaptation operates on the host engine exactly
where the reference adapts its TCP graphs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

INTERFERENCE_THRESHOLD = 0.8  # parity: reference's 0.8x window check
WARMUP_SAMPLES = 8
EMA_DECAY = 0.7


@dataclasses.dataclass
class StrategyStat:
    """Throughput accounting for one active strategy list."""

    total_bytes: int = 0
    total_seconds: float = 0.0
    count: int = 0
    ema_throughput: float = 0.0  # bytes/sec
    best_throughput: float = 0.0  # reference window

    def update(self, nbytes: int, seconds: float) -> None:
        if seconds <= 0:
            return
        self.total_bytes += nbytes
        self.total_seconds += seconds
        self.count += 1
        tp = nbytes / seconds
        if self.ema_throughput == 0.0:
            self.ema_throughput = tp
        else:
            self.ema_throughput = (
                EMA_DECAY * self.ema_throughput + (1 - EMA_DECAY) * tp
            )
        if self.count >= WARMUP_SAMPLES // 2:
            self.best_throughput = max(self.best_throughput, self.ema_throughput)

    def suspect_interference(self) -> bool:
        """Local suspicion: warmed up AND ema below 0.8x the best window."""
        return (
            self.count >= WARMUP_SAMPLES
            and self.best_throughput > 0
            and self.ema_throughput < INTERFERENCE_THRESHOLD * self.best_throughput
        )

    def summary(self) -> dict:
        avg = self.total_bytes / self.total_seconds if self.total_seconds else 0.0
        return {
            "count": self.count,
            "total_bytes": self.total_bytes,
            "avg_throughput": avg,
            "ema_throughput": self.ema_throughput,
            "best_throughput": self.best_throughput,
        }


class AdaptiveState:
    """Tracks stats per candidate strategy and the active index.

    The candidate order is identical on every peer (derived from the
    cluster), so a majority vote can switch everyone in lockstep without
    exchanging the choice itself — only the vote count.
    """

    def __init__(self, n_candidates: int, names: Optional[List[str]] = None):
        self.n_candidates = max(1, n_candidates)
        self.active = 0
        # display names, e.g. "RING_SEGMENTED/bf16": candidates are
        # (strategy, wire-codec) pairs since the codec joined the
        # adaptive set — stats summaries label them for operators
        self.names: List[str] = list(names or [])[: self.n_candidates]
        self.stats: List[StrategyStat] = [StrategyStat() for _ in range(self.n_candidates)]
        self.switch_count = 0
        self.last_switch_time: Optional[float] = None

    @property
    def current(self) -> StrategyStat:
        return self.stats[self.active]

    def advance(self) -> int:
        """Move to the next candidate (wrapping), reset its window."""
        self.active = (self.active + 1) % self.n_candidates
        self.stats[self.active] = StrategyStat()
        self.switch_count += 1
        self.last_switch_time = time.monotonic()
        return self.active

    def summary(self) -> dict:
        stats = []
        for i, s in enumerate(self.stats):
            d = s.summary()
            if i < len(self.names):
                d["candidate"] = self.names[i]
            stats.append(d)
        return {
            "active": self.active,
            "switches": self.switch_count,
            "stats": stats,
        }
