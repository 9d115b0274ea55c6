"""Peer latency probes: an RTT vector over the host plane.

Port of `kungfu_tpu/monitor/latency.py` (parity: GetPeerLatencies,
srcs/go/kungfu/session/monitoring.go:38-64 + ops/cpu/topology.cpp:84-116):
each peer pings every other peer and reports a round-trip-time vector
(self = 0), the input of the MST topology (`plan/mst.py`).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np


def probe_peer_latencies(client, peers, self_rank: int, samples: int = 3) -> np.ndarray:
    """RTT seconds per peer, aligned to rank order; self = 0.0, unreachable
    peers = +inf. Takes the best of `samples` probes (min filters out
    scheduler noise)."""
    from kungfu_tpu_torch.telemetry import config as _tcfg
    from kungfu_tpu_torch.telemetry import metrics as _tm

    rtt_gauge = (
        _tm.gauge(
            "kungfu_peer_rtt_seconds",
            "Best probed RTT per peer (+inf peers omitted)",
            ("peer",),
        )
        if _tcfg.metrics_enabled()
        else None
    )
    if rtt_gauge is not None:
        # each probe covers the CURRENT cluster: dropping the old children
        # stops departed peers from reporting stale RTTs forever
        rtt_gauge.clear_children()
    out = np.zeros(len(peers), np.float64)
    for r, peer in enumerate(peers):
        if r == self_rank:
            continue
        best = np.inf
        for _ in range(samples):
            t0 = time.perf_counter()
            if client.ping(peer, timeout=2.0):
                best = min(best, time.perf_counter() - t0)
        out[r] = best
        if rtt_gauge is not None and np.isfinite(best):
            rtt_gauge.labels(str(peer)).set(best)
    return out


def latency_matrix_from_rows(rows: List[np.ndarray]) -> np.ndarray:
    """Symmetrize allgathered RTT rows into a dense cost matrix (average of
    the two directions; peers measure slightly different RTTs)."""
    m = np.stack(rows).astype(np.float64)
    return (m + m.T) / 2.0
