"""Network monitor: per-peer egress/ingress byte counters and rate windows.

Port of `kungfu_tpu/monitor/net.py` (parity: srcs/go/monitor/
{monitor,counters,server}.go — totals and windowed rates per peer,
surfaced to training as `api.egress_rates()`).

The process singleton (:func:`get_monitor`) mirrors every count into
the metrics registry (``kungfu_egress_bytes_total``,
``kungfu_ingress_bytes_total`` and the message counters, labelled by
peer); the endpoint that serves them is the per-worker TelemetryServer.
:class:`MetricsServer` keeps the old standalone ``MetricsServer(mon,
port)`` contract. Enabled by ``KF_CONFIG_ENABLE_MONITORING`` (any truthy
spelling) or ``KF_TELEMETRY=metrics``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional

from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.telemetry import config as _tconfig
from kungfu_tpu_torch.telemetry import metrics as _metrics

DEFAULT_WINDOW = 1.0  # seconds


def enabled() -> bool:
    """Whether the transport counts bytes (telemetry.config's shared
    truthy parsing: "yes"/"on" count)."""
    return _tconfig.metrics_enabled()


class RateCounter:
    """Monotonic byte counter with a sliding-window rate estimate."""

    def __init__(self, window: float = DEFAULT_WINDOW):
        self._lock = threading.Lock()
        self._total = 0
        self._window = window
        self._samples: deque = deque()  # (t, total)

    def add(self, n: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._total += n
            self._samples.append((now, self._total))
            cutoff = now - self._window
            while len(self._samples) > 1 and self._samples[0][0] < cutoff:
                self._samples.popleft()

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def rate(self) -> float:
        """Bytes/sec over the window."""
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            (t0, b0), (t1, b1) = self._samples[0], self._samples[-1]
            if t1 <= t0:
                return 0.0
            return (b1 - b0) / (t1 - t0)


class NetMonitor:
    def __init__(self, registry: Optional[_metrics.Registry] = None):
        # guards the peer->counter TABLES (key inserts vs. scrape
        # iteration); each RateCounter still has its own lock for adds
        self._tables_lock = threading.Lock()
        self._egress: Dict[PeerID, RateCounter] = defaultdict(RateCounter)
        self._ingress: Dict[PeerID, RateCounter] = defaultdict(RateCounter)
        # registry mirroring: only the process singleton (get_monitor)
        # publishes into the shared registry; standalone instances (tests)
        # stay self-contained. Per-peer label children are cached beside
        # the rate counters (_children) — sent()/received() run per
        # MESSAGE, so the steady path must be cached-object .inc() calls,
        # not str(peer) + family-lock label lookups
        self._registry = registry
        self._reg_children: Dict[PeerID, tuple] = {}
        if registry is not None:
            self._reg_families = tuple(
                registry.counter(name, help, ("peer",))
                for name, help in (
                    ("kungfu_egress_bytes_total",
                     "Bytes sent per peer over the host transport"),
                    ("kungfu_ingress_bytes_total",
                     "Bytes received per peer over the host transport"),
                    ("kungfu_egress_messages_total",
                     "Messages sent per peer over the host transport"),
                    ("kungfu_ingress_messages_total",
                     "Messages received per peer over the host transport"),
                )
            )
            registry.add_renderer(self.render_rates)
        else:
            self._reg_families = None

    def _counter(self, table: Dict[PeerID, RateCounter], peer: PeerID) -> RateCounter:
        # insert under the tables lock so a concurrent scrape's snapshot
        # never races a rehash (first message from a new peer mid-resize)
        with self._tables_lock:
            return table[peer]

    def _children(self, peer: PeerID) -> tuple:
        kids = self._reg_children.get(peer)
        if kids is None:
            label = str(peer)
            kids = tuple(f.labels(label) for f in self._reg_families)
            with self._tables_lock:
                kids = self._reg_children.setdefault(peer, kids)
        return kids

    def _snapshot(self, table):
        with self._tables_lock:
            return sorted(table.items(), key=lambda kv: str(kv[0]))

    def sent(self, peer: PeerID, n: int) -> None:
        self._counter(self._egress, peer).add(n)
        if self._reg_families is not None:
            ebytes, _, emsgs, _ = self._children(peer)
            ebytes.inc(n)
            emsgs.inc()

    def received(self, peer: PeerID, n: int) -> None:
        self._counter(self._ingress, peer).add(n)
        if self._reg_families is not None:
            _, ibytes, _, imsgs = self._children(peer)
            ibytes.inc(n)
            imsgs.inc()

    def egress_totals(self) -> Dict[PeerID, int]:
        return {p: c.total for p, c in self._snapshot(self._egress)}

    def egress_rates(self, peers: List[PeerID]) -> List[float]:
        """Rates aligned to a rank order (parity: GetEgressRates)."""
        with self._tables_lock:
            table = dict(self._egress)
        return [table[p].rate() if p in table else 0.0 for p in peers]

    def ingress_rates(self, peers: List[PeerID]) -> List[float]:
        with self._tables_lock:
            table = dict(self._ingress)
        return [table[p].rate() if p in table else 0.0 for p in peers]

    def render_rates(self) -> str:
        """Windowed-rate gauges (not plain registry samples: the window is
        computed at scrape time)."""
        lines = []
        for name, table in (("egress", self._egress), ("ingress", self._ingress)):
            lines.append(f"# TYPE kungfu_{name}_rate gauge")
            for p, c in self._snapshot(table):
                lines.append(f'kungfu_{name}_rate{{peer="{p}"}} {c.rate():.1f}')
        return "\n".join(lines) + "\n"

    def render_metrics(self) -> str:
        """Prometheus-style exposition (parity: monitor/server.go):
        byte totals plus the rate block shared with render_rates()."""
        lines = []
        for name, table in (("egress", self._egress), ("ingress", self._ingress)):
            lines.append(f"# TYPE kungfu_{name}_bytes counter")
            for p, c in self._snapshot(table):
                lines.append(
                    f'kungfu_{name}_bytes{{peer="{p}"}} {c.total}'
                )
        return "\n".join(lines) + "\n" + self.render_rates()


_global_monitor: Optional[NetMonitor] = None
_monitor_lock = threading.Lock()


def get_monitor() -> NetMonitor:
    global _global_monitor
    with _monitor_lock:
        if _global_monitor is None:
            _global_monitor = NetMonitor(registry=_metrics.get_registry())
        return _global_monitor


class MetricsServer:
    """Back-compat /metrics endpoint for a standalone NetMonitor.

    Workers under a Peer get the full TelemetryServer (/metrics + /trace
    + /audit) instead; this wrapper keeps the old ``MetricsServer(mon,
    port)`` contract for embedders and serves the monitor's own
    exposition alongside the process registry.
    """

    def __init__(self, monitor: NetMonitor, port: int):
        from kungfu_tpu_torch.telemetry.http import TelemetryServer

        reg = _metrics.get_registry()
        self._srv = TelemetryServer(
            port,
            extra_routes={
                # include_extras=False: render_metrics() already carries
                # this monitor's rate gauges, and when `monitor` is the
                # process singleton its renderer is ALSO attached to the
                # registry — emitting a family twice is invalid exposition
                "/metrics": lambda: (
                    monitor.render_metrics() + reg.render(include_extras=False),
                    "text/plain; version=0.0.4",
                )
            },
        )
        self.port = self._srv.port
        self.httpd = self._srv.httpd

    def start(self):
        self._srv.start()

    def stop(self):
        self._srv.stop()
