"""Telemetry of the host plane. Port of `kungfu_tpu/telemetry/`.

- :mod:`~kungfu_tpu_torch.telemetry.metrics`: the process registry of
  counters, gauges and histograms with labels, and its Prometheus text;
- :mod:`~kungfu_tpu_torch.telemetry.tracing`: span tracing (a ring with
  nesting and step scopes, Chrome-trace JSON export);
- :mod:`~kungfu_tpu_torch.telemetry.audit`: the structured resize and
  strategy audit log;
- :mod:`~kungfu_tpu_torch.telemetry.log`: the rank-prefixed logger;
- :mod:`~kungfu_tpu_torch.telemetry.http`: the per-worker ``/metrics``,
  ``/trace`` and ``/audit`` endpoint;
- :mod:`~kungfu_tpu_torch.telemetry.promparse`: exposition parsing and
  federation (imported lazily).

Feature selection: ``KF_TELEMETRY=metrics,trace,audit`` (see
:mod:`~kungfu_tpu_torch.telemetry.config`). ``dump()`` snapshots
everything for ad-hoc inspection.
"""

from __future__ import annotations

from kungfu_tpu_torch.telemetry import audit, config, log, metrics, tracing
from kungfu_tpu_torch.telemetry.config import (
    enable,
    enabled,
    env_truthy,
    features,
    metrics_enabled,
    refresh,
    trace_enabled,
    truthy,
)
from kungfu_tpu_torch.telemetry.metrics import get_registry

__all__ = [
    "audit",
    "config",
    "log",
    "metrics",
    "tracing",
    "enable",
    "enabled",
    "env_truthy",
    "features",
    "metrics_enabled",
    "refresh",
    "trace_enabled",
    "truthy",
    "get_registry",
    "dump",
    "serve",
    "promparse",
]

_LAZY_MODULES = ("promparse",)


def __getattr__(name):
    if name in _LAZY_MODULES:
        import importlib

        return importlib.import_module(f"kungfu_tpu_torch.telemetry.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def dump(prefix: str = "") -> dict:
    """Snapshot every telemetry surface of this process:

    ``metrics``  Prometheus text exposition,
    ``trace``    Chrome-trace JSON object (``traceEvents`` with
                 ``ph``/``ts``/``dur``),
    ``audit``    resize/strategy audit records as dicts,
    ``spans``    total-ms-per-span summary (quick look).
    """
    metrics.update_process_health()
    return {
        "features": sorted(features()),
        "metrics": metrics.render(),
        "trace": tracing.chrome_trace(prefix),
        "audit": audit.to_json(),
        "spans": tracing.summary_ms(prefix),
    }


def serve(port: int = 0, host: str = "0.0.0.0"):
    """Start a standalone telemetry endpoint (started and returned);
    workers under a Peer get one on their peer port + 10000."""
    from kungfu_tpu_torch.telemetry.http import TelemetryServer

    srv = TelemetryServer(port, host=host)
    srv.start()
    return srv
