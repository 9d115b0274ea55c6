"""Monitors: gradient noise scale and gradient variance (device plane),
and the network monitors `net` and `latency` (host plane), publishing
into the port's telemetry registry. Port of `kungfu_tpu/monitor/`.

The re-exports are lazy (PEP 562), as the JAX package's: the transport
imports `monitor.net` when a Peer is built, and must not pull the
optimizers in with it. The function `noise_scale` is not re-exported: it
would shadow the submodule of that name. Import it from
`kungfu_tpu_torch.monitor.noise_scale`. `cluster_health` flattens the
runner-side cluster aggregator's health snapshot into the signals
policies read."""

import importlib

_NOISE = ("GNSState", "gns_init", "gns_update", "monitor_gradient_noise_scale",
          "publish_noise_scale")
_VARIANCE = ("monitor_gradient_variance", "gradient_variance",
             "publish_gradient_variance")

__all__ = list(_NOISE + _VARIANCE) + ["cluster_health"]


def cluster_health(max_age: float = 5.0) -> dict:
    """Cluster-level health signals for the adaptation layer: the
    flattened ``cluster/*`` (and ``links/*``, ``plane/*``, ``step/*``)
    signal dict of the runner-side TelemetryAggregator's snapshot —
    straggler list, per-peer straggler scores and causes, step-time skew,
    RTT outliers, whether THIS worker is flagged, the elected critical
    (peer, edge). In the runner it reads the in-process aggregator; in a
    worker it polls the watcher's ``/cluster/health``
    (``KF_CLUSTER_HEALTH_URL``, injected at spawn) through a
    ``max_age``-second cache. ``{}`` when no cluster plane is up."""
    mod = importlib.import_module("kungfu_tpu_torch.telemetry.cluster")
    return mod.health_signals(max_age)


def __getattr__(name):
    # importlib, not a from-import: "noise_scale" names both the submodule
    # and a lazy attribute, and a from-import would re-enter this hook
    if name in _NOISE:
        return getattr(importlib.import_module("kungfu_tpu_torch.monitor.noise_scale"), name)
    if name in _VARIANCE:
        return getattr(importlib.import_module("kungfu_tpu_torch.monitor.grad_variance"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
