"""Monitors: gradient noise scale and gradient variance (device plane),
and the network monitors `net` and `latency` (host plane), publishing
into the port's telemetry registry. Port of `kungfu_tpu/monitor/`.

The re-exports are lazy (PEP 562), as the JAX package's: the transport
imports `monitor.net` when a Peer is built, and must not pull the
optimizers in with it. The function `noise_scale` is not re-exported: it
would shadow the submodule of that name. Import it from
`kungfu_tpu_torch.monitor.noise_scale`. The JAX package's
`cluster_health` reads its runner-side cluster aggregator, which the
port does not have yet."""

import importlib

_NOISE = ("GNSState", "gns_init", "gns_update", "monitor_gradient_noise_scale",
          "publish_noise_scale")
_VARIANCE = ("monitor_gradient_variance", "gradient_variance",
             "publish_gradient_variance")

__all__ = list(_NOISE + _VARIANCE)


def __getattr__(name):
    # importlib, not a from-import: "noise_scale" names both the submodule
    # and a lazy attribute, and a from-import would re-enter this hook
    if name in _NOISE:
        return getattr(importlib.import_module("kungfu_tpu_torch.monitor.noise_scale"), name)
    if name in _VARIANCE:
        return getattr(importlib.import_module("kungfu_tpu_torch.monitor.grad_variance"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
