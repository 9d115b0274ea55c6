"""Monitors: gradient noise scale and gradient variance (device plane).
Port of `kungfu_tpu/monitor/__init__.py`'s `_NOISE` and `_VARIANCE`
names. `cluster_health` and the network monitors wait for the port of
the telemetry plane.

The function `noise_scale` is not re-exported, as in the JAX package: it
would shadow the submodule of that name. Import it from
`kungfu_tpu_torch.monitor.noise_scale`."""

from kungfu_tpu_torch.monitor.grad_variance import (
    gradient_variance,
    monitor_gradient_variance,
    publish_gradient_variance,
)
from kungfu_tpu_torch.monitor.noise_scale import (
    GNSState,
    gns_init,
    gns_update,
    monitor_gradient_noise_scale,
    publish_noise_scale,
)

__all__ = [
    "GNSState",
    "gns_init",
    "gns_update",
    "monitor_gradient_noise_scale",
    "publish_noise_scale",
    "monitor_gradient_variance",
    "gradient_variance",
    "publish_gradient_variance",
]
