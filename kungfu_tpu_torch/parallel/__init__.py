"""The device plane's parallelism. The JAX package's
`kungfu_tpu/parallel/__init__.py` list, for what the port has
(`reinitialize_device_plane` and `device_plane_initialized` wait for the
host plane)."""

from kungfu_tpu_torch.parallel.distributed import initialize_device_plane, shutdown_device_plane
from kungfu_tpu_torch.parallel.dp import make_train_step
from kungfu_tpu_torch.parallel.mesh import DeviceSession, make_mesh
from kungfu_tpu_torch.parallel.pipeline import make_pp_transformer_loss

__all__ = [
    "DeviceSession",
    "make_mesh",
    "make_pp_transformer_loss",
    "make_train_step",
    "initialize_device_plane",
    "shutdown_device_plane",
]
