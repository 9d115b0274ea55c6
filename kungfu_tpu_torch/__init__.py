"""kungfu_tpu_torch -- the PyTorch/CUDA port of kungfu_tpu for NVIDIA Hopper.

Same paths as the JAX package (`kungfu_tpu_torch/ops/flash_attention.py`
ports `kungfu_tpu/ops/flash_attention.py`), PyTorch idioms inside. The
package imports torch and numpy only, never JAX and never `kungfu_tpu`.

Device rule: every entry point takes ``device=None``, which means the CUDA
card. Without a card that raises; the CPU runs only when the caller asks for
it with ``device="cpu"``.
"""

from __future__ import annotations

from kungfu_tpu_torch import knobs as _knobs

# Debug-mode lock-order detector: installed FIRST, before torch and any
# module of the port creates a lock, so every threading.Lock/RLock below
# this line is instrumented. Unset/falsy knob = lockwatch never imported,
# threading untouched, zero overhead.
if _knobs.get("KF_DEBUG_LOCKS"):
    from kungfu_tpu_torch.devtools import lockwatch as _lockwatch

    _lockwatch.install()

import torch as _torch  # noqa: E402 - after the detector, which must come first

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def resolve_device(device=None) -> _torch.device:
    """``None`` -> the current CUDA device, raising RuntimeError if there is
    no card; anything else -> ``torch.device(device)``, unchanged."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "kungfu_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return _torch.device("cuda", _torch.cuda.current_device())
    return _torch.device(device)
