"""kungfu_tpu_torch -- the PyTorch/CUDA port of kungfu_tpu for NVIDIA Hopper.

Same paths as the JAX package (`kungfu_tpu_torch/ops/flash_attention.py`
ports `kungfu_tpu/ops/flash_attention.py`), PyTorch idioms inside. The
package imports torch and numpy only, never JAX and never `kungfu_tpu`.

Device rule: every entry point takes ``device=None``, which means the CUDA
card. Without a card that raises; the CPU runs only when the caller asks for
it with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["__version__", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device, raising RuntimeError if there is
    no card; anything else -> ``torch.device(device)``, unchanged."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kungfu_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
