"""State broadcast at initialization. Port of `kungfu_tpu/initializer.py`:
every rank starts from rank 0's parameters and buffers."""

from __future__ import annotations

import torch
import torch.distributed as dist


@torch.no_grad()
def broadcast_variables(module: torch.nn.Module, session) -> torch.nn.Module:
    """Overwrite `module`'s parameters and buffers with rank 0's, in place.
    A world of one is left untouched."""
    if session.size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=session.group)
    return module
