"""Image classification batches: NHWC images of unit-normal pixels in the
dtype the model computes in, and labels drawn uniformly over the classes.

Parameters (a workload's "traffic"): batch (images a rank trains on a
step), pool (distinct batches staged, taken in turn)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from kfbench.reference import common


def pool(traffic: Dict, cfg: Dict, seed: int, rank: int, device) -> Tuple[torch.Tensor, ...]:
    """(images (pool, batch, H, W, C), labels (pool, batch)) of `rank`."""
    n, b, side = traffic["pool"], traffic["batch"], cfg["image_size"]
    images = torch.randn((n, b, side, side, cfg["in_channels"]), device=device,
                         dtype=getattr(torch, cfg["dtype"]),
                         generator=common.generator(device, seed, rank, 10))
    labels = torch.randint(0, cfg["num_classes"], (n, b), device=device,
                           generator=common.generator(device, seed, rank, 11))
    return images, labels
