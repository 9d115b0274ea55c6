"""MNIST SLP/MLP, the smallest training workload. Port of
`kungfu_tpu/models/mlp.py`.

Weights keep the JAX layout, (in, out) applied as ``x @ w``, so the two
packages trade them leaf for leaf (`models/convert.py::mlp_from_jax`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from kungfu_tpu_torch import resolve_device


class MLP(nn.Module):
    """The SLP (leaves ``w``, ``b``) or, with a hidden layer, the MLP
    (``w1``, ``b1``, ``w2``, ``b2``); `tree()` gives the JAX dict."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.leaves = nn.ParameterDict({k: nn.Parameter(v) for k, v in params.items()})

    def tree(self) -> Dict[str, torch.Tensor]:
        return dict(self.leaves.items())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(self.tree(), x)


def init_mlp(generator: Optional[torch.Generator] = None, in_dim: int = 784,
             hidden: int = 0, out_dim: int = 10, device=None) -> MLP:
    """hidden=0 gives the single-layer perceptron. Weights are
    N(0, 1/fan_in), drawn on the CPU from `generator`, then moved to
    `device` (None = the CUDA card)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(fan_in, fan_out):
        return torch.randn(fan_in, fan_out, generator=g) / math.sqrt(fan_in)

    if hidden:
        params = {"w1": normal(in_dim, hidden), "b1": torch.zeros(hidden),
                  "w2": normal(hidden, out_dim), "b2": torch.zeros(out_dim)}
    else:
        params = {"w": normal(in_dim, out_dim), "b": torch.zeros(out_dim)}
    return MLP(params).to(device)


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "w1" in params:
        h = torch.relu(x @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]
    return x @ params["w"] + params["b"]


def mlp_loss(params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits against integer labels."""
    x, y = batch
    return F.cross_entropy(mlp_apply(params, x), y.long())
