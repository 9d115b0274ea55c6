"""Carry parameters between the JAX package and the port.

Transformer: the JAX parameter tree (`init_transformer` there) is a nested
dict with layer-stacked leaves; the port keeps the same tree
(`Transformer.tree()`), so conversion is a leaf-by-leaf copy through numpy.
MLP: the same leaves. ResNet: flax's names are the port's module names,
and conv kernels turn from HWIO to OIHW. No JAX import: the caller hands
over trees with their leaves already as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from kungfu_tpu_torch.models.mlp import MLP
from kungfu_tpu_torch.models.transformer import LAYER_KEYS, Transformer, TransformerConfig

TOP_KEYS = ("embed", "pos_embed", "ln_f_scale")


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def transformer_params_from_jax(tree: Mapping) -> Dict:
    """JAX param tree (numpy leaves) -> the port's nested dict of f32 CPU
    tensors, ready for `Transformer(cfg, params)`."""
    return {
        **{k: _f32(tree[k]) for k in TOP_KEYS},
        "layers": {k: _f32(tree["layers"][k]) for k in LAYER_KEYS},
    }


def transformer_from_jax(tree: Mapping, cfg: TransformerConfig, device) -> Transformer:
    return Transformer(cfg, transformer_params_from_jax(tree)).to(device)


def to_jax(tree) -> Dict:
    """The port's param tree (a Transformer, or a nested dict of tensors such
    as the grads) -> the JAX tree's layout with numpy leaves."""
    if isinstance(tree, Transformer):
        tree = tree.tree()

    def leaf(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {
        **{k: leaf(tree[k]) for k in TOP_KEYS},
        "layers": {k: leaf(tree["layers"][k]) for k in LAYER_KEYS},
    }


def grads_to_jax(model: Transformer) -> Dict:
    """The .grad of every parameter of `model`, in the JAX tree's layout."""
    t = model.tree()
    return to_jax({
        **{k: t[k].grad for k in TOP_KEYS},
        "layers": {k: t["layers"][k].grad for k in LAYER_KEYS},
    })


def _flat(tree: Mapping, prefix: str = ""):
    for key, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flat(v, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", v


def mlp_from_jax(tree: Mapping, device) -> MLP:
    """JAX MLP params (numpy leaves w, b or w1, b1, w2, b2) -> the port's MLP."""
    return MLP({k: _f32(v) for k, v in tree.items()}).to(device)


def resnet_from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """flax ResNet `params` and `batch_stats` (numpy leaves) -> a state dict
    of f32 CPU tensors for `ResNet.load_state_dict`: each conv kernel HWIO
    -> OIHW, every other leaf as it is (norm scale/bias, running mean/var,
    the head's (in, out) kernel and bias)."""
    out = {}
    for name, v in list(_flat(params)) + list(_flat(batch_stats)):
        t = _f32(v)
        out[name] = t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t
    return out


def resnet_to_jax(state: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The inverse of `resnet_from_jax`: a mapping of the port's names to
    tensors (`model.state_dict()`, or each parameter's .grad by name) ->
    (params, batch_stats) in flax's nested layout with numpy f32 leaves."""
    trees: Tuple[Dict, Dict] = ({}, {})
    for name, t in state.items():
        *path, leaf = name.split(".")
        a = t.detach().to("cpu", torch.float32)
        if a.dim() == 4:
            a = a.permute(2, 3, 1, 0)
        node = trees[leaf in ("mean", "var")]
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a.contiguous().numpy()
    return trees
