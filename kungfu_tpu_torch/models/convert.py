"""Carry transformer parameters between the JAX package and the port.

The JAX parameter tree (`init_transformer` there) is a nested dict with
layer-stacked leaves; the port keeps the same tree (`Transformer.tree()`),
so conversion is a leaf-by-leaf copy through numpy. No JAX import: the
caller hands over the tree with its leaves already as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from kungfu_tpu_torch.models.transformer import LAYER_KEYS, Transformer, TransformerConfig

TOP_KEYS = ("embed", "pos_embed", "ln_f_scale")


def transformer_params_from_jax(tree: Mapping) -> Dict:
    """JAX param tree (numpy leaves) -> the port's nested dict of f32 CPU
    tensors, ready for `Transformer(cfg, params)`."""
    def leaf(x):
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))

    return {
        **{k: leaf(tree[k]) for k in TOP_KEYS},
        "layers": {k: leaf(tree["layers"][k]) for k in LAYER_KEYS},
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
