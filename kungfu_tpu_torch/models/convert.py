"""Carry parameters between the JAX package and the port.

Transformer: the JAX parameter tree (`init_transformer` there) is a nested
dict with layer-stacked leaves; the port keeps the same tree
(`Transformer.tree()`), so conversion is a leaf-by-leaf copy through numpy.
A pipeline stage holds a contiguous slice of the layer stack
(`pp_stage`, `pp_unstage`); a tensor-parallel rank holds its shards
(`tp_layout` orders wqkv by heads, `shard_tree` cuts any tree by its
specs, `tp_shard`, `tp_unshard`); an expert-parallel rank its block of the
expert stack (`ep_shard`, `ep_unshard`).
MLP: the same leaves. ResNet: flax's names are the port's module names,
and conv kernels turn from HWIO to OIHW. No JAX import: the caller hands
over trees with their leaves already as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

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


def pp_stage(tree: Mapping, stage: int, n_stages: int) -> Dict:
    """Stage `stage`'s parameters of a pipeline of `n_stages`: the
    replicated leaves whole, layers [stage L/P, (stage+1) L/P) of each
    stacked leaf. Leaves are numpy arrays or tensors; returns f32 tensors."""
    L = len(tree["layers"]["wqkv"])
    per = L // n_stages
    return {**{k: _f32(tree[k]) for k in TOP_KEYS},
            "layers": {k: _f32(tree["layers"][k][stage * per:(stage + 1) * per])
                       for k in LAYER_KEYS}}


def pp_unstage(stages: Sequence[Mapping]) -> Dict:
    """Every stage's tree in the JAX tree's layout (numpy leaves, `to_jax`
    of each) -> one tree: the layer stack concatenated in stage order, the
    replicated leaves taken from stage 0."""
    return {**{k: stages[0][k] for k in TOP_KEYS},
            "layers": {k: np.concatenate([s["layers"][k] for s in stages])
                       for k in LAYER_KEYS}}


def tp_layout(tree: Dict, tp: int) -> Dict:
    """The tree with each wqkv's columns reordered for `tp` shards: JAX's
    [q | k | v] becomes [q_0 k_0 v_0 | q_1 k_1 v_1 | ...], where q_r is
    columns [r D/tp, (r+1) D/tp) of q. A contiguous split of the last
    axis into tp parts then gives rank r q, k and v of heads
    [r H/tp, (r+1) H/tp): a head shard, which JAX's contiguous split of
    [q | k | v] is not (at tp 2 rank 0 would hold all of q)."""
    wqkv = tree["layers"]["wqkv"]
    L, D, _ = wqkv.shape
    out = {**tree, "layers": dict(tree["layers"])}
    out["layers"]["wqkv"] = wqkv.reshape(L, D, 3, tp, D // tp).transpose(2, 3).reshape(L, D, 3 * D)
    return out


def tp_unlayout(tree: Dict, tp: int) -> Dict:
    """The inverse of `tp_layout`: wqkv back in JAX's [q | k | v] order."""
    wqkv = tree["layers"]["wqkv"]
    L, D, _ = wqkv.shape
    out = {**tree, "layers": dict(tree["layers"])}
    out["layers"]["wqkv"] = wqkv.reshape(L, D, tp, 3, D // tp).transpose(2, 3).reshape(L, D, 3 * D)
    return out



def map_tree(fn, tree: Mapping, specs: Mapping) -> Dict:
    """fn(leaf, spec) over the leaves of a nested dict and its specs."""
    return {k: map_tree(fn, v, specs[k]) if isinstance(v, Mapping) else fn(v, specs[k])
            for k, v in tree.items()}


def shard_tree(params: Mapping, param_specs: Mapping, sizes: Mapping[str, int],
               coords: Mapping[str, int]) -> Dict:
    """The shard at mesh coordinates `coords` (axis -> index, axis sizes in
    `sizes`) of each leaf of a nested dict: every dimension that its spec
    names an axis for is cut into that axis's size of contiguous blocks,
    and block `coords[axis]` is kept."""
    def shard(t, spec):
        for dim, name in enumerate(spec):
            if name is not None:
                n = sizes[name]
                if t.shape[dim] % n:
                    raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split "
                                     f"over {n} ranks of axis {name!r}")
                per = t.shape[dim] // n
                t = t.narrow(dim, coords[name] * per, per)
        return t.contiguous()

    return map_tree(shard, params, param_specs)


def tp_shard(tree: Mapping, specs: Mapping, rank: int, tp: int, tp_axis: str = "tp") -> Dict:
    """A tensor-parallel rank's shards of a JAX tree: wqkv reordered by
    `tp_layout` (so its blocks are head shards), then cut by `specs`
    (`param_pspecs`) into `tp` blocks, of which the rank keeps block
    `rank`."""
    return shard_tree(tp_layout(transformer_params_from_jax(tree), tp), specs,
                      {tp_axis: tp}, {tp_axis: rank})


def tp_unshard(shards: Sequence[Mapping], specs: Mapping) -> Dict:
    """Every tp rank's tree of shards (numpy leaves, in rank order) -> the
    whole tree in JAX's layout: sharded leaves concatenated along their
    split dimension, replicated ones from rank 0, wqkv back from
    `tp_layout`."""
    def join(parts, spec):
        dims = [d for d, name in enumerate(spec) if name is not None]
        return np.concatenate(parts, axis=dims[0]) if dims else parts[0]

    tree = {**{k: torch.from_numpy(join([s[k] for s in shards], specs[k])) for k in TOP_KEYS},
            "layers": {k: torch.from_numpy(join([s["layers"][k] for s in shards],
                                                specs["layers"][k]))
                       for k in LAYER_KEYS}}
    return to_jax(tp_unlayout(tree, len(shards)))


def ep_shard(stack, rank: int, epd: int) -> torch.Tensor:
    """Rank `rank`'s block of a global expert stack (E, ...): experts
    [rank epd, (rank+1) epd), as f32."""
    return _f32(stack[rank * epd:(rank + 1) * epd])


def ep_unshard(blocks: Sequence) -> np.ndarray:
    """Every rank's block of an expert stack, in rank order -> the global
    stack (E, ...) as numpy f32."""
    return np.concatenate([np.asarray(b, dtype=np.float32) for b in blocks])


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
