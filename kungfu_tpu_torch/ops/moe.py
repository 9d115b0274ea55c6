"""Expert parallelism: top-k routed MoE FFN with all-to-all dispatch. Port
of `kungfu_tpu/ops/moe.py`.

Each rank of the process group is one shard of the expert ("ep") axis and
holds `epd` experts: E = n * epd, expert e on rank e // epd at local index
e % epd. A rank packs its tokens into per-expert capacity buckets (the
choices side by side on the slot axis, so one all-to-all carries both),
exchanges the buckets with every rank, applies its expert stack as one
batched einsum, and sends the results back the way they came. A token
over capacity is dropped: it gets zero output (the caller adds the
residual), and a top-2 token keeps whichever of its choices fit.

What must agree with the JAX function token for token:

- capacity C = max(1, int(cf * T / E)) per (shard, choice), truncated, and
  K = top_k * C slots per expert on the wire;
- a token's slot is its rank in token order among this shard's tokens that
  chose that expert at that choice (a cumulative sum of the one-hot), so
  the same tokens are dropped;
- top-k order: `lax.top_k` puts the lower index first among equal
  probabilities, as a stable descending sort does (`torch.topk` does not
  promise it);
- a dropped token adds zero into slot (0, 0): the scatter accumulates
  (`index_put` with `accumulate=True`) and never overwrites;
- top-1 keeps the raw probability as its gate, top-2 renormalizes over the
  chosen pair; GELU is the tanh approximation, as `jax.nn.gelu`;
- the switch load-balancing loss on the primary choice, averaged over the
  group, whose backward is the average of the cotangent (JAX's transpose
  of `pmean`).

The products are `torch.einsum` (cuBLAS on the card), as the JAX package
leaves them to XLA: no Pallas kernel computes them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from kungfu_tpu_torch.ops import collective


def _route(x, router_w, E: int, top_k: int, C: int):
    """(probs (T, E) f32, gates (T, top_k) f32, per choice (expert, slot,
    kept)) of this shard's tokens."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_probs, top_idx = top_probs[:, :top_k], top_idx[:, :top_k]
    gates = top_probs if top_k == 1 else top_probs / top_probs.sum(-1, keepdim=True)
    choices = []
    for j in range(top_k):
        expert = top_idx[:, j]
        onehot = F.one_hot(expert, E)
        slot = (onehot.cumsum(0) * onehot).sum(-1) - 1  # 0-based within (expert, choice)
        kept = slot < C
        choices.append((torch.where(kept, expert, 0), torch.where(kept, j * C + slot, 0), kept))
    return probs, gates, top_idx[:, 0], choices


def moe_ffn(x, router_w, w_in, w_out, group=None, top_k: int = 1,
            capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) this shard's tokens; router_w (D, E) replicated; w_in
    (epd, D, F) and w_out (epd, F, D) this rank's expert stack. Returns
    (out (T, D) in x's dtype, zero for dropped tokens; aux, the f32 switch
    loss averaged over the group). Differentiable in x and every weight."""
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    T, D = x.shape
    n = collective.world_size(group)
    epd = w_in.shape[0]
    E = n * epd
    if router_w.shape[-1] != E:
        raise ValueError(f"router width {router_w.shape[-1]} != ranks * epd = {E}")
    C = max(1, int(capacity_factor * T / E))
    K = top_k * C

    probs, gates, primary, choices = _route(x, router_w, E, top_k, C)
    send = x.new_zeros(E, K, D)
    for se, sc, kept in choices:
        send = send.index_put((se, sc), torch.where(kept[:, None], x, 0), accumulate=True)
    recv = collective.all_to_all(send.view(n, epd, K, D), group)
    h = F.gelu(torch.einsum("sjkd,jdf->sjkf", recv, w_in.to(recv.dtype)), approximate="tanh")
    y = torch.einsum("sjkf,jfd->sjkd", h, w_out.to(recv.dtype))
    back = collective.all_to_all(y, group).reshape(E, K, D)

    out = x.new_zeros(T, D)
    for j, (se, sc, kept) in enumerate(choices):
        got = torch.where(kept[:, None], back[se, sc], 0)
        out = out + got.to(x.dtype) * gates[:, j, None].to(x.dtype)

    frac = F.one_hot(primary, E).float().mean(0)
    aux = E * (frac * probs.mean(0)).sum()
    return out, collective.pmean(aux, group)


def switch_moe(x, router_w, w_in, w_out, group=None, capacity_factor: float = 1.25):
    """Top-1 switch MoE with one expert a rank: w_in (D, F), w_out (F, D).
    See `moe_ffn`."""
    return moe_ffn(x, router_w, w_in[None], w_out[None], group, top_k=1,
                   capacity_factor=capacity_factor)


def dropped_tokens(x, router_w, n_experts: int, top_k: int = 1,
                   capacity_factor: float = 1.25) -> int:
    """How many (token, choice) pairs of this shard go over capacity."""
    C = max(1, int(capacity_factor * x.shape[0] / n_experts))
    _, _, _, choices = _route(x, router_w, n_experts, top_k, C)
    return int(sum((~kept).sum() for _, _, kept in choices))


def _route_plain(x, router_w, E: int, top_k: int, C: int):
    """`_route`'s decisions made another way, for the plain oracle: (probs,
    gates, experts (T, top_k), kept (T, top_k)), the experts by a stable
    host argsort of each token's probabilities (the lower index first
    among equal ones, as `lax.top_k`), the slots by counting the tokens
    of each (expert, choice) in token order."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    order = np.argsort(-probs.detach().cpu().double().numpy(), axis=-1, kind="stable")
    order = order[:, :top_k]
    kept = np.zeros(order.shape, dtype=bool)
    for j in range(top_k):
        filled = [0] * E
        for t, e in enumerate(order[:, j].tolist()):
            kept[t, j] = filled[e] < C
            filled[e] += 1
    experts = torch.from_numpy(order).to(x.device)
    top = probs.gather(1, experts)
    gates = top if top_k == 1 else top / top.sum(-1, keepdim=True)
    return probs, gates, experts, torch.from_numpy(kept).to(x.device)


def moe_ffn_plain(xs, router_w, w_in, w_out, top_k: int = 1,
                  capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard's MoE in one process, without buckets or exchange: xs
    (n, T, D) the n shards' tokens, w_in (E, D, F) and w_out (E, F, D) all
    experts. Each shard routes its own tokens (capacity per shard, as
    `moe_ffn`, by `_route_plain`, not `moe_ffn`'s routing); each expert
    then takes the kept tokens of every shard and choice that picked it,
    as one product, so a bf16 weight gradient is rounded once, as the
    bucketed version's is. Returns (out (n, T, D), aux averaged over the
    shards): the oracle `moe_ffn` is held against on the card."""
    n, T, D = xs.shape
    E = w_in.shape[0]
    C = max(1, int(capacity_factor * T / E))
    routes = [_route_plain(x, router_w, E, top_k, C) for x in xs]
    flat = xs.reshape(n * T, D)
    out = flat.new_zeros(n * T, D)
    for e in range(E):
        idx, gate = [], []
        for s, (_, gates, experts, kept) in enumerate(routes):
            for j in range(top_k):
                rows = torch.nonzero(kept[:, j] & (experts[:, j] == e)).flatten()
                idx.append(rows + s * T)
                gate.append(gates[rows, j])
        idx, gate = torch.cat(idx), torch.cat(gate)
        if idx.numel():
            h = F.gelu(flat[idx] @ w_in[e].to(xs.dtype), approximate="tanh")
            y = h @ w_out[e].to(xs.dtype)
            out = out.index_add(0, idx, y * gate[:, None].to(xs.dtype))
    aux = [E * (F.one_hot(experts[:, 0], E).float().mean(0) * probs.mean(0)).sum()
           for probs, _, experts, _ in routes]
    return out.view(n, T, D), torch.stack(aux).mean()
