"""Decoder-only transformer LM (dense path), port of
`kungfu_tpu/models/transformer.py`.

Parameters keep the JAX package's layout so the two packages can trade
them through numpy (`models/convert.py`): weights are (in, out) and applied
as ``x @ w``, the per-layer leaves are stacked on a leading layer axis, and
the LM head is the tied embedding. Params are f32; compute runs in
``cfg.dtype`` (bf16 by default) with the same casts, in the same order, as
the JAX functions, so a bf16 model here rounds where the JAX one does.

The attention core is pluggable: ``full_attention_core`` by default,
`ops.flash_attention.flash_attention` for the fused kernels. The
sequence-parallel path (`make_ring_transformer_loss`) runs the same block
per sequence shard with a ring attention core (`ops/ring_attention.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from kungfu_tpu_torch import resolve_device
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.ops.ring_attention import ring_self_attention

LAYER_KEYS = ("ln1_scale", "ln2_scale", "wqkv", "wo", "w_in", "w_out")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 512
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} not divisible by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @classmethod
    def bert_base(cls) -> "TransformerConfig":
        return cls(vocab_size=30522, d_model=768, n_heads=12, n_layers=12,
                   d_ff=3072, max_seq=512)

    @classmethod
    def tiny(cls) -> "TransformerConfig":
        return cls(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                   d_ff=128, max_seq=64)


class Transformer(nn.Module):
    """Holds the parameters (f32) in the JAX tree's layout; `tree()` gives
    the nested dict the functions below take."""

    def __init__(self, cfg: TransformerConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(params["embed"])
        self.pos_embed = nn.Parameter(params["pos_embed"])
        self.ln_f_scale = nn.Parameter(params["ln_f_scale"])
        self.layers = nn.ParameterDict(
            {name: nn.Parameter(params["layers"][name]) for name in LAYER_KEYS}
        )

    def tree(self) -> Dict:
        return {
            "embed": self.embed,
            "pos_embed": self.pos_embed,
            "ln_f_scale": self.ln_f_scale,
            "layers": {name: self.layers[name] for name in LAYER_KEYS},
        }


def init_transformer(cfg: TransformerConfig, generator: Optional[torch.Generator] = None,
                     device=None) -> Transformer:
    """A Transformer with N(0, 0.02) weights and unit norm scales, drawn
    on the CPU from `generator` (so a seed gives the same model on every
    device), then moved to `device` (None = the CUDA card)."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    L, D = cfg.n_layers, cfg.d_model

    def dense(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    params = {
        "embed": dense(cfg.vocab_size, D),
        "pos_embed": dense(cfg.max_seq, D),
        "ln_f_scale": torch.ones(D),
        "layers": {
            "ln1_scale": torch.ones(L, D),
            "ln2_scale": torch.ones(L, D),
            "wqkv": dense(L, D, 3 * D),
            "wo": dense(L, D, D),
            "w_in": dense(L, D, cfg.d_ff),
            "w_out": dense(L, cfg.d_ff, D),
        },
    }
    return Transformer(cfg, params).to(device)


def param_pspecs(cfg: TransformerConfig, tp_axis: str = "tp") -> Dict:
    """The sharding of each leaf (`kungfu_tpu/models/transformer.py::param_pspecs`):
    per dimension, the mesh axis it is split over, or None; () for a
    replicated leaf. Column-parallel wqkv and w_in (output features over
    tp), row-parallel wo and w_out (input features over tp), the
    embedding over vocab. wqkv's columns split per head only in the
    order `models.convert.tp_layout` gives them."""
    t = tp_axis
    return {
        "embed": (t, None),
        "pos_embed": (),
        "ln_f_scale": (),
        "layers": {
            "ln1_scale": (None,),
            "ln2_scale": (None,),
            "wqkv": (None, None, t),
            "wo": (None, t, None),
            "w_in": (None, None, t),
            "w_out": (None, t, None),
        },
    }


def _rmsnorm(x, scale, eps: float = 1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def full_attention_core(q, k, v):
    """(B, H, S, hd) q/k/v -> causal attention context, same shape."""
    hd, S = q.shape[-1], q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.tensor(
        math.sqrt(hd), dtype=q.dtype)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _attention(x, wqkv, wo, cfg: TransformerConfig, core=full_attention_core):
    """QKV projection + head reshape around a pluggable (q, k, v) -> ctx
    core. The fused QKV splits into contiguous thirds; their width (D, or
    D / tp for a tensor-parallel shard in `tp_layout`'s order) sets the heads."""
    B, S, _ = x.shape
    width, hd = wqkv.shape[-1] // 3, cfg.head_dim
    q, k, v = (x @ wqkv).split(width, dim=-1)
    q, k, v = (t.reshape(B, S, width // hd, hd).transpose(1, 2) for t in (q, k, v))
    ctx = core(q, k, v)
    return ctx.transpose(1, 2).reshape(B, S, width) @ wo


def _same(x):
    return x


def _block(x, layer, cfg: TransformerConfig, core=full_attention_core,
           enter=_same, leave=_same):
    """One pre-norm block. `enter` and `leave` bracket the two products
    that tensor parallelism shards (`collective.copy_to_group` before the
    column-parallel wqkv and w_in, `reduce_from_group` after the
    row-parallel wo and w_out); the identity for a dense block."""
    dt = cfg.dtype
    x = x + leave(_attention(enter(_rmsnorm(x, layer["ln1_scale"])), layer["wqkv"].to(dt),
                             layer["wo"].to(dt), cfg, core=core))
    h = enter(_rmsnorm(x, layer["ln2_scale"]))
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h @ layer["w_in"].to(dt), approximate="tanh")
    return x + leave(h @ layer["w_out"].to(dt))


def lm_head_loss(params, x, targets, cfg: TransformerConfig):
    """Final norm + tied-embedding LM head (f32) + next-token cross-entropy
    on hidden states `x` (..., S, D)."""
    h = _rmsnorm(x, params["ln_f_scale"])
    logits = h.float() @ params["embed"].float().T
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def transformer_hidden(params, tokens, cfg: TransformerConfig, core=None):
    """tokens (B, S) int -> final hidden states (B, S, D) pre-norm."""
    core = core or full_attention_core
    S = tokens.shape[1]
    if S > cfg.max_seq:
        raise ValueError(f"sequence {S} exceeds max_seq {cfg.max_seq}")
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens.long()] + params["pos_embed"].to(dt)[:S]
    return apply_layers(x, params, cfg, core)


def apply_layers(x, params, cfg: TransformerConfig, core, enter=_same, leave=_same):
    """Every layer of the stack `params["layers"]` (all of the model's, or
    a pipeline stage's slice) in order."""
    # one unbind per stacked leaf: its backward writes each layer's gradient
    # into the stacked grad once (indexing layer by layer would accumulate
    # a full-size zero-padded gradient per layer)
    per_layer = {name: params["layers"][name].unbind(0) for name in LAYER_KEYS}
    for i in range(len(per_layer["wqkv"])):
        x = _block(x, {name: per_layer[name][i] for name in LAYER_KEYS}, cfg, core=core,
                   enter=enter, leave=leave)
    return x


def transformer_apply(params, tokens, cfg: TransformerConfig, core=None):
    """tokens (B, S) int -> logits (B, S, V) in f32."""
    x = transformer_hidden(params, tokens, cfg, core=core)
    x = _rmsnorm(x, params["ln_f_scale"])
    return x.float() @ params["embed"].float().T


def transformer_loss(params, batch, cfg: TransformerConfig, core=None):
    """Next-token cross-entropy. batch = tokens (B, S+1) or (tokens, targets)."""
    if isinstance(batch, (tuple, list)):
        tokens, targets = batch
    else:
        tokens, targets = batch[:, :-1], batch[:, 1:]
    x = transformer_hidden(params, tokens, cfg, core=core)
    return lm_head_loss(params, x, targets, cfg)


# ---------------------------------------------------------------------------
# sequence-parallel (ring attention) path: the long-context mode. Each rank
# runs the whole forward on its (B, S_local) shard: embedding, norms and FFN
# are pointwise over positions, so only attention crosses shards, as the K/V
# ring of ops/ring_attention.py. Activation memory per rank scales with
# S / sp instead of S.
# ---------------------------------------------------------------------------


def ring_transformer_apply_shard(params, tokens, cfg: TransformerConfig, session,
                                 sp_axis: str = "sp", core=None):
    """tokens (B, S_local) int: this rank's chunk of the sequence, chunk i
    on index i of the session's `sp_axis`. Returns the shard's pre-norm
    hidden states (B, S_local, D); feed them to `lm_head_loss`. `core` is
    a ring attention function (q, k, v, group, causal) ->
    context, `ops.ring_attention.ring_self_attention` by default."""
    core = core or ring_self_attention
    Sl = tokens.shape[1]
    sp_size = session.axis_size(sp_axis)
    if sp_size * Sl > cfg.max_seq:
        raise ValueError(f"global sequence {sp_size * Sl} exceeds max_seq {cfg.max_seq}")
    dt = cfg.dtype
    start = session.axis_index(sp_axis) * Sl
    x = params["embed"].to(dt)[tokens.long()] + params["pos_embed"][start:start + Sl].to(dt)
    group = session.axis_group(sp_axis)

    def ring_core(q, k, v):
        return core(q, k, v, group, causal=True)

    return apply_layers(x, params, cfg, ring_core)


def make_ring_transformer_loss(cfg: TransformerConfig, session, sp_axis: str = "sp",
                               dp_axis: str = "dp", core=None):
    """Sequence-parallel causal-LM loss over a `dp_axis` x `sp_axis` mesh
    that is the session's whole world. Returns loss_fn(model, (tokens,
    targets)) -> this rank's loss on its (B / dp, S / sp) shard (from
    `parallel.dp.shard_batch(batch, session, axes=(dp_axis, sp_axis))`),
    local and differentiable.

    JAX's pmean over sp, then dp, is the mean over the world, which
    `make_train_step` takes; every shard holds as many tokens. The
    gradients need no rescaling either: each rank backpropagates its own
    loss, and the ring's backward hands rank j the gradient of every rank's
    loss through rank j's activations, so S-SGD's world average is the
    gradient of the mean loss."""
    if session.axis_size(dp_axis) * session.axis_size(sp_axis) != session.size:
        raise ValueError(f"mesh {session.shape} is not {dp_axis} x {sp_axis} over "
                         f"the session's {session.size} ranks")

    def loss_fn(model, batch):
        tokens, targets = batch
        params = model.tree()
        x = ring_transformer_apply_shard(params, tokens, cfg, session, sp_axis, core)
        return lm_head_loss(params, x, targets, cfg)

    return loss_fn


# ---------------------------------------------------------------------------
# tensor-parallel path (Megatron-style). The port has no SPMD partitioner, so
# the collectives JAX's partitioner derives from `param_pspecs` are written
# out: the identity forward with a summed backward before each column-
# parallel product, and a sum forward after each row-parallel one. Each
# rank of the tp group holds H / tp heads, d_ff / tp hidden units and V / tp
# rows of the embedding, and every rank of the group computes the same loss.
# ---------------------------------------------------------------------------


def _tp_embed(embed, tokens, group, dt):
    """Vocab-parallel lookup: rows outside this rank's range give zero,
    and the sum over the group holds every token's row."""
    vl = embed.shape[0]
    local = tokens.long() - collective.world_rank(group) * vl
    mine = (local >= 0) & (local < vl)
    rows = embed.to(dt)[local.clamp(0, vl - 1)]
    return collective.reduce_from_group(torch.where(mine[..., None], rows, 0), group)


def tp_lm_head_loss(params, x, targets, cfg: TransformerConfig, group):
    """`lm_head_loss` with the tied head vocab-parallel in f32: each rank
    forms the logits of its V / tp rows, and the log-softmax takes the
    all-reduced max, sum of exponentials and target logit, so no rank
    holds the whole embedding or the whole logits."""
    emb = params["embed"]
    vl = emb.shape[0]
    h = collective.copy_to_group(_rmsnorm(x, params["ln_f_scale"]), group)
    logits = h.float() @ emb.float().T
    m = collective.all_reduce(logits.detach().amax(-1), ReduceOp.MAX, group)
    sumexp = collective.reduce_from_group(torch.exp(logits - m[..., None]).sum(-1), group)
    local = targets.long() - collective.world_rank(group) * vl
    mine = (local >= 0) & (local < vl)
    tgt = logits.gather(-1, local.clamp(0, vl - 1)[..., None])[..., 0]
    tgt = collective.reduce_from_group(torch.where(mine, tgt, 0), group)
    return (torch.log(sumexp) + m - tgt).mean()


def tp_transformer_loss(params, batch, cfg: TransformerConfig, session, tp_axis: str = "tp",
                        sp_axis: Optional[str] = None, core=None):
    """Causal-LM loss of a tensor-parallel shard of the parameters
    (`models.convert.tp_layout`, then split by `param_pspecs`) on this rank's (tokens,
    targets). With `sp_axis`, tokens are this rank's (B, S / sp) chunk of
    the sequence, chunk i on index i of the axis, and attention is a ring
    over the sp group (`core`: a ring core (q, k, v, group, causal),
    `ring_self_attention` by default); without it `core` is a dense core
    (q, k, v), full attention by default. Returns this rank's loss, the
    same on every rank of its tp group."""
    tokens, targets = batch
    group = session.axis_group(tp_axis)
    dt = cfg.dtype
    S = tokens.shape[1]
    start = 0
    if sp_axis is not None:
        ring = core or ring_self_attention
        sp_group = session.axis_group(sp_axis)
        start = session.axis_index(sp_axis) * S
        if session.axis_size(sp_axis) * S > cfg.max_seq:
            raise ValueError(f"global sequence {session.axis_size(sp_axis) * S} exceeds "
                             f"max_seq {cfg.max_seq}")

        def core(q, k, v):
            return ring(q, k, v, sp_group, causal=True)
    elif S > cfg.max_seq:
        raise ValueError(f"sequence {S} exceeds max_seq {cfg.max_seq}")
    x = _tp_embed(params["embed"], tokens, group, dt) + params["pos_embed"][start:start + S].to(dt)
    x = apply_layers(x, params, cfg, core or full_attention_core,
                enter=lambda t: collective.copy_to_group(t, group),
                leave=lambda t: collective.reduce_from_group(t, group))
    return tp_lm_head_loss(params, x, targets, cfg, group)
