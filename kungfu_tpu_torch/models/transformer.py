"""Decoder-only transformer LM (dense path), port of
`kungfu_tpu/models/transformer.py`.

Parameters keep the JAX package's layout so the two packages can trade
them through numpy (`models/convert.py`): weights are (in, out) and applied
as ``x @ w``, the per-layer leaves are stacked on a leading layer axis, and
the LM head is the tied embedding. Params are f32; compute runs in
``cfg.dtype`` (bf16 by default) with the same casts, in the same order, as
the JAX functions, so a bf16 model here rounds where the JAX one does.

The attention core is pluggable: ``_full_attention_core`` by default,
`ops.flash_attention.flash_attention` for the fused kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from kungfu_tpu_torch import resolve_device

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


def _rmsnorm(x, scale, eps: float = 1e-6):
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _full_attention_core(q, k, v):
    """(B, H, S, hd) q/k/v -> causal attention context, same shape."""
    hd, S = q.shape[-1], q.shape[2]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / torch.tensor(
        math.sqrt(hd), dtype=q.dtype)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _attention(x, wqkv, wo, cfg: TransformerConfig, core=_full_attention_core):
    """QKV projection + head reshape around a pluggable (q, k, v) -> ctx
    core. The fused QKV splits into contiguous thirds."""
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = (x @ wqkv).split(D, dim=-1)
    q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
    ctx = core(q, k, v)
    return ctx.transpose(1, 2).reshape(B, S, D) @ wo


def _block(x, layer, cfg: TransformerConfig, core=_full_attention_core):
    dt = cfg.dtype
    x = x + _attention(_rmsnorm(x, layer["ln1_scale"]), layer["wqkv"].to(dt),
                       layer["wo"].to(dt), cfg, core=core)
    h = _rmsnorm(x, layer["ln2_scale"])
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(h @ layer["w_in"].to(dt), approximate="tanh")
    return x + h @ layer["w_out"].to(dt)


def lm_head_loss(params, x, targets, cfg: TransformerConfig):
    """Final norm + tied-embedding LM head (f32) + next-token cross-entropy
    on hidden states `x` (..., S, D)."""
    h = _rmsnorm(x, params["ln_f_scale"])
    logits = h.float() @ params["embed"].float().T
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def transformer_hidden(params, tokens, cfg: TransformerConfig, core=None):
    """tokens (B, S) int -> final hidden states (B, S, D) pre-norm."""
    core = core or _full_attention_core
    S = tokens.shape[1]
    if S > cfg.max_seq:
        raise ValueError(f"sequence {S} exceeds max_seq {cfg.max_seq}")
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens.long()] + params["pos_embed"].to(dt)[:S]
    # one unbind per stacked leaf: its backward writes each layer's gradient
    # into the stacked grad once (indexing layer by layer would accumulate
    # a full-size zero-padded gradient per layer)
    per_layer = {name: params["layers"][name].unbind(0) for name in LAYER_KEYS}
    for i in range(cfg.n_layers):
        x = _block(x, {name: per_layer[name][i] for name in LAYER_KEYS}, cfg, core=core)
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
