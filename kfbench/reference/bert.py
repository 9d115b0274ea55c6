"""The program's transformer block at BERT-base widths, in plain float32
PyTorch: learned positions added to the token embedding, pre-norm blocks
of RMSNorm (eps 1e-6), fused QKV split into thirds, causal softmax
attention scaled by 1/sqrt(head dim), the tanh approximation of GELU, no
biases, a final RMSNorm and the head tied to the embedding; the masked-LM
loss is the mean negative log-likelihood of the masked positions.

Leaves are named as the program's `Transformer` names its parameters
(`embed`, `pos_embed`, `ln_f_scale`, `layers.<leaf>` stacked over the
layers, weights (in, out)). Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from kfbench.reference import common

INIT_STD = 0.02
RMS_EPS = 1e-6


def shapes(cfg: Dict) -> Dict[str, tuple]:
    L, D, Fd = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    return {
        "embed": (cfg["vocab_size"], D),
        "pos_embed": (cfg["max_position_embeddings"], D),
        "ln_f_scale": (D,),
        "layers.ln1_scale": (L, D),
        "layers.ln2_scale": (L, D),
        "layers.wqkv": (L, D, 3 * D),
        "layers.wo": (L, D, D),
        "layers.w_in": (L, D, Fd),
        "layers.w_out": (L, Fd, D),
    }


def init(cfg: Dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(parameters, no buffers): N(0, 0.02) weights drawn from `seed` on
    `device` in one call, unit norm scales."""
    shp = shapes(cfg)
    dense = [k for k in shp if not k.endswith("_scale")]
    sizes = [math.prod(shp[k]) for k in dense]
    flat = torch.randn(sum(sizes), device=device, generator=common.generator(device, seed, 0, 2))
    params = {k: part.view(shp[k]) * INIT_STD for k, part in zip(dense, flat.split(sizes))}
    params.update({k: torch.ones(s, device=device) for k, s in shp.items() if k.endswith("_scale")})
    return {k: params[k] for k in shp}, {}


def _rms(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS) * scale


def logits(cfg: Dict, p: Dict, tokens: torch.Tensor, precision=None) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S, V). `precision` (common.
    PRECISIONS) rounds the inputs and outputs of every product the program
    computes in bf16 (the projections, the feed-forward and attention's
    two products) and of its f32 tied head; "control" rounds the first to
    fp8 and the head to bf16."""
    cast, head = common.casts(precision)
    B, S = tokens.shape
    H, D = cfg["num_attention_heads"], cfg["hidden_size"]
    hd = D // H
    x = p["embed"][tokens.long()] + p["pos_embed"][:S]
    causal = torch.ones(S, S, dtype=torch.bool, device=tokens.device).tril()
    for i in range(cfg["num_hidden_layers"]):
        h = _rms(x, p["layers.ln1_scale"][i])
        q, k, v = cast(cast(h) @ cast(p["layers.wqkv"][i])).split(D, dim=-1)
        q, k, v = (t.reshape(B, S, H, hd).transpose(1, 2) for t in (q, k, v))
        s = cast(cast(q) @ cast(k).transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        ctx = cast(cast(probs) @ cast(v)).transpose(1, 2).reshape(B, S, D)
        x = x + cast(cast(ctx) @ cast(p["layers.wo"][i]))
        h = _rms(x, p["layers.ln2_scale"][i])
        h = F.gelu(cast(cast(h) @ cast(p["layers.w_in"][i])), approximate="tanh")
        x = x + cast(cast(h) @ cast(p["layers.w_out"][i]))
    return head(head(_rms(x, p["ln_f_scale"])) @ head(p["embed"]).T)


def loss(cfg: Dict, p: Dict, b: Dict, batch, precision=None) -> torch.Tensor:
    inputs, targets, mask = batch
    logp = torch.log_softmax(logits(cfg, p, inputs, precision), dim=-1)
    tok = logp.gather(-1, targets[..., None].long())[..., 0]
    maskf = mask.float()
    return -(tok * maskf).sum() / maskf.sum().clamp_min(1.0)
