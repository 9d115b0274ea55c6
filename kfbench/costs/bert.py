"""Transformer training costs: the projections and feed-forward (bf16),
the tied head (f32, counted like the rest), causal attention's two
products over the live (query, key) pairs; the three flash kernels'
least times, each input byte read once and each output written once."""

from __future__ import annotations

from typing import Dict

from kfbench import peaks

BF16, F32 = 2, 4


def flash_bounds(bh: int, s: int, hd: int, causal: bool = True) -> Dict[str, float]:
    """Least seconds of one launch of each flash kernel over (bh, s, hd)."""
    t = bh * s * hd * BF16  # one (B*H, S, hd) tensor
    row = bh * s * F32  # one (B*H, S) f32 tensor
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    mm = 2 * hd * pairs  # one (S x S x hd) product over the live pairs
    return {
        "flash_fwd": peaks.bound_s(2 * mm, 4 * t + row),  # q k v -> o, lse
        "flash_dq": peaks.bound_s(3 * mm, 6 * t + 2 * row),  # q k v o dO lse -> dq delta
        "flash_dkv": peaks.bound_s(4 * mm, 6 * t + 2 * row),  # q k v dO lse delta -> dk dv
    }


def costs(cfg: Dict, traffic: Dict) -> Dict[str, float]:
    b, s = traffic["batch"], traffic["seq"]
    L, D, Fd, V = (cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"],
                   cfg["vocab_size"])
    H = cfg["num_attention_heads"]
    tokens = b * s
    linear = 2 * tokens * L * (3 * D * D + D * D + 2 * D * Fd)
    head = 2 * tokens * D * V
    attention = 2 * 2 * b * H * (s * (s + 1) // 2) * (D // H) * L
    fl = flash_bounds(b * H, s, D // H)
    return {
        "train_flops": 3 * (linear + head + attention),
        "flash_fwd_bound_s": L * fl["flash_fwd"],
        "flash_bwd_bound_s": L * (fl["flash_dq"] + fl["flash_dkv"]),
    }
