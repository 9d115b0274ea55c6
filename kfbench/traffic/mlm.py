"""Masked-LM batches: structured token streams (a random start, then
random steps of 0-16 through the vocabulary, so neighbouring tokens
correlate), with a share of the positions replaced by [MASK] (id 3) and
scored. The stream is the one of the program's
`examples/bert_ssgd.synthetic_batch`, drawn for the whole pool at once.

Parameters (a workload's "traffic"): batch (sequences a rank trains on a
step), seq (tokens a sequence), pool (distinct batches staged, taken in
turn), mask_frac (share of positions masked)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from kfbench.reference import common

MASK_ID = 3
FIRST_ID = 4  # ids below are special tokens


def pool(traffic: Dict, cfg: Dict, seed: int, rank: int, device) -> Tuple[torch.Tensor, ...]:
    """(inputs, targets, mask), each (pool, batch, seq), of `rank`."""
    n, b, s, vocab = traffic["pool"], traffic["batch"], traffic["seq"], cfg["vocab_size"]
    rng = np.random.default_rng(common.derive_seed(seed, rank, 12))
    base = rng.integers(FIRST_ID, vocab, size=(n * b, 1))
    drift = rng.integers(0, 17, size=(n * b, s))
    tokens = (base + np.cumsum(drift, axis=1)) % (vocab - FIRST_ID) + FIRST_ID
    mask = rng.random((n * b, s)) < traffic["mask_frac"]
    inputs = np.where(mask, MASK_ID, tokens)
    return tuple(torch.from_numpy(a.reshape(n, b, s)).to(device)
                 for a in (inputs.astype(np.int32), tokens.astype(np.int32), mask))
