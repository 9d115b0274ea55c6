"""BERT-base masked-LM pretraining under synchronous SGD, on the card.

Port of `examples/bert_sma.py` (BASELINE config 3) for this package: the
flagship transformer at BERT-base width (`TransformerConfig.bert_base()`)
with the fused flash-attention kernels as its attention core, trained by
S-SGD over AdamW (gradients averaged over the data-parallel world before
each step). The SMA blend of the JAX example travels over the host plane,
which this package does not have yet; on one worker it is a no-op.

Run on one card:

  python -m kungfu_tpu_torch.examples.bert_ssgd --config bert-base --steps 8 --batch 8

On the CPU at a small size:

  python -m kungfu_tpu_torch.examples.bert_ssgd --device cpu --steps 5 --batch 4
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from kungfu_tpu_torch.initializer import broadcast_variables
from kungfu_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    init_transformer,
    transformer_apply,
)
from kungfu_tpu_torch.ops.flash_attention import flash_attention
from kungfu_tpu_torch.optimizers.core import synchronous_sgd
from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
from kungfu_tpu_torch.parallel.dp import make_train_step, shard_batch
from kungfu_tpu_torch.parallel.mesh import make_mesh

MASK_FRAC = 0.15


def synthetic_batch(rng, cfg, batch, seq):
    """Synthetic masked-LM batch: structured token streams (skip-gram-ish
    correlations) so the loss has real signal to fit."""
    base = rng.integers(4, cfg.vocab_size, size=(batch, 1))
    drift = rng.integers(0, 17, size=(batch, seq))
    tokens = (base + np.cumsum(drift, axis=1)) % (cfg.vocab_size - 4) + 4
    mask = rng.random((batch, seq)) < MASK_FRAC
    inputs = np.where(mask, 3, tokens)  # 3 = [MASK]
    return inputs.astype(np.int32), tokens.astype(np.int32), mask


def mlm_loss(params, inputs, targets, mask, cfg, core=None):
    logits = transformer_apply(params, inputs, cfg, core=core)
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok_logp = logp.gather(-1, targets[..., None].long())[..., 0]
    maskf = mask.float()
    return -(tok_logp * maskf).sum() / maskf.sum().clamp_min(1.0)


def flash_core(q, k, v):
    return flash_attention(q, k, v, causal=True)


def config(name: str) -> TransformerConfig:
    return TransformerConfig.bert_base() if name == "bert-base" else TransformerConfig.tiny()


def make_model(cfg: TransformerConfig, seed: int, device) -> Transformer:
    return init_transformer(cfg, torch.Generator().manual_seed(seed), device)


def batches(cfg: TransformerConfig, batch: int, seq: int, seed: int) -> Iterator:
    """The global batches of a run, as CPU tensors (inputs, targets, mask)."""
    rng = np.random.default_rng(1234 + seed)
    while True:
        yield tuple(torch.from_numpy(a) for a in synthetic_batch(rng, cfg, batch, seq))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=["tiny", "bert-base"], default="tiny")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=16, help="global batch")
    p.add_argument("--seq", type=int, default=0, help="0 = config max_seq")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--fixed-batch", action="store_true",
                   help="train on the first batch at every step: the loss then "
                        "falls within a few steps, which a fresh batch per "
                        "step hides under batch-to-batch noise")
    return p.parse_args(argv)


class Trainer:
    """Everything a run sets up: the device world, the model, the S-SGD step
    and the batch stream. `train(n)` takes n steps."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.cfg = cfg = config(args.config)
        self.seq = args.seq or min(cfg.max_seq, 128 if args.config == "tiny" else 512)
        self.device = initialize_device_plane(args.device)
        self.session = make_mesh(self.device)
        self.model = broadcast_variables(make_model(cfg, args.seed, self.device), self.session)
        opt = synchronous_sgd(
            torch.optim.AdamW(self.model.parameters(), lr=args.lr, weight_decay=0.01),
            self.session,
        )

        def loss_fn(model, batch):
            inputs, targets, mask = batch
            return mlm_loss(model.tree(), inputs, targets, mask, cfg, core=flash_core)

        self.step = make_train_step(loss_fn, opt, self.session)
        self.data = batches(cfg, args.batch, self.seq, args.seed)
        self.batch = None
        self.steps_done = 0

    def train(self, steps: int) -> Dict[str, List[float]]:
        losses: List[float] = []
        step_ms: List[float] = []
        for _ in range(steps):
            if self.batch is None or not self.args.fixed_batch:
                self.batch = shard_batch(next(self.data), self.session)
            t0 = time.perf_counter()
            loss = float(self.step(self.model, self.batch))  # waits for the device
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            if self.session.rank == 0:
                print(f"step {self.steps_done} loss {loss:.4f} ({step_ms[-1]:.1f} ms, "
                      f"np={self.session.size})", flush=True)
            self.steps_done += 1
        return {"losses": losses, "step_ms": step_ms}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Train; returns the per-step losses and times of this rank."""
    args = parse_args(argv)
    trainer = Trainer(args)
    out = trainer.train(args.steps)
    steady = out["step_ms"][1:] or out["step_ms"]
    return {
        "config": args.config,
        "batch": args.batch,
        "seq": trainer.seq,
        "world": trainer.session.size,
        "device": str(trainer.device),
        **out,
        "tokens_per_s": args.batch * trainer.seq / (float(np.median(steady)) / 1e3),
    }


if __name__ == "__main__":
    main()
