"""BERT-base masked-LM pretraining under SynchronousAveraging (SMA) over
the host plane, on the card.

Port of `examples/bert_sma.py` (BASELINE config 3): the flagship
transformer at BERT-base width (`TransformerConfig.bert_base()`: d_model
768, 12 layers, 12 heads, vocab 30522) on a masked-LM objective, with the
fused flash-attention kernels as its attention core. Every rank starts
from the same initial parameters (seed 0) and trains on its own data
(seed 1234 + rank):

- a local AdamW step (lr 3e-4, weight decay 0.01);
- then the SMA blend ``p <- p + alpha * (sum / n - p)``, the sum taken
  over the HOST collective plane (`api.group_all_reduce_arrays`, the
  reference's placement: gradients never cross the host plane, params
  do, once a step), computed in f32 in the reference's operation order.

On a card the parameters go to pinned host buffers, the sums come back,
and the blend runs on the card. A run without kfrun's environment is a
cluster of one and trains without the blend.

Run under kfrun (4 workers sharing card 0):

  python -m kungfu_tpu.runner.cli -np 4 -H 127.0.0.1:4 python3 w.py

with `w.py` calling `kungfu_tpu_torch.examples.bert_sma.main([...])`
(kfrun takes `python -m` for its own flags). One worker on one card:

  python -m kungfu_tpu_torch.examples.bert_sma --config bert-base --steps 10 --batch 8

On the CPU at a small size:

  python -m kungfu_tpu_torch.examples.bert_sma --device cpu --steps 5 --batch 4
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from kungfu_tpu_torch import api, resolve_device
from kungfu_tpu_torch.examples.bert_ssgd import (
    config,
    flash_core,
    make_model,
    mlm_loss,
    synthetic_batch,
)

# the reference's leaf order: jax.tree.flatten sorts dict keys
LEAF_ORDER = ("embed", "layers.ln1_scale", "layers.ln2_scale", "layers.w_in", "layers.w_out",
              "layers.wo", "layers.wqkv", "ln_f_scale", "pos_embed")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=["tiny", "bert-base"], default="tiny")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--seq", type=int, default=0, help="0 = config max_seq")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--alpha", type=float, default=0.1,
                   help="SMA blend weight toward the cluster average")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--fixed-batch", action="store_true",
                   help="train on the first batch at every step")
    return p.parse_args(argv)


def leaves_of(model) -> List[torch.Tensor]:
    """The parameters in the reference's flattened order."""
    tree = model.tree()
    out = []
    for name in LEAF_ORDER:
        node = tree
        for part in name.split("."):
            node = node[part]
        out.append(node)
    return out


def sma_blend(leaf: torch.Tensor, summed: torch.Tensor, alpha: torch.Tensor,
              n: torch.Tensor) -> None:
    """``leaf <- leaf + alpha * (summed / n - leaf)`` in place, each
    operation rounded in f32 on its own (`summed` is consumed); `alpha`
    and `n` are f32 scalars on the leaf's device, so no operation runs as
    a multiply by a reciprocal."""
    summed.div_(n).sub_(leaf).mul_(alpha)
    leaf.add_(summed)


class Trainer:
    """The set-up of a run (model, AdamW, the batch stream, the host
    buffers of the blend); `step()` takes one step."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.cfg = cfg = config(args.config)
        self.seq = args.seq or min(cfg.max_seq, 128 if args.config == "tiny" else 512)
        self.device = device = resolve_device(args.device)
        peer = api.get_default_peer()
        self.rank, self.n = api.current_rank(), api.cluster_size()
        if device.type == "cuda" and (args.device is None or device.index is None):
            slots = peer.config.device_slots
            device = torch.device("cuda", slots[0] if slots else
                                  api.current_local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
            self.device = device
        # distinct data per worker, the same initial model everywhere
        self.rng = np.random.default_rng(1234 + self.rank)
        self.model = make_model(cfg, 0, device)
        self.opt = torch.optim.AdamW(self.model.parameters(), lr=args.lr, weight_decay=0.01)
        self.leaves = leaves_of(self.model)
        pin = device.type == "cuda"
        # the pre-blend parameters and their cluster sums, on the host
        self.host_leaves = [torch.empty(l.numel(), dtype=l.dtype, pin_memory=pin)
                            for l in self.leaves]
        self.sums = [torch.empty(l.numel(), dtype=l.dtype, pin_memory=pin) for l in self.leaves]
        self.alpha = torch.tensor(args.alpha, dtype=torch.float32, device=device)
        self.n_t = torch.tensor(self.n, dtype=torch.float32, device=device)
        self.batch = self.draw()
        self.steps_done = 0

    def draw(self):
        return tuple(torch.from_numpy(a).to(self.device) for a in
                     synthetic_batch(self.rng, self.cfg, self.args.batch, self.seq))

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def local_step(self) -> float:
        inputs, targets, mask = self.batch
        loss = mlm_loss(self.model.tree(), inputs, targets, mask, self.cfg, core=flash_core)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        return float(loss.detach())  # waits for the device

    def blend(self) -> Dict[str, float]:
        """The SMA blend over the host plane; its times, ms."""
        t0 = time.perf_counter()
        with torch.no_grad():
            for l, h in zip(self.leaves, self.host_leaves):
                h.copy_(l.reshape(-1), non_blocking=True)
        self.sync()
        t1 = time.perf_counter()
        api.group_all_reduce_arrays(self.host_leaves, name="sma", outs=self.sums)
        t2 = time.perf_counter()
        with torch.no_grad():
            for l, s in zip(self.leaves, self.sums):
                summed = s.to(self.device, non_blocking=True, copy=True).view_as(l)
                sma_blend(l, summed, self.alpha, self.n_t)
        self.sync()
        t3 = time.perf_counter()
        return {"d2h_ms": (t1 - t0) * 1e3, "walk_ms": (t2 - t1) * 1e3,
                "h2d_blend_ms": (t3 - t2) * 1e3}

    def step(self) -> Dict:
        if self.steps_done and not self.args.fixed_batch:
            self.batch = self.draw()
        t0 = time.perf_counter()
        loss = self.local_step()
        t1 = time.perf_counter()
        rec = {"loss": loss, "local_ms": (t1 - t0) * 1e3}
        if self.n > 1:
            rec.update(self.blend())
        rec["step_ms"] = (time.perf_counter() - t0) * 1e3
        if self.rank == 0:
            print(f"step {self.steps_done} loss {loss:.4f} ({rec['step_ms']:.0f} ms, "
                  f"np={self.n})", flush=True)
        self.steps_done += 1
        return rec


def main(argv: Optional[Sequence[str]] = None,
         on_start: Optional[Callable[[Trainer], None]] = None,
         on_step: Optional[Callable[[Trainer, int, Dict], None]] = None) -> Dict:
    """Train; returns this rank's losses and step times. `on_start(trainer)`
    runs before the first step, `on_step(trainer, step, record)` after each
    step's blend."""
    args = parse_args(argv)
    trainer = Trainer(args)
    if on_start is not None:
        on_start(trainer)
    recs = []
    for step in range(args.steps):
        recs.append(trainer.step())
        if on_step is not None:
            on_step(trainer, step, recs[-1])
    losses = [r["loss"] for r in recs]
    if trainer.rank == 0:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'DECREASED' if losses[-1] < losses[0] else 'NOT DECREASED'})", flush=True)
    out = {"config": args.config, "batch": args.batch, "seq": trainer.seq, "world": trainer.n,
           "rank": trainer.rank, "device": str(trainer.device), "losses": losses,
           "params": sum(l.numel() for l in trainer.leaves)}
    for key in ("step_ms", "local_ms", "d2h_ms", "walk_ms", "h2d_blend_ms"):
        out[key] = [r[key] for r in recs if key in r]
    return out


if __name__ == "__main__":
    main()
