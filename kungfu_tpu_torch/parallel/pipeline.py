"""Pipeline parallelism: GPipe over a "pp" mesh axis. Port of
`kungfu_tpu/parallel/pipeline.py`.

Each stage holds n_layers / P contiguous layers of the stacked transformer
(stage s layers [s L/P, (s+1) L/P)) and a replica of `embed`, `pos_embed`
and `ln_f_scale`. The schedule runs M + P - 1 ticks: at tick t stage s
works on microbatch t - s, stage 0 embedding it, the last stage adding its
LM loss, and every stage handing its activation to the next with
`ring_shift`. The loss is the sum over stages of the last stage's sum,
divided by M; under a "dp" axis each rank's loss is its own batch block's,
and `pipeline_sgd` averages over dp.

What keeps the ring from hanging. A shift is collective: every rank must
run every shift forward and every shift's backward, in the same order.
Three rules give that:

- every stage shifts at every tick but the last (the last tick's shift is
  read by nobody, so all ranks skip it alike), and the activation the
  first tick starts from takes a gradient, so every shift is in every
  stage's graph, the bubble ticks' too;
- stage 0 takes its microbatch with `torch.where` over the received
  activation, never a Python `if` that would drop the received activation
  from the graph: the shift that delivered it still runs its backward
  (with a zero cotangent), as it does on the stages that use what they
  receive;
- each stage's loss depends on its last activation (the last stage through
  its LM loss, the others through a zero-weighted sum), so every stage's
  backward reaches tick M + P - 2 and walks the chain of shifts back to
  tick 0. Each shift's backward waits for the next tick's, so every rank
  runs them in reverse tick order.

Unlike the JAX schedule, a stage skips its layers on a bubble tick (no
live microbatch: it passes the received activation on unchanged) and the
LM head on every stage but the last, work whose results JAX masks out. So
a step runs M L / P blocks on each stage, forward and backward, and the
values are JAX's. The shift wraps around (the last stage sends to stage
0, which discards it), where JAX's does not.

The replicated leaves are used on some stages only (stage 0 the
embeddings, the last stage the tied head and the final norm): their
gradient is the sum over stages, which `pipeline_sgd` forms (zeros where a
stage left one without a gradient) before it averages over dp.
"""

from __future__ import annotations

from typing import Optional

import torch

from kungfu_tpu_torch.models.transformer import (TransformerConfig, apply_layers,
                                                 full_attention_core, lm_head_loss)
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.optimizers.core import SynchronousSGD

REPLICATED = ("embed", "pos_embed", "ln_f_scale")


def make_pp_transformer_loss(cfg: TransformerConfig, session, n_micro: int, pp_axis: str = "pp",
                             dp_axis: Optional[str] = None, core=None):
    """Pipelined causal-LM loss. Returns loss_fn(model, (tokens, targets))
    for a model holding this stage's layer slice (`models.convert.pp_stage`):
    tokens and targets (B, S) are this rank's batch block (the whole batch
    without `dp_axis`), B divisible by n_micro. The result is the same on
    every stage of a pipeline; `core` is the dense attention core (q, k,
    v) -> ctx, full attention by default."""
    n_stages = session.axis_size(pp_axis)
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={n_stages}")
    if dp_axis is not None and session.axis_size(dp_axis) * n_stages != session.size:
        raise ValueError(f"mesh {session.shape} is not {dp_axis} x {pp_axis}")
    group = session.axis_group(pp_axis)
    stage = session.axis_index(pp_axis)
    first, last = stage == 0, stage == n_stages - 1
    core = core or full_attention_core

    def loss_fn(model, batch):
        tokens, targets = batch
        params = model.tree()
        B, S = tokens.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
        b, dt = B // n_micro, cfg.dtype
        micro_tok = tokens.reshape(n_micro, b, S)
        micro_tgt = targets.reshape(n_micro, b, S)
        take_new = torch.ones((), dtype=torch.bool, device=tokens.device)
        # a leaf that takes a gradient: otherwise the shifts of the bubble
        # ticks before a stage's first microbatch carry no gradient there
        # and drop out of its graph, but not out of stage 0's
        act = torch.zeros(b, S, cfg.d_model, dtype=dt, device=tokens.device,
                          requires_grad=torch.is_grad_enabled())
        loss_acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
        ticks = n_micro + n_stages - 1
        for t in range(ticks):
            m = t - stage  # the microbatch at this stage at tick t
            live = 0 <= m < n_micro
            x = act
            if first and live:
                x0 = params["embed"].to(dt)[micro_tok[m].long()] + params["pos_embed"].to(dt)[:S]
                x = torch.where(take_new, x0, act)
            if live:
                x = apply_layers(x, params, cfg, core)
            if last and live:
                loss_acc = loss_acc + lm_head_loss(params, x, micro_tgt[m], cfg)
            if t < ticks - 1 and n_stages > 1:
                act = collective.ring_shift(x, group)
        if not last:
            loss_acc = loss_acc + 0.0 * x.float().sum()
        return collective.reduce_from_group(loss_acc / n_micro, group)

    return loss_fn


class PipelineSGD(SynchronousSGD):
    """S-SGD for one pipeline stage: the replicated leaves' gradients
    summed over the pp group (a zero one where this stage left it None),
    then every gradient averaged over `dp_axis` (none without it), then
    the base step."""

    def __init__(self, base: torch.optim.Optimizer, model, session, pp_axis: str = "pp",
                 dp_axis: Optional[str] = None):
        super().__init__(base, session,
                         session.axis_group(dp_axis) if dp_axis is not None else None)
        self.replicated = [getattr(model, name) for name in REPLICATED]
        self.pp_group = session.axis_group(pp_axis)
        self.averages = dp_axis is not None

    @torch.no_grad()
    def average_gradients(self) -> None:
        self.filled_grads()
        rep = [p.grad for p in self.replicated]
        for g, total in zip(rep, collective.group_all_reduce(rep, ReduceOp.SUM, self.pp_group)):
            g.copy_(total)
        if self.averages:
            super().average_gradients()


def pipeline_sgd(base: torch.optim.Optimizer, model, session, pp_axis: str = "pp",
                 dp_axis: Optional[str] = None) -> PipelineSGD:
    return PipelineSGD(base, model, session, pp_axis, dp_axis)
