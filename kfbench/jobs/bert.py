"""Masked-LM S-SGD, as the program's `examples/bert_ssgd.Trainer`: the
transformer of `models/transformer.py` with the flash kernels as its
attention core (`bert_ssgd.flash_core`), the loss `bert_ssgd.mlm_loss`,
under `parallel/dp.make_train_step` and
`optimizers/core.synchronous_sgd(torch.optim.AdamW)`. Weights and batches
come from the benchmark's seed."""

from __future__ import annotations

from typing import Dict

import torch
from torch.profiler import record_function

from kfbench.reference import bert as ref
from kfbench.traffic import mlm
from kungfu_tpu_torch.examples.bert_ssgd import flash_core, mlm_loss
from kungfu_tpu_torch.initializer import broadcast_variables
from kungfu_tpu_torch.models.transformer import Transformer, TransformerConfig
from kungfu_tpu_torch.optimizers.core import synchronous_sgd
from kungfu_tpu_torch.parallel.dp import make_train_step

ADAM_BETA1 = 0.9  # torch.optim.AdamW's default, which the job keeps


class _Ranged:
    """The optimizer, with its step inside the benchmark's range."""

    def __init__(self, opt):
        self.opt = opt

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        with record_function("kfbench.optimizer"):
            return self.opt.step()


class Job:
    def __init__(self, cfg: Dict, workload: Dict, seed: int, device, session):
        self.session = session
        tcfg = TransformerConfig(vocab_size=cfg["vocab_size"], d_model=cfg["hidden_size"],
                                 n_heads=cfg["num_attention_heads"],
                                 n_layers=cfg["num_hidden_layers"],
                                 d_ff=cfg["intermediate_size"],
                                 max_seq=cfg["max_position_embeddings"],
                                 dtype=getattr(torch, cfg["dtype"]))
        params, _ = ref.init(cfg, seed, device)
        tree = {k: v for k, v in params.items() if not k.startswith("layers.")}
        tree["layers"] = {k[len("layers."):]: v for k, v in params.items()
                          if k.startswith("layers.")}
        self.model = broadcast_variables(Transformer(tcfg, tree), session)
        del params, tree
        opt = workload["optimizer"]
        self.opt = synchronous_sgd(
            torch.optim.AdamW(self.model.parameters(), lr=opt["lr"],
                              weight_decay=opt["weight_decay"]), session)

        def loss_fn(model, batch):
            with record_function("kfbench.forward"):
                return mlm_loss(model.tree(), *batch, tcfg, core=flash_core)

        self.train_step = make_train_step(loss_fn, _Ranged(self.opt), session)
        self.inputs, self.targets, self.mask = mlm.pool(workload["mix"], cfg, seed,
                                                        session.rank, device)
        traffic = workload["mix"]
        self.work_per_step = traffic["batch"] * traffic["seq"]

    def step(self, i: int) -> torch.Tensor:
        with record_function("kfbench.data"):
            j = i % self.inputs.shape[0]
            batch = (self.inputs[j], self.targets[j], self.mask[j])
        return self.train_step(self.model, batch).detach()

    def leaves(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """AdamW's first moment after its first step is (1 - beta1) times
        that step's (averaged) gradient."""
        state = self.opt.base.state
        return {name: state[p]["exp_avg"] / (1 - ADAM_BETA1) if p in state
                else torch.zeros_like(p) for name, p in self.model.named_parameters()}


def build(cfg: Dict, workload: Dict, seed: int, device, session) -> Job:
    return Job(cfg, workload, seed, device, session)
