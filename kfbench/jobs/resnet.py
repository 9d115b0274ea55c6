"""ResNet S-SGD, as the program's `bench.Bench.step`: the model of
`models/resnet.py` under `optimizers/core.synchronous_sgd(torch.optim.SGD)`,
then the running statistics averaged over the world through
`ops/collective`. Weights and batches come from the benchmark's seed."""

from __future__ import annotations

from typing import Dict

import torch
from torch.profiler import record_function

from kfbench.reference import resnet as ref
from kfbench.traffic import images
from kungfu_tpu_torch.initializer import broadcast_variables
from kungfu_tpu_torch.models.resnet import ResNet, resnet_loss
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.optimizers.core import synchronous_sgd


class Job:
    def __init__(self, cfg: Dict, workload: Dict, seed: int, device, session):
        self.session = session
        params, buffers = ref.init(cfg, seed, device)
        model = ResNet(cfg["stage_sizes"], cfg["num_classes"], cfg["num_filters"],
                       getattr(torch, cfg["dtype"]), in_channels=cfg["in_channels"])
        model = model.to(device, memory_format=torch.channels_last)
        drawn = {**params, **buffers}
        with torch.no_grad():
            for name, t in list(model.named_parameters()) + list(model.named_buffers()):
                t.copy_(drawn[name])
        del params, buffers, drawn
        self.model = broadcast_variables(model, session)
        opt = workload["optimizer"]
        self.opt = synchronous_sgd(
            torch.optim.SGD(model.parameters(), lr=opt["lr"], momentum=opt["momentum"]),
            session)
        self.stats = list(model.buffers())
        self.images, self.labels = images.pool(workload["mix"], cfg, seed, session.rank,
                                               device)
        self.work_per_step = workload["mix"]["batch"]

    def step(self, i: int) -> torch.Tensor:
        with record_function("kfbench.data"):
            j = i % self.images.shape[0]
            batch = (self.images[j], self.labels[j])
        self.opt.zero_grad(set_to_none=True)
        with record_function("kfbench.forward"):
            loss = resnet_loss(self.model, batch)
        with record_function("kfbench.backward"):
            loss.backward()
        with record_function("kfbench.optimizer"):
            self.opt.step()
        if self.session.size > 1:
            with record_function("kfbench.stats"), torch.no_grad():
                for s, avg in zip(self.stats, collective.group_all_average(
                        self.stats, self.session.group)):
                    s.copy_(avg)
        return loss.detach()

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {**dict(self.model.named_parameters()), **dict(self.model.named_buffers())}

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """SGD's momentum buffer after its first step is that step's
        (averaged) gradient."""
        state = self.opt.base.state
        return {name: state[p]["momentum_buffer"] if p in state else torch.zeros_like(p)
                for name, p in self.model.named_parameters()}


def build(cfg: Dict, workload: Dict, seed: int, device, session) -> Job:
    return Job(cfg, workload, seed, device, session)
