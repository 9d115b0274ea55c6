"""Cross-worker gradient-variance monitoring. Port of
`kungfu_tpu/monitor/grad_variance.py`.

S-SGD plus a periodic estimate of the variance of the gradients across
workers:

    Var[g] = E_workers[g^2] - (E_workers[g])^2        (per tensor)
    variance = sum over tensors of ||Var[g]||_F

E[g^2] is a second gradient-sized all-average (the squares in f32, one
flattened collective); a step off the interval skips it and keeps the
last estimate.
"""

from __future__ import annotations

from typing import List

import torch

from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.optimizers.core import SynchronousSGD


def _variance_estimate(squares: List[torch.Tensor], avgs: List[torch.Tensor], group
                       ) -> torch.Tensor:
    """sum_t || E[g_t^2] - avg_t^2 ||_F over the group, from this rank's
    f32 squares g_t^2 and the averaged gradients avg_t."""
    mean_sq = collective.group_all_average(squares, group)
    total = torch.zeros((), dtype=torch.float32, device=avgs[0].device)
    for m, a in zip(mean_sq, avgs):
        var = m - a.float().square()
        total = total + torch.sqrt(torch.clamp(var.square().sum(), min=0.0))
    return total


class MonitorGradientVariance(SynchronousSGD):
    """S-SGD + the cross-worker gradient variance
    (`monitor_gradient_variance`); `variance` is the latest estimate, and
    `interval` thins it: steps whose count is not a multiple of it run no
    second collective."""

    def __init__(self, base: torch.optim.Optimizer, session, interval: int = 1):
        super().__init__(base, session)
        self.interval = interval
        self.variance = torch.zeros((), dtype=torch.float32, device=session.device)
        self.count = 0

    @torch.no_grad()
    def average_gradients(self) -> None:
        grads = self.filled_grads()
        on = self.count % self.interval == 0
        squares = [g.float().square() for g in grads] if on else None
        super().average_gradients()
        if on:
            self.variance = _variance_estimate(squares, grads, self.session.group)
        self.count += 1


def monitor_gradient_variance(base: torch.optim.Optimizer, session,
                              interval: int = 1) -> MonitorGradientVariance:
    return MonitorGradientVariance(base, session, interval)


def gradient_variance(opt: MonitorGradientVariance) -> torch.Tensor:
    """The latest variance estimate of a monitored optimizer."""
    return opt.variance


def publish_gradient_variance(opt: MonitorGradientVariance) -> float:
    """Read the variance estimate to the host and publish it as the
    ``kungfu_gradient_variance`` gauge; returns the value. Call it at a
    logging cadence: this is an explicit device -> host read."""
    from kungfu_tpu_torch.telemetry import metrics as _tm

    val = float(gradient_variance(opt))
    _tm.gauge(
        "kungfu_gradient_variance",
        "Cross-worker gradient variance (summed Frobenius norm)",
    ).set(val)
    return val
