"""Gradient-noise-scale (GNS) monitoring. Port of
`kungfu_tpu/monitor/noise_scale.py`.

The estimator of McCandlish et al. ("An Empirical Model of Large-Batch
Training"): with b the per-worker batch, B the global batch, |g_small|^2
the local gradient's squared norm and |g_big|^2 the averaged gradient's,

    |G|^2 est:  g2 = (B |g_big|^2 - b |g_small|^2) / (B - b)
    tr(S) est:  s  = (|g_small|^2 - |g_big|^2) / (1/b - 1/B)

and GNS = EMA(s) / EMA(g2), the batch size at which noise ~ signal. The
arithmetic is f32 on the gradients' device, as in the JAX package; the
state's `count` is a host integer, so thinning by `interval` needs no
read from the device.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from kungfu_tpu_torch import resolve_device
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.optimizers.core import SynchronousSGD


class GNSState(NamedTuple):
    g2_ema: torch.Tensor  # EMA of the |G|^2 estimate, f32 scalar
    s_ema: torch.Tensor  # EMA of the tr(S) estimate, f32 scalar
    count: int


def gns_init(device=None) -> GNSState:
    """Unseeded state on `device` (None = the CUDA card)."""
    zero = torch.zeros((), dtype=torch.float32, device=resolve_device(device))
    return GNSState(g2_ema=zero, s_ema=zero.clone(), count=0)


def _sq_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """Sum of squares of every element, in f32. One fused norm over all the
    tensors (the kernels `clip_grad_norm_` uses), not three launches a
    tensor: ResNet-50 has 161 gradients."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(torch._foreach_norm(tensors, 2, dtype=torch.float32)).square().sum()


def gns_update_norms(state: GNSState, gs, gb, batch_small, batch_big,
                     alpha: float = 0.6) -> GNSState:
    """One EMA update from squared norms gs = E|g_small|^2, gb =
    |g_big|^2 (f32 scalars). The first sample seeds both EMAs."""
    gs, gb = torch.as_tensor(gs, dtype=torch.float32), torch.as_tensor(gb, dtype=torch.float32)
    # 0-d host tensors: f32 arithmetic as JAX's, and no copy to the card
    bs = torch.tensor(batch_small, dtype=torch.float32)
    bb = torch.tensor(batch_big, dtype=torch.float32)
    g2 = (bb * gb - bs * gs) / (bb - bs)
    s = (gs - gb) / (1.0 / bs - 1.0 / bb)
    if state.count == 0:
        return GNSState(g2_ema=g2, s_ema=s, count=1)
    return GNSState(g2_ema=alpha * g2 + (1 - alpha) * state.g2_ema,
                    s_ema=alpha * s + (1 - alpha) * state.s_ema, count=state.count + 1)


def gns_update(state: GNSState, local_grads, avg_grads, batch_small, batch_big,
               alpha: float = 0.6) -> GNSState:
    """Tensor-list form of `gns_update_norms` (a single-process estimate)."""
    return gns_update_norms(state, _sq_norm(local_grads), _sq_norm(avg_grads),
                            batch_small, batch_big, alpha)


def noise_scale(state: GNSState) -> torch.Tensor:
    """The current GNS estimate (0 while unseeded)."""
    return torch.where(state.g2_ema != 0,
                       state.s_ema / torch.clamp(state.g2_ema, min=1e-30),
                       torch.zeros_like(state.g2_ema))


def publish_noise_scale(state: GNSState) -> float:
    """Read the GNS estimate to the host and publish it as the
    ``kungfu_noise_scale`` gauge (plus the raw EMAs); returns the value.
    The estimate itself stays on the device: this is an explicit device
    -> host read, so call it at a logging cadence, not every step."""
    from kungfu_tpu_torch.telemetry import metrics as _tm

    val = float(noise_scale(state))
    _tm.gauge(
        "kungfu_noise_scale",
        "Gradient noise scale (McCandlish critical batch estimate)",
    ).set(val)
    _tm.gauge(
        "kungfu_noise_scale_g2_ema", "EMA of the |G|^2 estimate"
    ).set(float(state.g2_ema))
    _tm.gauge(
        "kungfu_noise_scale_s_ema", "EMA of the tr(S) estimate"
    ).set(float(state.s_ema))
    return val


class MonitorGradientNoiseScale(SynchronousSGD):
    """S-SGD plus the GNS estimate (`monitor_gradient_noise_scale`).

    |g_small|^2 is the world average of each rank's local squared norm, so
    the state stays replicated; that scalar rides in the gradients'
    all-average as one more f32 element, so it costs no collective of its
    own. B = `batch_small` x the world's size. `count` advances every
    step; `interval` thins only the EMA updates."""

    def __init__(self, base: torch.optim.Optimizer, session, batch_small: int,
                 interval: int = 1, alpha: float = 0.6):
        super().__init__(base, session)
        self.batch_small = batch_small
        self.interval = interval
        self.alpha = alpha
        self.gns = gns_init(session.device)

    @torch.no_grad()
    def average_gradients(self) -> None:
        grads = self.filled_grads()
        gs_local = _sq_norm(grads).reshape(1)
        *avgs, gs = collective.group_all_average(grads + [gs_local], self.session.group)
        for g, avg in zip(grads, avgs):
            g.copy_(avg)
        state = self.gns
        if state.count % self.interval == 0:
            new = gns_update_norms(state, gs[0], _sq_norm(grads), self.batch_small,
                                   self.batch_small * self.session.size, self.alpha)
            self.gns = new._replace(count=state.count + 1)
        else:
            self.gns = state._replace(count=state.count + 1)


def monitor_gradient_noise_scale(base: torch.optim.Optimizer, session, batch_small: int,
                                 interval: int = 1, alpha: float = 0.6
                                 ) -> MonitorGradientNoiseScale:
    return MonitorGradientNoiseScale(base, session, batch_small, interval, alpha)
