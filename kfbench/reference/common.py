"""What the references share: seeds, float32 without TF32, the rounding
of the control (fp8 for the products the program computes in bf16, bf16
for its float32 head), the plain optimizers, and the data-parallel replay
of the first training steps."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

FP8_MAX = 448.0  # the largest float8_e4m3fn


def derive_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of a run (tags: rank, stream id), from
    the run's seed of any size."""
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), *tags]).generate_state(2, np.uint32)
    return int(words[0]) | (int(words[1] & 0x7FFFFFFF) << 32)


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *tags))


@contextlib.contextmanager
def float32_exact():
    """Float32 products without TF32 (cuBLAS and cuDNN), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8_e4m3fn under one per-tensor scale (amax to the
    format's largest value), as fp8 training scales a tensor, back in f32."""
    scale = FP8_MAX / x.detach().abs().amax().float().clamp_min(1e-30)
    return (x.float() * scale).to(torch.float8_e4m3fn).float() / scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in f32."""
    return x.float().to(torch.bfloat16).float()


class _Fp8(torch.autograd.Function):
    """fp8 rounding forward, and of the incoming gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


class _Bf16(torch.autograd.Function):
    """bf16 rounding forward, and of the incoming gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return round_bf16(g)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


# precision -> (the cast on each input and output of a product the
# program computes in bf16, the cast on those of its float32 head)
PRECISIONS: Dict[Optional[str], Tuple[Callable, Callable]] = {
    None: (_identity, _identity),  # the reference: float32 throughout
    "control": (_Fp8.apply, _Bf16.apply),  # one step below what the configuration states
    "bf16_head": (_identity, _Bf16.apply),  # the head alone one step below
}


def casts(precision: Optional[str]) -> Tuple[Callable, Callable]:
    """(products' cast, head's cast) of a precision of PRECISIONS."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return PRECISIONS[precision]


def sgd_momentum(lr: float, momentum: float):
    """torch.optim.SGD(lr, momentum) written out: buf = g on the first
    step, then buf = momentum * buf + g; p -= lr * buf."""
    state: Dict[str, torch.Tensor] = {}

    def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], t: int):
        for k, g in grads.items():
            buf = g.clone() if t == 0 else state[k].mul_(momentum).add_(g)
            state[k] = buf
            params[k] = params[k] - lr * buf

    return step


def adamw(lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
    """torch.optim.AdamW written out (decoupled decay, bias-corrected
    moments, eps added to the corrected root)."""
    b1, b2 = betas
    m: Dict[str, torch.Tensor] = {}
    v: Dict[str, torch.Tensor] = {}

    def step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], t: int):
        for k, g in grads.items():
            m[k] = b1 * m[k] + (1 - b1) * g if t else (1 - b1) * g
            v[k] = b2 * v[k] + (1 - b2) * g * g if t else (1 - b2) * g * g
            c1, c2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
            p = params[k] * (1 - lr * weight_decay)
            params[k] = p - (lr / c1) * m[k] / ((v[k] / c2).sqrt() + eps)

    return step


def optimizer(spec: Dict):
    """The plain optimizer a workload names."""
    if spec["name"] == "sgd":
        return sgd_momentum(spec["lr"], spec["momentum"])
    if spec["name"] == "adamw":
        return adamw(spec["lr"], spec["weight_decay"])
    raise ValueError(f"unknown optimizer {spec['name']!r}")


def replay(loss_fn: Callable, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
           batch: Callable[[int, int], tuple], world: int, steps: int, opt) -> Dict:
    """S-SGD's first `steps` steps over `world` ranks, in float32: each
    rank's loss and gradient on its batch(step, rank), the gradients and
    the buffers that the forward updates averaged over the ranks, then the
    optimizer's step. Returns the world-mean loss of each step, each
    leaf's first averaged gradient's norm and its largest over the steps,
    and each leaf's change's norm (parameters and buffers) after the
    steps."""
    start = {k: v.clone() for k, v in {**params, **buffers}.items()}
    losses: List[float] = []
    first_grads: Dict[str, float] = {}
    max_grads = {k: 0.0 for k in params}
    for t in range(steps):
        total = {k: torch.zeros_like(v) for k, v in params.items()}
        new_buffers = {k: torch.zeros_like(v) for k, v in buffers.items()}
        loss_sum = 0.0
        for r in range(world):
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            mine = {k: v.clone() for k, v in buffers.items()}
            loss = loss_fn(leaves, mine, batch(t, r))
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
            for k, g in zip(leaves, grads):
                if g is not None:
                    total[k] += g
            for k, v in mine.items():
                new_buffers[k] += v
            loss_sum += float(loss.detach())
            del loss, grads, leaves
        grads = {k: g / world for k, g in total.items()}
        buffers = {k: v / world for k, v in new_buffers.items()}
        losses.append(loss_sum / world)
        norms = {k: float(g.norm()) for k, g in grads.items()}
        max_grads = {k: max(max_grads[k], n) for k, n in norms.items()}
        if t == 0:
            first_grads = norms
        with torch.no_grad():
            opt(params, grads, t)
        del total, grads
    end = {**params, **buffers}
    change = {k: float((end[k] - start[k]).norm()) for k in start}
    return {"losses": losses, "grad_norms": first_grads, "max_grad_norms": max_grads,
            "change_norms": change}
