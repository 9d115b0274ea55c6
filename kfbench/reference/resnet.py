"""ResNet-50 v1.5 in plain float32 PyTorch (He et al. 2015, Table 1; the
stride on the 3x3 convolution), written to the program's conventions:

- NHWC images in, the 7x7/2 stem with symmetric padding 3, "SAME"
  padding as XLA pads it elsewhere (low side total // 2), the 3x3/2 max
  pool padded with -inf;
- batch norm as flax's: the batch's mean and BIASED variance, eps 1e-5,
  running averages with momentum 0.9, and the last norm of each block
  starting at scale 0;
- a float32 dense head on the spatial mean, mean cross-entropy.

Leaves are named as the program names its parameters and buffers
(`BottleneckBlock_<i>.Conv_<j>.kernel`, ...), kernels stored OIHW and
the head's (in, out). Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from kfbench.reference import common

TRUNC = 0.87962566103423978  # std of a unit normal truncated at +-2


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def blocks(cfg: Dict) -> List[Tuple[str, int, int, int]]:
    """(name, in channels, filters, stride) of each bottleneck block."""
    out, cin, n = [], cfg["num_filters"], 0
    for i, count in enumerate(cfg["stage_sizes"]):
        for j in range(count):
            filters = cfg["num_filters"] * 2 ** i
            out.append((f"BottleneckBlock_{n}", cin, filters, 2 if i > 0 and j == 0 else 1))
            cin, n = filters * cfg["bottleneck_expansion"], n + 1
    return out


def shapes(cfg: Dict) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """(parameter shapes, buffer shapes) by leaf name."""
    f0, e = cfg["num_filters"], cfg["bottleneck_expansion"]
    params: Dict[str, tuple] = {"conv_init.kernel": (f0, cfg["in_channels"], 7, 7)}
    norms = ["bn_init"]
    params.update({"bn_init.scale": (f0,), "bn_init.bias": (f0,)})
    for name, cin, f, stride in blocks(cfg):
        convs = [("Conv_0", "BatchNorm_0", cin, f, 1), ("Conv_1", "BatchNorm_1", f, f, 3),
                 ("Conv_2", "BatchNorm_2", f, f * e, 1)]
        if cin != f * e or stride != 1:
            convs.append(("conv_proj", "norm_proj", cin, f * e, 1))
        for conv, norm, i, o, k in convs:
            params[f"{name}.{conv}.kernel"] = (o, i, k, k)
        for conv, norm, i, o, k in convs:
            params[f"{name}.{norm}.scale"] = (o,)
            params[f"{name}.{norm}.bias"] = (o,)
            norms.append(f"{name}.{norm}")
    cout = blocks(cfg)[-1][2] * e
    params["Dense_0.kernel"] = (cout, cfg["num_classes"])
    params["Dense_0.bias"] = (cfg["num_classes"],)
    buffers = {}
    for norm in norms:
        c = params[f"{norm}.scale"][0]
        buffers[f"{norm}.mean"] = (c,)
        buffers[f"{norm}.var"] = (c,)
    return params, buffers


def init(cfg: Dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(parameters, buffers) as flax initializes them, drawn from `seed`
    on `device` in one call: kernels lecun-normal (variance 1/fan_in,
    truncated at two standard deviations), norm scales 1 (0 for the last
    norm of each block), biases 0, running mean 0 and variance 1."""
    pshapes, bshapes = shapes(cfg)
    kernels = [k for k in pshapes if k.endswith(".kernel")]
    sizes = [math.prod(pshapes[k]) for k in kernels]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=common.generator(device, seed, 0, 1))
    params: Dict[str, torch.Tensor] = {}
    for k, part in zip(kernels, flat.split(sizes)):
        shape = pshapes[k]
        fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        params[k] = part.view(shape) * (1.0 / math.sqrt(fan_in) / TRUNC)
    for k, shape in pshapes.items():
        if k.endswith(".scale"):
            params[k] = torch.full(shape, 0.0 if k.endswith("BatchNorm_2.scale") else 1.0,
                                   device=device)
        elif k.endswith(".bias"):
            params[k] = torch.zeros(shape, device=device)
    params = {k: params[k] for k in pshapes}
    buffers = {k: (torch.ones if k.endswith(".var") else torch.zeros)(s, device=device)
               for k, s in bshapes.items()}
    return params, buffers


def _conv(x, w, stride: int, cast, padding=None):
    k = w.shape[-1]
    if padding is None:
        (hl, hh), (wl, wh) = (_same(n, k, stride) for n in x.shape[2:])
        x = F.pad(x, (wl, wh, hl, hh))
        padding = 0
    return cast(F.conv2d(cast(x), cast(w), stride=stride, padding=padding))


def _norm(x, p, b, name: str, momentum: float, eps: float):
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    with torch.no_grad():
        b[f"{name}.mean"] = momentum * b[f"{name}.mean"] + (1 - momentum) * mean
        b[f"{name}.var"] = momentum * b[f"{name}.var"] + (1 - momentum) * var
    xhat = (x - mean[None, :, None, None]) * torch.rsqrt(var + eps)[None, :, None, None]
    return xhat * p[f"{name}.scale"][None, :, None, None] + p[f"{name}.bias"][None, :, None, None]


def logits(cfg: Dict, p: Dict, b: Dict, images: torch.Tensor, precision=None) -> torch.Tensor:
    """Training-mode logits of NHWC `images`; updates the running
    statistics in `b`. `precision` (common.PRECISIONS) rounds every
    convolution's inputs and output and the f32 head's; "control" rounds
    the first to fp8 and the head to bf16."""
    cast, head = common.casts(precision)
    mom, eps = cfg["bn_momentum"], cfg["bn_epsilon"]
    x = images.float().permute(0, 3, 1, 2)
    x = torch.relu(_norm(_conv(x, p["conv_init.kernel"], 2, cast, padding=3), p, b, "bn_init",
                         mom, eps))
    (hl, hh), (wl, wh) = (_same(n, 3, 2) for n in x.shape[2:])
    x = F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=-math.inf), 3, 2)
    e = cfg["bottleneck_expansion"]
    for name, cin, f, stride in blocks(cfg):
        y = torch.relu(_norm(_conv(x, p[f"{name}.Conv_0.kernel"], 1, cast), p, b,
                             f"{name}.BatchNorm_0", mom, eps))
        y = torch.relu(_norm(_conv(y, p[f"{name}.Conv_1.kernel"], stride, cast), p, b,
                             f"{name}.BatchNorm_1", mom, eps))
        y = _norm(_conv(y, p[f"{name}.Conv_2.kernel"], 1, cast), p, b, f"{name}.BatchNorm_2",
                  mom, eps)
        if cin != f * e or stride != 1:
            x = _norm(_conv(x, p[f"{name}.conv_proj.kernel"], stride, cast), p, b,
                      f"{name}.norm_proj", mom, eps)
        x = torch.relu(x + y)
    return head(head(x.mean(dim=(2, 3))) @ head(p["Dense_0.kernel"]) + p["Dense_0.bias"])


def loss(cfg: Dict, p: Dict, b: Dict, batch, precision=None) -> torch.Tensor:
    images, labels = batch
    return F.cross_entropy(logits(cfg, p, b, images, precision), labels.long())
