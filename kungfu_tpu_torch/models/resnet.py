"""ResNet-50 (bottleneck v1.5), the throughput benchmark's workload. Port
of `kungfu_tpu/models/resnet.py`.

Same numbers as the flax model, with PyTorch layouts:

- Input is the NHWC image batch the JAX model takes. ``permute(0, 3, 1,
  2)`` of a contiguous NHWC tensor is already a channels-last NCHW tensor
  (no copy); the model is kept in `torch.channels_last`, where cuDNN runs
  NHWC convolutions. Kernels are stored OIHW.
- Convolutions compute in `dtype` (bf16 by default) with f32 parameters,
  the head in f32.
- "SAME" padding as XLA pads it: total ``max((ceil(n/s) - 1) s + k - n,
  0)``, low side ``total // 2``. A 3x3 stride-2 convolution, and the 3x3
  stride-2 max pool, on an even side pad (0, 1), which no symmetric
  ``padding=`` gives, so those pad explicitly (the pool with -inf).
- BatchNorm as flax's: statistics of this replica's batch in f32,
  eps 1e-5, running averages with flax's momentum 0.9 (torch's 0.1) and
  the BIASED batch variance (`F.batch_norm` would fold in the unbiased
  one). Nothing is synchronized across replicas: the benchmark averages
  the running statistics after each step, as `bench.py` does.
- The last norm of each block starts with scale 0.
- Module names are flax's automatic names (`conv_init`, `bn_init`,
  `BottleneckBlock_<i>/{Conv_<j>, BatchNorm_<j>, conv_proj, norm_proj}`,
  `Dense_0`), so `tree()` is the flax parameter tree and
  `models/convert.py` maps the two one to one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kungfu_tpu_torch import resolve_device

MOMENTUM = 0.9  # flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch
EPSILON = 1e-5


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of one side of n for XLA's "SAME"."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """`nn.Conv(use_bias=False)`: "SAME" padding, or fixed symmetric
    padding where flax is given one."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(self.dtype)
        if self.padding is not None:
            return F.conv2d(x, w, stride=self.stride, padding=self.padding)
        (hl, hh), (wl, wh) = (same_pads(n, self.k, self.stride) for n in x.shape[2:])
        if hl == hh and wl == wh:
            return F.conv2d(x, w, stride=self.stride, padding=(hl, wl))
        return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=self.stride)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over NCHW channels: learnable ``scale`` and
    ``bias``, running ``mean`` and ``var`` buffers. The output has the
    input's dtype; the arithmetic is f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=EPSILON)
        # the batch's statistics in f32; the private op returns the mean and
        # 1/sqrt(biased var + eps) (checked on torch 2.11 with CUDA and 2.13
        # on the CPU; tests/test_torch_port_cuda.py holds it on the card)
        y, mean, rstd = torch._native_batch_norm_legit(x, self.scale, self.bias, True,
                                                       0.0, EPSILON)
        with torch.no_grad():
            var = (rstd.double().pow(-2) - EPSILON).float().clamp_min_(0.0)
            self.mean.copy_(MOMENTUM * self.mean + (1 - MOMENTUM) * mean)
            self.var.copy_(MOMENTUM * self.var + (1 - MOMENTUM) * var)
        return y


class Dense(nn.Module):
    """`nn.Dense(dtype=float32)`: ``x @ kernel + bias``, kernel (in, out)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, filters * 4, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4)
        self.proj = cin != filters * 4 or stride != 1
        if self.proj:
            self.conv_proj = Conv(cin, filters * 4, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        residual = self.norm_proj(self.conv_proj(x), train) if self.proj else x
        return torch.relu(residual + y)


class SpaceToDepthStem(Conv):
    """The 7x7/s2 stem as a 4x4/s1 convolution over 2x2 blocks of the
    input (12 channels), with the same stored (filters, c, 7, 7) kernel
    as the plain stem: exact, the same taps reassociated."""

    def __init__(self, cin: int, filters: int, dtype: torch.dtype):
        super().__init__(cin, filters, 7, 2, padding=3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"space-to-depth stem needs even H/W, got {h}x{w}")
        f = self.kernel.shape[0]
        # zero-pad the kernel at the front: out[i] = sum_u x[2i - 4 + u] w8[u]
        w8 = F.pad(self.kernel.to(self.dtype), (1, 0, 1, 0))
        w4 = (w8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
              .reshape(f, 4 * c, 4, 4))
        hb, wb = (h + 8) // 2, (w + 8) // 2
        xs = (F.pad(x, (4, 4, 4, 4)).reshape(b, c, hb, 2, wb, 2)
              .permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, hb, wb))
        return F.conv2d(xs, w4)[:, :, :h // 2, :w // 2]


class ResNet(nn.Module):
    """`ResNet(stage_sizes, num_classes, num_filters, dtype, s2d_stem)` of
    the JAX package. ``forward(images, train)`` takes NHWC images and
    returns f32 logits; in training mode it updates the running
    statistics in place."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 s2d_stem: bool = False, in_channels: int = 3):
        super().__init__()
        self.dtype, self.s2d_stem = dtype, s2d_stem
        self.conv_init = (SpaceToDepthStem(in_channels, num_filters, dtype) if s2d_stem
                          else Conv(in_channels, num_filters, 7, 2, padding=3, dtype=dtype))
        self.bn_init = BatchNorm(num_filters)
        cin, n = num_filters, 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                self.add_module(f"BottleneckBlock_{n}", BottleneckBlock(
                    cin, filters, 2 if i > 0 and j == 0 else 1, dtype))
                cin, n = filters * 4, n + 1
        self.n_blocks = n
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, images: torch.Tensor, train: Optional[bool] = None) -> torch.Tensor:
        train = self.training if train is None else train
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        if self.s2d_stem and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            x = self.conv_init(x)
        else:  # the plain stem, on the same kernel
            x = Conv.forward(self.conv_init, x)
        x = torch.relu(self.bn_init(x, train))
        (hl, hh), (wl, wh) = (same_pads(n, 3, 2) for n in x.shape[2:])
        x = F.max_pool2d(F.pad(x, (wl, wh, hl, hh), value=-math.inf), 3, 2)
        for n in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{n}")(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))

    def tree(self) -> Dict:
        """The parameters as flax's nested tree (torch layouts)."""
        return _nest(self.named_parameters())

    def stats_tree(self) -> Dict:
        """The running statistics as flax's `batch_stats` tree."""
        return _nest(self.named_buffers())


def _nest(named) -> Dict:
    out: Dict = {}
    for name, t in named:
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], num_classes=num_classes, dtype=dtype)


def resnet18_thin(num_classes: int = 10, dtype: torch.dtype = torch.bfloat16) -> ResNet:
    """Small variant for CPU tests."""
    return ResNet(stage_sizes=[1, 1], num_classes=num_classes, num_filters=8, dtype=dtype)


@torch.no_grad()
def init_resnet(model: ResNet, generator: Optional[torch.Generator] = None,
                device=None) -> ResNet:
    """Fill `model` as flax initializes it (kernels lecun-normal: a normal
    of variance 1/fan_in truncated at two standard deviations; norms scale
    1, bias 0, the last of each block scale 0; running mean 0, var 1),
    drawn on the CPU from `generator`, and move it to `device` (None = the
    CUDA card) in channels-last layout. The JAX function returns (params,
    batch_stats); here the model holds both."""
    device = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = p.shape[1] * p.shape[2] * p.shape[3] if p.dim() == 4 else p.shape[0]
            std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
            p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std,
                                                -2 * std, 2 * std, generator=g))
        elif leaf == "scale":
            p.fill_(0.0 if name.endswith("BatchNorm_2.scale") else 1.0)
        else:
            p.zero_()
    for name, b in model.named_buffers():
        b.fill_(1.0 if name.endswith("var") else 0.0)
    return model.to(device, memory_format=torch.channels_last)


def resnet_loss(model: ResNet, batch) -> torch.Tensor:
    """Mean cross-entropy of the training-mode logits; the forward updates
    the running statistics (the JAX function returns them instead)."""
    images, labels = batch
    return F.cross_entropy(model(images, train=True), labels.long())
