"""Benchmark: ResNet-50 training throughput (images/s per card), through
the port's own training path. Port of the repo's `bench.py`.

    python -m kungfu_tpu_torch.bench                      # on the card
    python -m kungfu_tpu_torch.bench --device cpu --batch 2 --image-size 32

Prints ONE JSON line with the keys of `bench.py`: metric, value, unit,
vs_baseline, step_ms, mfu, mfu_macs, flops_per_img, device.

The workload is `bench.py`'s: ResNet-50 (1000 classes, 224x224, bf16
compute) at 128 images a card, S-SGD over SGD(lr 0.1, momentum 0.9), the
running statistics averaged over the data-parallel world after each step,
INNER distinct bf16 batches staged on the device once (all labels 0). Two
warm-up windows of INNER steps, then the best of six windows. The JAX
bench scans INNER steps inside one compiled program; here the same steps
run in one eager loop (a CUDA graph of the step would be an optimization,
not the port).

MFU counts 2 FLOPs a multiply-add against the H100's dense bf16 peak of
989 TFLOP/s (NVIDIA's data sheet, SXM). FLOPs per image are the analytic
24.6e9 of a training step at 224x224 (3x the forward's 8.2e9; the port has
no XLA cost model to read them from), scaled by the image area at other
sizes. On the CPU no MFU is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Sequence

import torch

from kungfu_tpu_torch.initializer import broadcast_variables
from kungfu_tpu_torch.models.resnet import init_resnet, resnet50, resnet_loss
from kungfu_tpu_torch.ops import collective
from kungfu_tpu_torch.optimizers.core import synchronous_sgd
from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
from kungfu_tpu_torch.parallel.mesh import make_mesh

METRIC = "resnet50_ssgd_train_throughput_per_chip"
BASELINE_IMG_PER_SEC = 350.0  # TF ResNet-50 fp32 on a V100, the reference's era
INNER = 16  # steps per timed window
WARMUP_WINDOWS = 2
WINDOWS = 6
TRAIN_FLOPS_PER_IMG = 24.6e9  # at 224x224
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="default: the CUDA card")
    p.add_argument("--batch", type=int, default=128, help="images per card")
    p.add_argument("--image-size", type=int, default=224)
    return p.parse_args(argv)


class Bench:
    """The benchmark's state: model, S-SGD optimizer and the staged
    batches. `step(i)` trains on batch i; `window()` runs INNER steps and
    waits for the device."""

    def __init__(self, args: argparse.Namespace):
        self.args = args
        self.device = initialize_device_plane(args.device)
        self.session = make_mesh(self.device)
        self.model = broadcast_variables(
            init_resnet(resnet50(num_classes=1000), torch.Generator().manual_seed(0),
                        self.device), self.session)
        self.opt = synchronous_sgd(
            torch.optim.SGD(self.model.parameters(), lr=0.1, momentum=0.9), self.session)
        self.stats = list(self.model.buffers())
        gen = torch.Generator(device=self.device).manual_seed(self.session.rank)
        size = args.image_size
        self.images = torch.randn((INNER, args.batch, size, size, 3), generator=gen,
                                  device=self.device, dtype=torch.bfloat16)
        self.labels = torch.zeros((INNER, args.batch), dtype=torch.long, device=self.device)
        self.losses: List[torch.Tensor] = []

    def step(self, i: int) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        loss = resnet_loss(self.model, (self.images[i], self.labels[i]))
        loss.backward()
        self.opt.step()
        if self.session.size > 1:  # the running statistics, like the gradients
            with torch.no_grad():
                for s, avg in zip(self.stats, collective.group_all_average(
                        self.stats, self.session.group)):
                    s.copy_(avg)
        loss = loss.detach()
        self.losses.append(loss)
        return loss

    def window(self) -> float:
        for i in range(INNER):
            loss = self.step(i)
        return float(collective.all_average(loss, self.session.group))  # waits

    def run(self) -> Dict:
        for _ in range(WARMUP_WINDOWS):
            self.window()
        best = float("inf")
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            self.window()
            best = min(best, (time.perf_counter() - t0) / INNER)
        per_card = self.args.batch / best
        flops = TRAIN_FLOPS_PER_IMG * (self.args.image_size / 224) ** 2
        on_card = self.device.type == "cuda"
        mfu = per_card * flops / H100_BF16_FLOPS if on_card else None
        return {
            "metric": METRIC,
            "value": per_card,
            "unit": "images/sec/chip",
            "vs_baseline": per_card / BASELINE_IMG_PER_SEC,
            "step_ms": best * 1e3,
            "mfu": mfu,
            "mfu_macs": mfu / 2 if on_card else None,
            "flops_per_img": flops / 1e9,
            "device": torch.cuda.get_device_name(self.device) if on_card else "cpu",
        }


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    out = Bench(parse_args(argv)).run()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
