"""ResNet training costs: every convolution's forward, input gradient and
weight gradient (2 FLOPs a multiply-add over the output positions), each
bf16 tensor counted once as read or written; the f32 head's three
products. The stem's input gradient is not computed (images need none)
and is not counted."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from kfbench import peaks
from kfbench.reference import resnet as ref

BF16 = 2


def convolutions(cfg: Dict) -> Iterator[Tuple[str, int, int, int, int, int, int]]:
    """(name, cin, cout, k, stride, H in, H out) of every convolution, in order."""
    side = cfg["image_size"]
    out = -(-side // 2)
    yield "conv_init", cfg["in_channels"], cfg["num_filters"], 7, 2, side, out
    side = -(-out // 2)  # the max pool
    e = cfg["bottleneck_expansion"]
    for name, cin, f, stride in ref.blocks(cfg):
        low = -(-side // stride)
        yield f"{name}.Conv_0", cin, f, 1, 1, side, side
        yield f"{name}.Conv_1", f, f, 3, stride, side, low
        yield f"{name}.Conv_2", f, f * e, 1, 1, low, low
        if cin != f * e or stride != 1:
            yield f"{name}.conv_proj", cin, f * e, 1, stride, side, low
        side = low


def costs(cfg: Dict, traffic: Dict) -> Dict[str, float]:
    b = traffic["batch"]
    flops = 0.0
    bound = 0.0
    for name, cin, cout, k, stride, hin, hout in convolutions(cfg):
        macs = b * hout * hout * cout * cin * k * k
        x, w, y = (b * hin * hin * cin * BF16, cout * cin * k * k * BF16,
                   b * hout * hout * cout * BF16)
        passes = [(x + w + y), (x + y + w)]  # forward; weight gradient
        if name != "conv_init":
            passes.append(y + w + x)  # input gradient
        flops += 2 * macs * len(passes)
        bound += sum(peaks.bound_s(2 * macs, nbytes) for nbytes in passes)
    head = 2 * b * cfg["num_filters"] * 2 ** (len(cfg["stage_sizes"]) - 1) \
        * cfg["bottleneck_expansion"] * cfg["num_classes"]
    return {"train_flops": flops + 3 * head, "conv_bound_s": bound}
