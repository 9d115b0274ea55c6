"""The trace reduction on a hand-made Chrome trace: each device operation
gets the benchmark's range its launch fell in (the backward launches from
another thread) and its outermost operator; busy time is the union over
streams; idle stretches are labelled by what the host was doing."""

import pytest

from kfbench import readers
from kfbench.trace import reduce_trace, union


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


EVENTS = [
    _x("user_annotation", "kfbench.step", 0, 100),
    _x("user_annotation", "kfbench.forward", 0, 30),
    _x("user_annotation", "kfbench.optimizer", 70, 30),
    _x("cpu_op", "aten::conv2d", 1, 10),
    _x("cpu_op", "aten::cudnn_convolution", 2, 8),
    _x("cuda_runtime", "cudaLaunchKernel", 3, 1, correlation=1),
    _x("cpu_op", "aten::item", 28, 2),
    _x("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 40, 10, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 41, 1, tid=2, correlation=2),
    _x("cpu_op", "aten::_foreach_add_", 75, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 76, 1, correlation=3),
    _x("cuda_runtime", "cudaLaunchKernel", 77, 1, correlation=4),
    _x("kernel", "sm90_xmma_fprop_implicit_gemm", 10, 20, tid=7, correlation=1),
    _x("kernel", "sm90_xmma_dgrad", 45, 20, tid=7, correlation=2),
    _x("kernel", "multi_tensor_apply_kernel", 80, 10, tid=7, correlation=3),
    _x("kernel", "ncclDevKernel_AllReduce", 85, 10, tid=8, correlation=4),
]


def test_ops_ranges_busy_and_gaps():
    t = reduce_trace(EVENTS, steps=1, wall_s=1e-4)
    ops = {op[0]: op[1:] for op in t["ops"]}
    assert ops["sm90_xmma_fprop_implicit_gemm"][1:] == ["kfbench.forward", "aten::conv2d"]
    assert ops["sm90_xmma_dgrad"][1] == "kfbench.step"
    assert "ConvolutionBackward0" in ops["sm90_xmma_dgrad"][2]
    assert ops["ncclDevKernel_AllReduce"][1] == "kfbench.optimizer"
    assert t["busy_s"] == pytest.approx((20 + 20 + 15) * 1e-6)
    gaps = dict(t["idle_gaps"])
    assert gaps == pytest.approx({"kfbench.forward": 10e-6, "kfbench.forward: aten::item": 15e-6,
                                  "kfbench.step": 15e-6})
    record = {"chips": 1, "costs": {"conv_bound_s": 20e-6}, "ranks": [{"trace": t}]}
    assert readers.device_ms(record, readers.is_conv) == pytest.approx(0.04)
    assert readers.roofline(record, "conv_bound_s", readers.is_conv) == pytest.approx(50.0)
    assert readers.device_ms(record, readers.is_nccl) == pytest.approx(0.01)
    assert readers.device_ms(record, readers.in_range("kfbench.optimizer")) == pytest.approx(0.01)
    assert readers.device_ms(record, readers.is_norm) is None


def test_union():
    assert union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_idle_share_and_the_rank_that_waited_least():
    t = reduce_trace(EVENTS, steps=1, wall_s=1e-4)
    late = dict(t, ops=[op if op[0] != "ncclDevKernel_AllReduce" else [op[0], 4e-6, *op[2:]]
                        for op in t["ops"]])
    record = {"chips": 2, "ranks": [{"trace": t}, {"trace": late}]}
    assert readers.idle_share(record) == pytest.approx((1 - 55e-6 / 1e-4) * 100)
    assert readers.device_ms(record, readers.is_nccl) == pytest.approx(0.007)
    assert readers.device_ms_least(record, readers.is_nccl) == pytest.approx(0.004)
    assert readers.device_ms_least({"ranks": [{"trace": None}]}, readers.is_nccl) is None
