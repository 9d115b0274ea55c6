"""What the metric readers share. A reader takes the run's record:

- `chips`, `costs` (kfbench/costs: `train_flops` a rank's step, the
  kernels' `<kernels>_bound_s`), `setup_s`;
- `ranks`: each rank's window (`steps`, `window_s`, `step_ms`,
  `dispatch_ms`, `work_per_step`) and, traced, its `trace`
  (kfbench/trace.py: `steps`, `wall_s`, `busy_s`, and `ops`, each
  [name, seconds, harness range, outermost operator]).

A reader returns None where its run has nothing to read; the harness
then leaves the metric out. A share of a roofline or of a peak is never
made up as 0."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

from kfbench import peaks

NCCL = "nccl"


def rank_mean(record: Dict, per_rank: Callable[[Dict], Optional[float]]) -> Optional[float]:
    values = [per_rank(r) for r in record["ranks"]]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)


def window_s(record: Dict) -> float:
    """The window's host seconds: its slowest rank's."""
    return max(r["window_s"] for r in record["ranks"])


def rate(record: Dict) -> float:
    """Work (images, tokens) of every rank over the window, per card."""
    work = sum(r["steps"] * r["work_per_step"] for r in record["ranks"])
    return work / window_s(record) / record["chips"]


def step_times_ms(record: Dict) -> List[float]:
    """Each window step's time, taken at the slowest rank."""
    return [max(gaps) for gaps in zip(*(r["step_ms"] for r in record["ranks"]))]


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank q-th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def _rank_device_ms(r: Dict, select: Callable[[list], bool]) -> Optional[float]:
    t = r.get("trace")
    if not t:
        return None
    picked = [op[1] for op in t["ops"] if select(op)]
    return sum(picked) / t["steps"] * 1e3 if picked else None


def device_ms(record: Dict, select: Callable[[list], bool]) -> Optional[float]:
    """Device ms a step of the traced operations `select` keeps, rank mean;
    None untraced or where no operation is kept."""
    return rank_mean(record, lambda r: _rank_device_ms(r, select))


def device_ms_least(record: Dict, select: Callable[[list], bool]) -> Optional[float]:
    """The same, of the rank where it is least: for a collective, the rank
    that came to it last and so waited least for the others."""
    values = [_rank_device_ms(r, select) for r in record["ranks"]]
    if any(v is None for v in values):
        return None
    return min(values)


def roofline(record: Dict, bound_key: str, select: Callable[[list], bool]) -> Optional[float]:
    """% of the least time (costs' `bound_key`, a step) over the device
    time of the operations `select` keeps."""
    ms = device_ms(record, select)
    bound = record["costs"].get(bound_key)
    if not ms or bound is None:
        return None
    return bound * 1e3 / ms * 100


def mfu(record: Dict) -> float:
    """% of the bf16 peak: the model's FLOPs over the window, per card."""
    flops = sum(r["steps"] for r in record["ranks"]) * record["costs"]["train_flops"]
    return flops / window_s(record) / record["chips"] / peaks.BF16_FLOPS * 100


def idle_share(record: Dict) -> Optional[float]:
    """% of the traced window in which the device ran nothing: 1 - the
    busy time (union over streams) over the traced window's wall time,
    rank mean. Both are of the profiled steps, so host gaps the profiler
    widens count too."""
    def one(r):
        t = r.get("trace")
        if not t or not t["busy_s"]:
            return None
        return (1 - t["busy_s"] / t["wall_s"]) * 100
    return rank_mean(record, one)


def dispatch_ms(record: Dict) -> float:
    """Host ms to enqueue one window step, rank mean."""
    return rank_mean(record, lambda r: sum(r["dispatch_ms"]) / len(r["dispatch_ms"]))


def is_nccl(op: list) -> bool:
    """An NCCL kernel of the program (not the harness's stop flag)."""
    return NCCL in op[0].lower() and op[2] != "kfbench.clock"


def in_range(name: str) -> Callable[[list], bool]:
    return lambda op: op[2] == name and not is_nccl(op)


def is_norm(op: list) -> bool:
    low = op[0].lower()
    return "batch_norm" in low or "batchnorm" in low


def is_conv(op: list) -> bool:
    """Launched inside a convolution's forward (`aten::conv2d`) or
    backward (`ConvolutionBackward0`) operator."""
    low = op[3].lower()
    return "conv2d" in low or "convolution" in low


def is_f32_gemm(op: list) -> bool:
    low = op[0].lower()
    return "sgemm" in low or ("gemm" in low and "f32f32_f32f32" in low)


def is_flash(kind: str) -> Callable[[list], bool]:
    return lambda op: "kf_flash" in op[0] and f"flash_{kind}_kernel" in op[0]
