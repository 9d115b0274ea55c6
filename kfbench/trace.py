"""The traced window: torch.profiler (CPU and CUDA) over a few steady
steps, its Chrome trace reduced to what the per-layer readers take.

Each device operation (kernel, memcpy, memset) keeps its name, its
seconds, the benchmark's innermost `kfbench.*` range the host was in when
it was launched (by time: the backward launches from autograd's thread
while the main thread waits inside the step's range), and the outermost
operator on the launching thread (`aten::conv2d`, `autograd::engine::
evaluate_function: ConvolutionBackward0`, ...). Busy time is the union of
the operations' intervals over every stream, so an NCCL kernel that runs
beside a compute kernel is not counted twice. Each stretch in which the
device ran nothing is labelled by the benchmark's range and the innermost
operator the host's main thread was in when it began."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_PREFIX = "kfbench."
TOP = 10
NAME_CHARS = 160


def _covering(intervals: List[Tuple[float, float, str]], points: List[Tuple[float, int]],
              innermost: bool) -> Dict[int, str]:
    """For each (time, key) point, the name of the innermost (or
    outermost) of the properly nested `intervals` (start, end, name)
    that covers it; points outside every interval are left out."""
    out: Dict[int, str] = {}
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for t, key in sorted(points):
        while i < len(ivs) and ivs[i][0] <= t:
            while stack and stack[-1][1] < ivs[i][0]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        live = [iv for iv in stack if iv[0] <= t <= iv[1]]
        if live:
            out[key] = live[-1][2] if innermost else live[0][2]
    return out


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_trace(events: List[Dict], steps: int, wall_s: float) -> Dict:
    """The traced window's summary for the readers (times in seconds)."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    marked = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith(RANGE_PREFIX)]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in marked]
    main_tid = marked[0].get("tid") if marked else None
    ops_by_tid: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            ops_by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    launch_at = {}
    points_by_tid: Dict[object, List[Tuple[float, int]]] = defaultdict(list)
    for i, e in enumerate(device):
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            launch_at[i] = launch["ts"]
            points_by_tid[launch.get("tid")].append((launch["ts"], i))
    in_range = _covering(ranges, [(t, i) for i, t in launch_at.items()], innermost=True)
    op_of: Dict[int, str] = {}
    for tid, points in points_by_tid.items():
        op_of.update(_covering(ops_by_tid.get(tid, []), points, innermost=False))
    ops = [[e["name"][:NAME_CHARS], e["dur"] * 1e-6, in_range.get(i, ""), op_of.get(i, "")]
           for i, e in enumerate(device)]
    busy = union([(e["ts"], e["ts"] + e["dur"]) for e in device])
    gaps: Dict[str, float] = defaultdict(float)
    if busy and ranges:
        start = min(r[0] for r in ranges)
        edges = [(start, busy[0][0])] + [(busy[k][1], busy[k + 1][0])
                                         for k in range(len(busy) - 1)]
        idle = [(a, b) for a, b in edges if b > a]
        starts = [(a, k) for k, (a, _) in enumerate(idle)]
        label = _covering(ranges, starts, innermost=True)
        host_op = _covering(ops_by_tid.get(main_tid, []), starts, innermost=True)
        for k, (a, b) in enumerate(idle):
            name = label.get(k, "host outside the steps")
            if k in host_op:
                name = f"{name}: {host_op[k]}"
            gaps[name] += (b - a) * 1e-6
    return {"steps": steps, "wall_s": wall_s, "ops": ops,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:TOP]}


def profile(run: Callable[[], None], steps: int, device: torch.device) -> Dict:
    """Profile `run()` (which takes `steps` steps and waits for the
    device) and reduce its trace."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        wall_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="kfbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce_trace(events, steps, wall_s)
