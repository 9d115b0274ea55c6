"""One rank of one run of a cell: set-up, the checked first steps, the
measured window, the traced steps, and the reference's replay; and the
result line assembled from the ranks' records.

Set-up builds the job once (weights and the pool of batches drawn from
the seed on the device), takes the first CHECK_STEPS steps through the
window's own call (the readings `correct` compares), and warms up for
WARM_S seconds. The window then runs steps until `seconds` have passed:
the host enqueues each step and records an event at its end, and waits
only when more than DEPTH steps ahead. Losses and events are read after
the window. A traced run then profiles the workload's `trace_steps` more
steps.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from kfbench import check, spec
from kfbench import trace as tracing
from kfbench.reference import common

CHECK_STEPS = 3
WARM_S = 1.0
DEPTH = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "kungfu_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that no run may load, compared whole
    (kungfu_tpu_torch is not kungfu_tpu)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Marks:
    """Step-end marks: CUDA events on the card, the host clock on the CPU
    (where a step has ended when its call returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def record(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def wait(self, k: int) -> None:
        if self.cuda:
            self.marks[k].synchronize()

    def gaps_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [m[k - 1].elapsed_time(m[k]) for k in range(1, len(m))]
        return [(m[k] - m[k - 1]) * 1e3 for k in range(1, len(m))]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steps(job, first: int, device: torch.device, n: Optional[int] = None,
          seconds: Optional[float] = None, losses: Optional[List] = None) -> Dict:
    """Steps from `first` on, the host at most DEPTH steps ahead: `n` of
    them, or as many as end once `seconds` have passed. Over several ranks
    every step all-reduces (MAX) whether its rank's clock has passed the
    time, and a rank reads that agreed flag once the device has finished
    the step, so all ranks stop after the same step. Returns the host
    seconds from the first enqueue to the device's end, each step's ms
    (end to end of steps) and each step's enqueue ms."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    agreed = seconds is not None and world > 1
    ring = []
    if agreed and device.type == "cuda":
        ring = [torch.empty(1, pin_memory=True) for _ in range(DEPTH + 2)]
    flags: List[torch.Tensor] = []
    marks = Marks(device)
    dispatch = []
    _sync(device)
    t0 = time.perf_counter()
    marks.record()
    k = 0
    while (n if n is not None else math.inf) > k:
        a = time.perf_counter()
        with record_function("kfbench.step"):
            loss = job.step(first + k)
        if agreed:
            with record_function("kfbench.clock"):
                late = torch.full((1,), float(time.perf_counter() - t0 >= seconds),
                                  device=device)
                dist.all_reduce(late, op=dist.ReduceOp.MAX)
                if ring:
                    late = ring[k % len(ring)].copy_(late, non_blocking=True)
                flags.append(late)
        marks.record()
        dispatch.append((time.perf_counter() - a) * 1e3)
        if losses is not None:
            losses.append(loss)
        if k >= DEPTH:
            with record_function("kfbench.wait"):
                marks.wait(k + 1 - DEPTH)
            if n is None:
                up = (float(flags[k - DEPTH]) > 0 if agreed
                      else time.perf_counter() - t0 >= seconds)
                if up:
                    n = k + 1
        k += 1
    _sync(device)
    return {"seconds": time.perf_counter() - t0, "step_ms": marks.gaps_ms(),
            "dispatch_ms": dispatch, "steps": k}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().norm() for k, v in tensors.items()}


def _floats(scalars: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(scalars)
    values = torch.stack([scalars[k] for k in keys]).tolist() if keys else []
    return dict(zip(keys, values))


def first_steps(job) -> Dict:
    """The job's first CHECK_STEPS steps, through its own step call; what
    `correct` compares, left on the device: each step's loss, the norm of
    each leaf's gradient as the optimizer's state holds it after the first
    step, and of each leaf's change over the steps."""
    leaves = job.leaves()
    start = {k: v.detach().clone() for k, v in leaves.items()}
    losses = [job.step(0)]
    grads = _norms(job.first_grads())
    losses += [job.step(i) for i in range(1, CHECK_STEPS)]
    change = {k: (v.detach().float() - start[k].float()).norm() for k, v in leaves.items()}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def program_readings(readings: Dict) -> Dict:
    return {"losses": [float(x) for x in readings["losses"]],
            "grad_norms": _floats(readings["grad_norms"]),
            "change_norms": _floats(readings["change_norms"])}


def run_rank(cell: str, seed: int, seconds: float, traced: bool, device=None,
             root: Path = spec.ROOT) -> Dict:
    """This process's rank of a run. Returns its record; rank 0's holds the
    reference's replay."""
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    phases = [("entered", time.time())]
    wl = spec.workload(cell, root)
    cfg = spec.config(wl["config"], root)
    device = initialize_device_plane(device)
    session = make_mesh(device)
    phases.append(("joined", time.time()))
    job = spec.family("jobs", cfg["family"]).build(cfg, wl, seed, device, session)
    phases.append(("built", time.time()))

    readings = first_steps(job)
    done = CHECK_STEPS
    _sync(device)
    phases.append(("checked", time.time()))
    done += steps(job, done, device, seconds=WARM_S)["steps"]

    losses: List[torch.Tensor] = []
    window_start = time.time()
    window = steps(job, done, device, seconds=seconds, losses=losses)
    done += window["steps"]
    out = {
        "rank": session.rank, "world": session.size, "steps": window["steps"],
        "window_start": window_start, "window_s": window["seconds"], "setup_phases": phases,
        "step_ms": window["step_ms"], "dispatch_ms": window["dispatch_ms"],
        "work_per_step": job.work_per_step,
        "failed_steps": int((~torch.isfinite(torch.stack(losses))).sum()),
        "trace": None,
    }
    del losses
    if traced:
        k = wl["trace_steps"]
        out["trace"] = tracing.profile(lambda: steps(job, done, device, n=k), k, device)
    if device.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        out["device_kind"] = torch.cuda.get_device_name(device)
    out["program"] = program_readings(readings)
    del job, readings
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    world = session.size
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if session.rank == 0:
        out["reference"] = replay(cfg, wl, seed, world, device)
    out["forbidden_modules"] = forbidden_modules()
    return out


def replay(cfg: Dict, wl: Dict, seed: int, world: int, device, precision=None) -> Dict:
    """The reference's first CHECK_STEPS steps of the run, on the same
    draw of weights and batches (`precision` "control": the control;
    reference/common.PRECISIONS)."""
    ref = spec.family("reference", cfg["family"])
    traffic = spec.family("traffic", wl["mix"]["generator"])
    pools: Dict[int, tuple] = {}

    def batch(t: int, r: int):
        if r not in pools:
            full = traffic.pool(wl["mix"], cfg, seed, r, device)
            pools[r] = tuple(x[:CHECK_STEPS].clone() for x in full)
            del full
        return tuple(x[t] for x in pools[r])

    with common.float32_exact():
        params, buffers = ref.init(cfg, seed, device)
        return common.replay(lambda p, b, xs: ref.loss(cfg, p, b, xs, precision), params, buffers,
                             batch, world, CHECK_STEPS, common.optimizer(wl["optimizer"]))


def assemble(ranks: List[Dict], cell: str, seed: int, traced: bool, t_launch: float,
             bench: Dict, root: Path = spec.ROOT) -> Dict:
    """The result line of a run from its ranks' records (rank 0 first)."""
    wl = spec.workload(cell, root)
    cfg = spec.config(wl["config"], root)
    chips = wl["chips"]
    record = {
        "cell": cell, "seed": seed, "chips": chips, "ranks": ranks,
        "setup_s": max(r["window_start"] for r in ranks) - t_launch,
        "costs": spec.family("costs", cfg["family"]).costs(cfg, wl["mix"]),
    }
    metrics = {}
    for m in spec.cell_metrics(bench, cell, traced):
        value = spec.metric_reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    program = dict(ranks[0]["program"])
    program["losses"] = [sum(r["program"]["losses"][t] for r in ranks) / len(ranks)
                         for t in range(len(program["losses"]))]
    values = check.numbers(program, ranks[0]["reference"])
    limits = wl["limits"]
    device = {"platform": "gpu" if "device_kind" in ranks[0] else "cpu",
              "kind": ranks[0].get("device_kind", "cpu"), "count": len(ranks),
              "memory_peak_bytes": max(r.get("memory_peak_bytes", 0) for r in ranks)}
    out = {"correct": check.verdict(values, limits),
           "attempted": ranks[0]["steps"],
           "failed": max(r["failed_steps"] for r in ranks),
           "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = sum(r["trace"]["busy_s"] for r in ranks) / len(ranks)
        device["window_s"] = max(r["trace"]["wall_s"] for r in ranks)
        out["breakdown"] = breakdown(ranks)
    out["checks"] = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return out


def breakdown(ranks: List[Dict]) -> Dict:
    """The traced window's device operations that took most time and its
    longest idle stretches by what the host was doing, rank means."""
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for r in ranks:
        for name, sec, _, _ in r["trace"]["ops"]:
            ops[name] = ops.get(name, 0.0) + sec / len(ranks)
        for label, sec in r["trace"]["idle_gaps"]:
            gaps[label] = gaps.get(label, 0.0) + sec / len(ranks)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:tracing.TOP]]

    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
