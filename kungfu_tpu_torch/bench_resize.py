"""Benchmark: elastic resize latency on a localhost cluster.

Port of `bench_resize.py`. Run it:

  python -m kungfu_tpu_torch.bench_resize [--device cpu]

Prints ONE JSON line:
  {"metric": "elastic_resize_latency", "value": N, "unit": "ms", ...}

Parity: the reference's resize-latency harness ("resize %d -> %d took %s",
benchmarks/adaptation/adaptive_trainer.py:98-103 + the ResizeProfiler in
experimental/hook/elastic.py), BASELINE.md's second north-star metric.
Latency = wall time of one propose->consensus->respawn->rejoin->barrier
cycle as observed by a surviving worker (from calling resize to the new
session's first completed collective).

The port's kfrun (`-w -warm-spares 2`, a built-in config server) starts
2 workers of the agent below on 4 slots; rank 0 walks them through
`SIZES`, one size every `STEPS_PER_EPOCH` steps of `SLEEP_S` each. The
agents hold no tensors: the benchmark times the host plane's resize on
the host of `--device` (default: the CUDA card's). Its ports lie in
12000-19999, outside kfrun's default 38000-38999.

vs_baseline: the reference publishes no number; the measured value is
reported with vs_baseline=1.0 as the self-referenced anchor.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from typing import List, Optional

from kungfu_tpu_torch import resolve_device
from kungfu_tpu_torch.runner.cli import free_port_range, free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [2, 3, 4, 2, 3, 4, 2]
STEPS_PER_EPOCH = 10
SLEEP_S = 0.4
TIMEOUT_S = 300

AGENT = r'''
import os, sys, time
_t_start = time.monotonic()
_t_act = float(os.environ.get("KF_ACTIVATED_TS", 0) or 0)
from kungfu_tpu_torch import api
from kungfu_tpu_torch.elastic.state import ElasticState
_t_imports = time.monotonic()
if _t_act:
    print(f"JOINER wakeup={((_t_start-_t_act)*1e3):.1f} ms"
          f" imports={((_t_imports-_t_start)*1e3):.1f} ms", flush=True)

SIZES = __SIZES__
EPOCH = __EPOCH__
es = ElasticState(max_progress=len(SIZES) * EPOCH)
_su = api.trace_summary()
if _su.get("worker.startup"):
    print(
        f"JOINSTART {_su['worker.startup']:.1f} ms"
        f" parse={_su.get('worker.parse_config', 0):.1f}"
        f" init={_su.get('worker.peer_init', 0):.1f}"
        f" server={_su.get('worker.start.server', 0):.1f}"
        f" update={_su.get('worker.start.update', 0):.1f}",
        flush=True,
    )
while not es.stopped():
    with es.scope():
        rank, size = api.current_rank(), api.cluster_size()
        step = es.progress
        if step % EPOCH == 0 and rank == 0:
            target = SIZES[(step // EPOCH) % len(SIZES)]
            if target != size:
                api.propose_new_size(target)
        time.sleep(__SLEEP__)  # stand-in for a real train step: preemption-driven
        # resizes are minutes apart in the BASELINE scenario, so warm
        # spares have warmed by the time a join needs one
        t0 = time.perf_counter()
        before = size
        es.end(1)
        # es.end ran resize(); if membership changed, the new session's
        # barrier already completed inside _update_to -> this is the full
        # resize cost as seen by a survivor
        if not es.stopped() and api.cluster_size() != before:
            dt = (time.perf_counter() - t0) * 1000
            import json as _json
            phases = _json.dumps(api.last_resize_phases())
            print(f"RESIZE {before} -> {api.cluster_size()} took {dt:.1f} ms"
                  f" phases={phases}", flush=True)
print(f"done rank={api.current_rank()} reason={es.stop_reason}", flush=True)
'''


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="the device whose host is measured (default: the CUDA card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the resize schedule once; print and return the JSON result
    (exit 1 on a failed run or no resize)."""
    resolve_device(parse_args(argv).device)
    agent = (AGENT.replace("__SIZES__", repr(list(SIZES)))
             .replace("__EPOCH__", str(STEPS_PER_EPOCH)).replace("__SLEEP__", repr(SLEEP_S)))
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(agent)
        agent_path = f.name
    env = {k: v for k, v in os.environ.items() if not k.startswith("KF_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    base = free_port_range(4)
    try:
        r = subprocess.run(
            [
                sys.executable, "-m", "kungfu_tpu_torch.runner.cli",
                "-np", "2",
                "-H", "127.0.0.1:4",
                "-w",
                "-warm-spares", "2",
                "-builtin-config-port", "0",
                "-port-range", f"{base}-{base + 3}",
                "-runner-port", str(free_ports(1)[0]),
                "-monitor-port", "0",
                "--", sys.executable, agent_path,
            ],
            env=env, capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO,
        )
    finally:
        os.unlink(agent_path)
    lat = [float(m) for m in re.findall(r"took ([0-9.]+) ms", r.stdout)]
    # per-phase medians (wait_config / consensus / notify / update)
    phase_samples: dict = {}
    for m in re.findall(r"phases=(\{[^}]*\})", r.stdout):
        for k, v in json.loads(m).items():
            phase_samples.setdefault(k, []).append(float(v))
    phase_medians = {
        k: sorted(v)[len(v) // 2] for k, v in sorted(phase_samples.items())
    }
    # the joiners' own clocks: standby wake-up and imports, then the
    # worker's start to a ready Peer (JOINSTART)
    join_samples = {"wakeup_ms": re.findall(r"wakeup=([0-9.]+) ms", r.stdout),
                    "imports_ms": re.findall(r"imports=([0-9.]+) ms", r.stdout),
                    "startup_ms": re.findall(r"JOINSTART ([0-9.]+) ms", r.stdout)}
    join_medians = {k: sorted(map(float, v))[len(v) // 2] for k, v in join_samples.items() if v}
    if r.returncode != 0 or not lat:
        out = {
            "metric": "elastic_resize_latency",
            "value": -1,
            "unit": "ms",
            "vs_baseline": 0,
            "error": (r.stdout + r.stderr)[-400:],
        }
        print(json.dumps(out))
        sys.exit(1)
    lat.sort()
    median = lat[len(lat) // 2]
    out = {
        "metric": "elastic_resize_latency",
        "value": round(median, 1),
        "unit": "ms",
        "vs_baseline": 1.0,
        "n_resizes": len(lat),
        "min_ms": round(lat[0], 1),
        "max_ms": round(lat[-1], 1),
        "phase_median_ms": phase_medians,
        "join_median_ms": join_medians,
        "joins": len(join_samples["startup_ms"]),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
