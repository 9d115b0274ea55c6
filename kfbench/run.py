"""Run one cell of the benchmark once and print its result line.

    python3 kfbench/run.py --workload resnet50.b256 --seed 7 --seconds 30 --trace 0

The cell is `kfbench/workloads/<workload>.json`; BENCHMARK.json names the
metrics it reports: the end-to-end ones with `--trace 0`, the per-layer
ones with `--trace 1`. A cell on one card runs in this process; a cell on
several runs one worker per card under the program's launcher, kfrun,
which forms the NCCL world, and this process gathers their records.

The last line of standard output is the result (JSON): correct,
attempted, failed, metrics, device (with --trace 1 also busy_s and
window_s, and a breakdown), and last the numbers `correct` compared,
each with its limit; standard error ends with each rank's set-up phases
(seconds from launch) and then the same numbers. Without
enough CUDA cards, or with JAX or the JAX package loaded, it exits with
another code than 0 and prints no result.
"""

import time

T_LAUNCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

WORKERS_TIMEOUT_S = 330
LOG_TAIL = 4000


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the CPU rehearsal of kfbench/tests: a device other than the card and
    # another folder of cells; the benchmark's runs pass neither
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    p.add_argument("--root", default=None, help=argparse.SUPPRESS)
    # a worker of a several-card cell: where to write its record
    p.add_argument("--worker-out", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def launch_workers(args, chips: int, root: Path) -> list:
    """Run the cell's ranks under kfrun, one per card; their records, rank
    0 first."""
    out = tempfile.mkdtemp(prefix="kfbench-ranks-")
    try:
        cmd = [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", str(chips), "-q"]
        if args.device is None:
            cmd += ["-devices-per-host", str(chips)]
        cmd += [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
                "--seed", str(args.seed), "--seconds", str(args.seconds),
                "--trace", str(args.trace), "--worker-out", out, "--root", str(root)]
        if args.device is not None:
            cmd += ["--device", args.device]
        log_path = Path(out) / "kfrun.log"
        with open(log_path, "w") as log:
            rc = subprocess.run(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                                timeout=WORKERS_TIMEOUT_S).returncode
        if rc != 0:
            sys.stderr.write(log_path.read_text()[-LOG_TAIL:])
            raise RuntimeError(f"kfrun exited with {rc}")
        ranks = []
        for r in range(chips):
            with open(Path(out) / f"rank{r}.json") as f:
                ranks.append(json.load(f))
        return ranks
    finally:
        shutil.rmtree(out, ignore_errors=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from kfbench import harness, spec

    root = Path(args.root) if args.root else spec.ROOT
    if args.worker_out is not None:
        record = harness.run_rank(args.workload, args.seed, args.seconds, bool(args.trace),
                                  args.device, root)
        path = Path(args.worker_out) / f"rank{record['rank']}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(record))
        os.replace(tmp, path)
        return 0
    wl = spec.workload(args.workload, root)
    chips = wl["chips"]
    if args.device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"kfbench: {args.workload} needs {chips} CUDA card(s), found {have}",
                  file=sys.stderr)
            return 2
    bench = spec.benchmark(root.parent / "BENCHMARK.json")
    if chips == 1:
        ranks = [harness.run_rank(args.workload, args.seed, args.seconds, bool(args.trace),
                                  args.device, root)]
    else:
        ranks = launch_workers(args, chips, root)
    result = harness.assemble(ranks, args.workload, args.seed, bool(args.trace), T_LAUNCH,
                              bench, root)
    bad = sorted(set(harness.forbidden_modules()).union(
        *(r["forbidden_modules"] for r in ranks)))
    if bad:
        print(f"kfbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for r in ranks:
        marks = " ".join(f"{name} {t - T_LAUNCH:.2f}" for name, t in r["setup_phases"])
        print(f"setup rank {r['rank']}: {marks} window {r['window_start'] - T_LAUNCH:.2f}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
