"""Read the numbers `correct` compares, at a cell's own size, for the
limits in its workload file: the program's sound first steps over many
seeds (the lower readings), the control (the reference put in the
program's place, its bf16 products in fp8 and its f32 head in bf16), any
other precision of reference/common.PRECISIONS, and each planted fault
(the upper readings).

    python3 kfbench/tests/calibrate.py --workload resnet50.b256 \\
        --seeds 11,12,13 --checked 3 --precisions control,bf16_head \\
        --faults half_batch --out cal.json

The first `--checked` seeds also read each precision and fault. A
cell on several cards runs one process per card (NCCL); rank 0 runs the
reference. `--reference-only` reads the precisions alone, against the
reference at the cell's world, in one process on one card. The
benchmark's own runs never run this.
"""

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch.distributed as dist  # noqa: E402

from kfbench import check, harness, spec  # noqa: E402
from kfbench.tests import faults  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--checked", type=int, default=3,
                   help="how many of the seeds also read the precisions and the faults")
    p.add_argument("--precisions", default="control",
                   help="comma-separated, of reference/common.PRECISIONS")
    p.add_argument("--reference-only", action="store_true",
                   help="read the precisions alone, without the program")
    p.add_argument("--faults", default="", help="comma-separated, of " + ", ".join(faults.FAULTS))
    p.add_argument("--out", required=True)
    p.add_argument("--device", default=None)
    p.add_argument("--root", default=None)
    return p.parse_args(argv)


def _worst(program, reference, key, keys, n=3):
    """The `n` leaves with the widest gap of `key` norms: (leaf, gap, the
    reference's norm, the program's), and the median leaf's gap."""
    ref = reference[key]
    floor = statistics.median(ref[k] for k in keys)
    gaps = sorted(((abs(program[key].get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30), k)
                   for k in keys),
                  reverse=True)
    top = [[k, g, ref[k], program[key].get(k, 0.0)] for g, k in gaps[:n]]
    return {"worst": top, "median_gap": statistics.median(g for g, _ in gaps), "floor": floor}


def look(program, reference):
    out = set(check.left_out(reference))
    return {"grad": _worst(program, reference, "grad_norms", list(reference["grad_norms"])),
            "change": _worst(program, reference, "change_norms",
                             [k for k in reference["change_norms"] if k not in out])}


def _program(cfg, wl, seed, device, session, fault):
    with faults.planted(fault):
        job = spec.family("jobs", cfg["family"]).build(cfg, wl, seed, device, session)
        readings = harness.program_readings(harness.first_steps(job))
    del job
    if session.size > 1:
        every = [None] * session.size
        dist.all_gather_object(every, readings["losses"])
        readings["losses"] = [sum(x) / len(x) for x in zip(*every)]
    return readings


def rank_main(args, world: int) -> None:
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    root = Path(args.root) if args.root else spec.ROOT
    wl = spec.workload(args.workload, root)
    cfg = spec.config(wl["config"], root)
    device = initialize_device_plane(args.device)
    session = make_mesh(device)
    seeds = [int(s) for s in args.seeds.split(",")]
    kinds = [f for f in args.faults.split(",") if f]
    precisions = [p for p in args.precisions.split(",") if p]
    rows = []
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        runs = {} if args.reference_only else {None: _program(cfg, wl, seed, device, session, None)}
        if n < args.checked and not args.reference_only:
            for fault in kinds:
                runs[fault] = _program(cfg, wl, seed, device, session, fault)
        if session.rank == 0:
            ref = harness.replay(cfg, wl, seed, world, device)
            row = {"seed": seed, "left_out": check.left_out(ref), "ref_losses": ref["losses"]}
            if None in runs:
                row.update({"program": check.numbers(runs[None], ref),
                            "program_losses": runs[None]["losses"],
                            "program_look": look(runs[None], ref)})
            for fault in kinds:
                if fault in runs:
                    row[fault] = check.numbers(runs[fault], ref)
            if n < args.checked:
                for precision in precisions:
                    ctrl = harness.replay(cfg, wl, seed, world, device, precision=precision)
                    row[precision] = check.numbers(ctrl, ref)
                    row[f"{precision}_look"] = look(ctrl, ref)
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
        if session.size > 1:
            dist.barrier()
    if session.rank == 0:
        names = list(check.numbers(ref, ref))
        summary = {}
        if not args.reference_only:
            summary["lower"] = {k: max(r["program"][k] for r in rows) for k in names}
        for kind in precisions + kinds:
            got = [r[kind] for r in rows if kind in r]
            if got:
                summary[kind] = {k: min(g[k] for g in got) for k in names}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "summary": summary}, indent=1))
        print(json.dumps(summary), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()


def _spawned(rank, peers, argv):
    os.environ["KF_SELF_SPEC"] = peers[rank]
    os.environ["KF_INIT_PEERS"] = ",".join(peers)
    args = parse_args(argv)
    if args.device is None:
        os.environ["KF_DEVICE_SLOTS"] = str(rank)
    rank_main(args, len(peers))


def main(argv=None):
    args = parse_args(argv)
    root = Path(args.root) if args.root else spec.ROOT
    chips = spec.workload(args.workload, root)["chips"]
    if chips == 1 or args.reference_only:
        rank_main(args, chips)
        return
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    spawn_world(_spawned, chips, 3000, args=(sys.argv[1:] if argv is None else argv,))


if __name__ == "__main__":
    main()
