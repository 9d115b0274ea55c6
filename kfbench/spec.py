"""Where the benchmark finds its parts, by the names BENCHMARK.json and
the workload files give: `configs/<config>.json`, `workloads/<cell>.json`,
`metrics/<metric>.py`, and the family's modules `jobs/`, `costs/`,
`reference/`, the traffic generator's `traffic/`. A part is added by
adding its file; nothing is listed anywhere else."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(path: Path = BENCHMARK) -> Dict:
    return _json(path)


def workload(name: str, root: Path = ROOT) -> Dict:
    out = _json(root / "workloads" / f"{name}.json")
    if out.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {out.get('name')!r}")
    return out


def config(name: str, root: Path = ROOT) -> Dict:
    out = _json(root / "configs" / f"{name}.json")
    if out.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {out.get('name')!r}")
    return out


def family(kind: str, name: str) -> ModuleType:
    """kfbench.<kind>.<name>: a family's job, costs or reference, or a
    traffic generator."""
    return importlib.import_module(f"kfbench.{kind}.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """The `read(record)` function of metrics/<name>.py or, failing that,
    of the file named by the name cut at its last dot, and so on: one
    quantity split by the end-to-end metric it moves (`mfu.resnet`,
    `mfu.bert`) shares metrics/mfu.py."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            break
    else:
        raise FileNotFoundError(f"no reader metrics/{name}.py for metric {name!r}")
    spec = importlib.util.spec_from_file_location(f"kfbench_metric_{path.stem.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: Dict, cell: str, traced: bool) -> List[Dict]:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced. A metric without `workloads` belongs to
    every cell (a per-layer one: every cell that reports what it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in moved)]
