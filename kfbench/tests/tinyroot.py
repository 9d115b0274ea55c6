"""A copy of the benchmark's data at CPU size: the tiny configurations and
cells of kfbench/tests/tiny, the real metric readers, and a BENCHMARK.json
whose metrics are the real one's with each cell renamed to its tiny twin."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from kfbench import spec

TINY = Path(__file__).resolve().parent / "tiny"
TWIN = {"resnet50.b256": "resnet-tiny.b4", "resnet50.b256.x4": "resnet-tiny.b4.x4",
        "bert-base.s512.b32": "bert-tiny.s32.b4"}


def make_root(dst: Path) -> Path:
    """Lay the tiny benchmark out under `dst`; returns its kfbench folder."""
    root = dst / "kfbench"
    shutil.copytree(spec.ROOT / "metrics", root / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(TINY / "configs", root / "configs")
    shutil.copytree(TINY / "workloads", root / "workloads")
    bench = spec.benchmark()

    def rename(cells):
        return [TWIN[c] for c in cells]

    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = rename(m["workloads"])
    for w in bench["workloads"]:
        w["name"] = TWIN[w["name"]]
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
