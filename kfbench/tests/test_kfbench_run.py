"""Whole runs on the CPU at tiny sizes, through kfbench/run.py as the
driver calls it (with the rehearsal's device and folder of cells): the
last line's keys, the exit without a card, and that no run loads JAX or
the JAX package (top-level names compared whole)."""

import ast
import json
import os
import subprocess
import sys

import pytest

from kfbench import spec
from kfbench.tests.tinyroot import make_root

REPO = spec.ROOT.parent
RUN = str(spec.ROOT / "run.py")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, cell, trace, *extra, seed=2**31 + 7):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, RUN, "--workload", cell, "--seed", str(seed),
                           "--seconds", "0.5", "--trace", str(trace), "--device", "cpu",
                           "--root", str(root), *extra], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("cell,trace", [("resnet-tiny.b4", 0), ("bert-tiny.s32.b4", 1)])
def test_last_line_keys(tmp_path, cell, trace):
    root = make_root(tmp_path)
    p = _run(root, cell, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert ("breakdown" in out) == bool(trace)
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"setup_s", "step_ms_p95"} <= set(out["metrics"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    tail = p.stderr.strip().splitlines()[-len(out["checks"]):]
    assert [line.split()[1] for line in tail] == list(out["checks"])


@pytest.mark.parametrize("trace", [0, 1])
def test_four_ranks_over_kfrun(tmp_path, trace):
    root = make_root(tmp_path)
    p = _run(root, "resnet-tiny.b4.x4", trace)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["count"] == 4
    if trace:  # no device operation on the CPU: busy-time readers stay silent
        assert {"dispatch_ms.resnet", "mfu.resnet"} <= set(out["metrics"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert out["metrics"]["images_per_s"]["value"] > 0


def test_no_card_no_result():
    p = subprocess.run([sys.executable, RUN, "--workload", "resnet50.b256", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = ("import sys, json; sys.argv=['x']; sys.path.insert(0, %r);"
            "from kfbench import harness, spec; import kfbench.jobs.resnet, kfbench.jobs.bert;"
            "print(json.dumps(harness.forbidden_modules()))" % str(REPO))
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    from kfbench import harness

    monkeypatch.setitem(sys.modules, "kungfu_tpu_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib"]


def test_the_references_import_nothing_of_the_program():
    for path in (spec.ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("kungfu_tpu_torch", "kungfu_tpu", "jax"), (path, n)
    code = ("import sys; sys.path.insert(0, %r); import kfbench.reference.resnet, "
            "kfbench.reference.bert, kfbench.traffic.images, kfbench.traffic.mlm;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'kungfu_tpu_torch', 'kungfu_tpu', 'jax'}))" % str(REPO))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.stdout.strip() == "[]", p.stderr
