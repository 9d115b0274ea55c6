"""BENCHMARK.json against the benchmark's contract, and the parts found by
name: a new configuration, cell or metric is a new file (and an entry in
BENCHMARK.json), with no other file edited."""

import json
import re

import pytest

from kfbench import harness, spec
from kfbench.tests.tinyroot import make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REPO = spec.ROOT.parent


def test_benchmark_json_keeps_the_contract():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["kfbench"] and b["command"] == ["python3", "kfbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(spec.metric_reader(m["name"]))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    pairs = set()
    for w in b["workloads"]:
        own = spec.workload(w["name"])
        assert {k: own[k] for k in ("config", "traffic", "chips", "why")} == {
            k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert set(own["limits"]) <= {"loss_gap", "grad_gap", "change_gap", "median_change_gap"}
        reported = {m["name"] for m in spec.cell_metrics(b, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec.cell_metrics(b, w["name"], True)
    for c in b["configs"]:
        own = json.loads((REPO / c["file"]).read_text())
        assert own["name"] == c["name"] and own["reduced"] == c["reduced"] == []
        assert own["source"] == c["source"]


def test_a_new_config_cell_and_metric_are_found_by_name(tmp_path):
    root = make_root(tmp_path)
    cfg = json.loads((root / "configs" / "bert-tiny.json").read_text())
    cfg.update(name="bert-wide", intermediate_size=192)
    (root / "configs" / "bert-wide.json").write_text(json.dumps(cfg))
    cell = json.loads((root / "workloads" / "bert-tiny.s32.b4.json").read_text())
    cell.update(name="bert-wide.s16.b2", config="bert-wide", traffic="s16.b2")
    cell["mix"].update(seq=16, batch=2)
    (root / "workloads" / "bert-wide.s16.b2.json").write_text(json.dumps(cell))
    (root / "metrics" / "window_steps.py").write_text(
        "def read(record):\n    return record['ranks'][0]['steps']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "Trainer step",
                               "moves": "tokens_per_s", "workloads": ["bert-wide.s16.b2"]})
    bench["end_to_end"][1]["workloads"].append("bert-wide.s16.b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    ranks = [harness.run_rank("bert-wide.s16.b2", 5, 0.2, True, "cpu", root)]
    out = harness.assemble(ranks, "bert-wide.s16.b2", 5, True, ranks[0]["window_start"], bench,
                           root)
    assert out["metrics"]["window_steps"]["value"] == ranks[0]["steps"]
    assert out["correct"]


def test_a_missing_part_is_named():
    with pytest.raises(FileNotFoundError):
        spec.workload("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric.resnet")


def test_a_split_quantity_shares_its_reader():
    assert spec.metric_reader("mfu.bert").__module__ == spec.metric_reader("mfu").__module__
    assert spec.metric_reader("mfu.resnet").__module__ == spec.metric_reader("mfu").__module__
    assert spec.metric_reader("norm_ms.resnet").__module__.endswith("norm_ms_resnet")
