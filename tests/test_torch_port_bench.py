"""`python -m kungfu_tpu_torch.bench` on the CPU at a tiny size: one JSON
line with the keys of the repo's `bench.py`, and no device metric (MFU)
from a CPU run. The windows are cut to one of two steps here."""

import json

import pytest
import torch

from kungfu_tpu_torch import bench

KEYS = {"metric", "value", "unit", "vs_baseline", "step_ms", "mfu", "mfu_macs",
        "flops_per_img", "device"}


@pytest.fixture(autouse=True)
def _two_threads():
    """Keep torch's CPU work to two threads: the suite runs beside
    multi-process tests that are sensitive to a loaded host."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def short_windows(monkeypatch):
    monkeypatch.setattr(bench, "INNER", 2)
    monkeypatch.setattr(bench, "WARMUP_WINDOWS", 1)
    monkeypatch.setattr(bench, "WINDOWS", 1)


def test_bench_prints_one_json_line_on_cpu(short_windows, capsys):
    out = bench.main(["--device", "cpu", "--batch", "2", "--image-size", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == KEYS and res == out
    assert res["metric"] == "resnet50_ssgd_train_throughput_per_chip"
    assert res["unit"] == "images/sec/chip" and res["device"] == "cpu"
    assert res["value"] > 0 and res["step_ms"] > 0
    assert res["vs_baseline"] == pytest.approx(res["value"] / 350.0)
    assert res["value"] == pytest.approx(2 / (res["step_ms"] / 1e3))
    assert res["mfu"] is None and res["mfu_macs"] is None  # no device metric off the card
    assert res["flops_per_img"] == pytest.approx(24.6 * (32 / 224) ** 2)


def test_bench_trains_and_moves_the_running_statistics(short_windows):
    b = bench.Bench(bench.parse_args(["--device", "cpu", "--batch", "2", "--image-size", "32"]))
    assert b.images.shape == (2, 2, 32, 32, 3) and b.images.dtype == torch.bfloat16
    assert int(b.labels.abs().sum()) == 0
    b.window()
    b.window()
    losses = [float(x) for x in b.losses]
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
    var = b.model.bn_init.var
    assert torch.isfinite(var).all() and not torch.equal(var, torch.ones_like(var))
