"""The timed path broken underneath: each fault a cell can have makes
`correct` come out false (the state left unchanged, half of the batch
left out, the exchange between ranks left out), and the control, the
reference in the program's place with its bf16 products in fp8 and its
f32 head in bf16, fails a limit.

At the tiny sizes of kfbench/tests/tiny, whose limits were set from
these readings; the cells' own readings on the card are in PERF.md."""

import json
import os

import pytest
import torch

from kfbench import check, harness, spec
from kfbench.tests import faults
from kfbench.tests.tinyroot import TINY, make_root

SEED = 2**31 + 99


def _run(root, cell, fault):
    with faults.planted(fault):
        ranks = [harness.run_rank(cell, SEED, 0.2, False, "cpu", root)]
    bench = spec.benchmark(root.parent / "BENCHMARK.json")
    return harness.assemble(ranks, cell, SEED, False, ranks[0]["window_start"], bench, root)


@pytest.mark.parametrize("cell", ["resnet-tiny.b4", "bert-tiny.s32.b4"])
@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch"])
def test_one_rank_faults_are_not_correct(tmp_path, cell, fault):
    out = _run(make_root(tmp_path), cell, fault)
    assert out["correct"] is (fault is None), out["checks"]


def _rank(rank, peers, root, fault, out):
    os.environ["KF_SELF_SPEC"] = peers[rank]
    os.environ["KF_INIT_PEERS"] = ",".join(peers)
    torch.set_num_threads(1)
    with faults.planted(fault):
        record = harness.run_rank("resnet-tiny.b4.x4", SEED, 0.2, False, "cpu", root)
    (out / f"rank{rank}.json").write_text(json.dumps(record))


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_four_rank_exchange_left_out_is_not_correct(tmp_path, fault):
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    root = make_root(tmp_path)
    spawn_world(_rank, 4, 300, args=(root, fault, tmp_path))
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    bench = spec.benchmark(root.parent / "BENCHMARK.json")
    out = harness.assemble(ranks, "resnet-tiny.b4.x4", SEED, False, ranks[0]["window_start"],
                           bench, root)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("cell", ["resnet-tiny.b4", "bert-tiny.s32.b4"])
def test_the_control_fails_a_limit(cell):
    wl = spec.workload(cell, TINY)
    cfg = spec.config(wl["config"], TINY)
    ref = harness.replay(cfg, wl, SEED, 1, "cpu")
    ctrl = harness.replay(cfg, wl, SEED, 1, "cpu", precision="control")
    assert not check.verdict(check.numbers(ctrl, ref), wl["limits"])
