"""On the card, at each cell's own size: the control (the reference in
the program's place, its bf16 products in fp8 and its f32 head in bf16)
fails the cell's limits on three seeds. Skips without a CUDA card; run
on the card with

    python -m pytest kfbench/tests/test_kfbench_cuda.py -m cuda
"""

import pytest
import torch

from kfbench import check, harness, spec

SEEDS = (2**31 + 1001, 2**31 + 1002, 2**31 + 1003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl = spec.workload(cell)
    cfg = spec.config(wl["config"])
    device = torch.device("cuda", 0)
    for seed in SEEDS:
        ref = harness.replay(cfg, wl, seed, wl["chips"], device)
        ctrl = harness.replay(cfg, wl, seed, wl["chips"], device, precision="control")
        values = check.numbers(ctrl, ref)
        assert not check.verdict(values, wl["limits"]), (seed, values)
