"""The cost functions against the hand counts: 24.6 GFLOP to train
ResNet-50 on one 224x224 image (three times the forward's 8.2), about
11.1 TFLOP a BERT-base step of 32 x 512 tokens, and the flash kernels'
least times at B*H 96, S 512, hd 64 (PERF.md's table of kernels)."""

import pytest

from kfbench import spec
from kfbench.costs import bert, resnet


def test_resnet50_training_flops_per_image():
    cfg = spec.config("resnet50")
    c = resnet.costs(cfg, {"batch": 1})
    stem_dgrad = 2 * 112 * 112 * 64 * 3 * 7 * 7  # not computed: images need no gradient
    assert (c["train_flops"] + stem_dgrad) == pytest.approx(24.6e9, rel=0.01)
    assert c["conv_bound_s"] > 0


def test_bert_base_step_flops():
    cfg = spec.config("bert-base")
    c = bert.costs(cfg, {"batch": 32, "seq": 512})
    assert c["train_flops"] == pytest.approx(11.1e12, rel=0.01)


def test_flash_bounds_at_the_kernel_table_shape():
    b = bert.flash_bounds(96, 512, 64)
    assert b["flash_fwd"] * 1e3 == pytest.approx(0.00757, rel=1e-3)
    assert b["flash_dq"] * 1e3 == pytest.approx(0.01139, rel=1e-3)
    assert b["flash_dkv"] * 1e3 == pytest.approx(0.01139, rel=1e-3)
    c = bert.costs(spec.config("bert-base"), {"batch": 8, "seq": 512})
    assert c["flash_bwd_bound_s"] == pytest.approx(12 * (b["flash_dq"] + b["flash_dkv"]))
