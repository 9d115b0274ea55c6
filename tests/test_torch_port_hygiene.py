"""Boundaries of the port: kungfu_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package; entry points default to the CUDA card and raise
without one; CPU tensors never reach a CUDA kernel wrapper."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import kungfu_tpu_torch
from kungfu_tpu_torch.ops import flash_attention as tfa

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import kungfu_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kungfu_tpu_torch.__path__, "kungfu_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "kungfu_tpu")
             or m.startswith(("jax.", "jaxlib.", "kungfu_tpu.")))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "kungfu_tpu_torch.ops.flash_attention" in res["imported"]
    assert "kungfu_tpu_torch.examples.bert_ssgd" in res["imported"]
    assert "kungfu_tpu_torch.ops.ring_attention" in res["imported"]
    assert "kungfu_tpu_torch.models.resnet" in res["imported"]
    assert "kungfu_tpu_torch.bench" in res["imported"]
    for mod in ("graft_entry", "monitor.noise_scale", "monitor.grad_variance", "ops.moe",
                "parallel.pipeline", "parallel.sharded"):
        assert f"kungfu_tpu_torch.{mod}" in res["imported"]
    assert len(res["imported"]) >= 28


def test_every_module_of_the_slice_exists():
    names = {m.name for m in pkgutil.walk_packages(kungfu_tpu_torch.__path__,
                                                   "kungfu_tpu_torch.")}
    for mod in ("ops._build", "ops.flash_attention", "ops.ring_attention",
                "ops.collective", "base.ops",
                "models.transformer", "models.convert", "parallel.distributed",
                "parallel.mesh", "parallel.dp", "optimizers.core", "initializer",
                "examples.bert_ssgd", "optimizers", "models.resnet", "models.mlp",
                "datasets", "datasets.idx", "examples.mnist_slp", "bench", "graft_entry",
                "monitor", "monitor.noise_scale", "monitor.grad_variance", "ops.moe",
                "parallel.pipeline", "parallel.sharded"):
        assert f"kungfu_tpu_torch.{mod}" in names
    assert (REPO / "kungfu_tpu_torch" / "csrc" / "flash_attention.cu").is_file()
    assert (REPO / "chip_smoke.py").is_file()


def _entry_points():
    from kungfu_tpu_torch import bench, graft_entry
    from kungfu_tpu_torch.examples import bert_ssgd, mnist_slp
    from kungfu_tpu_torch.monitor.noise_scale import gns_init
    from kungfu_tpu_torch.models.mlp import init_mlp
    from kungfu_tpu_torch.models.resnet import init_resnet, resnet18_thin
    from kungfu_tpu_torch.models.transformer import TransformerConfig, init_transformer
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.mesh import make_mesh

    return {
        "resolve_device": lambda: kungfu_tpu_torch.resolve_device(),
        "init_transformer": lambda: init_transformer(TransformerConfig.tiny()),
        "initialize_device_plane": lambda: initialize_device_plane(environ={}),
        "make_mesh": lambda: make_mesh(),
        "make_mesh_2d": lambda: make_mesh(shape={"dp": 1, "sp": 1}),
        "bert_ssgd.main": lambda: bert_ssgd.main(["--steps", "1", "--batch", "2"]),
        "init_resnet": lambda: init_resnet(resnet18_thin()),
        "init_mlp": lambda: init_mlp(),
        "mnist_slp.main": lambda: mnist_slp.main(["--epochs", "1"]),
        "bench.main": lambda: bench.main(["--batch", "2", "--image-size", "32"]),
        "graft_entry.entry": lambda: graft_entry.entry(),
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(2),
        "gns_init": lambda: gns_init(),
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_transformer",
                                  "initialize_device_plane", "make_mesh", "make_mesh_2d",
                                  "bert_ssgd.main", "init_resnet", "init_mlp",
                                  "mnist_slp.main", "bench.main", "graft_entry.entry",
                                  "dryrun_multichip", "gns_init"])
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_cpu_tensors_never_reach_the_kernels():
    tfa.reset_launches()
    q, k, v = (torch.randn(1, 2, 64, 64, requires_grad=True) for _ in range(3))
    tfa.flash_attention(q, k, v).sum().backward()
    assert tfa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}
    # the CUDA wrapper itself refuses CPU tensors before any launch
    flat = [t.detach().reshape(2, 64, 64).bfloat16() for t in (q, k, v)]
    with pytest.raises(ValueError, match="cpu"):
        tfa._forward_cuda(*flat, True, 0.125)
    assert tfa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}


@pytest.mark.parametrize("bad", ["head_dim", "dtype"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(bad):
    hd, dt = (32, torch.bfloat16) if bad == "head_dim" else (64, torch.float32)
    q = torch.zeros(2, 64, hd, dtype=dt)
    with pytest.raises((ValueError, TypeError)):
        tfa._forward_cuda(q, q, q, True, 0.125)


@pytest.mark.parametrize("backend,cards,refused", [
    ("nccl", [0, 0], True),   # two ranks of one host on one card
    ("nccl", [0, 1, 0], True),
    ("nccl", [0, 1], False),
    ("gloo", [0, 0], False),  # gloo may share a card
])
def test_nccl_refuses_two_ranks_on_one_card(backend, cards, refused):
    from kungfu_tpu_torch.parallel.distributed import check_card_sharing

    ranks = [4 + i for i in range(len(cards))]
    if not refused:
        check_card_sharing(backend, ranks, cards)
        return
    with pytest.raises(ValueError, match=r"ranks 4 and \d+ are both on card cuda:0"):
        check_card_sharing(backend, ranks, cards)
