"""Boundaries of the port: kungfu_tpu_torch and chip_smoke.py import neither
JAX, ml_dtypes nor the JAX package; entry points default to the CUDA card
and raise without one; CPU tensors never reach a CUDA kernel wrapper."""

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
# the host plane's framework-free core
HOST_PLANE_MODULES = ("knobs", "telemetry.log", "utils.log", "base.dtype", "base.strategy",
                      "base.ops", "base._native", "base.workspace", "base.serialize",
                      "plan.peer", "plan.hostspec", "plan.cluster", "plan.graph",
                      "plan.topology", "plan.mst", "plan.replan", "collective.strategies",
                      "utils.state", "utils.handoff", "utils.pool", "utils.stall",
                      # the host plane over its transport
                      "utils.trace", "transport", "transport.message", "transport._native_io",
                      "transport.shm", "transport.server", "transport.client",
                      "transport.handlers", "store", "store.versioned", "runner", "runner.env",
                      "collective.codec", "collective.profiler", "collective.adaptive",
                      "collective.walks", "collective.pipeline", "collective.host_session",
                      "peer", "api",
                      # the asynchronous host plane and the torch frontend on it
                      "collective.scheduler", "collective.zero", "torch",
                      "examples.bert_sma",
                      # elastic membership: the runner, the config server and
                      # the elastic training loop
                      "runner.proc", "runner.slots", "runner.affinity", "runner.platform",
                      "runner.cli", "runner.monitored", "runner.standby", "runner.watch",
                      "runner.distribute", "cmd", "elastic", "elastic.configserver",
                      "elastic.schedule", "elastic.dataset", "elastic.state",
                      "examples.elastic_train",
                      # checkpoints, PairAveraging, the hierarchical all-reduce
                      "elastic.checkpoint", "examples.adaptive_batch", "bench_resize",
                      "optimizers.pair_averaging", "examples.cyclegan_pair",
                      "ops.hierarchical", "examples.multislice_train",
                      # the telemetry core and the network monitors
                      "telemetry", "telemetry.config", "telemetry.metrics",
                      "telemetry.tracing", "telemetry.audit", "telemetry.promparse",
                      "telemetry.http", "monitor.net", "monitor.latency",
                      # measured topology
                      "transport.shaping", "telemetry.link", "telemetry.decisions",
                      "policy",
                      # run-level forensics
                      "telemetry.straggler", "telemetry.steptrace", "telemetry.flight",
                      "telemetry.cluster", "monitor",
                      # the resource and memory planes
                      "telemetry.resource", "telemetry.memory")
# the tooling twins: benchmarks, info, the A/B benches, the debug tools
TOOLING_MODULES = ("models.fake", "devtools", "devtools.lockwatch", "devtools.protowatch",
                   "info", "info.__main__", "benchmarks", "benchmarks.__main__", "bench_hier",
                   "bench_wire_q",
                   # the static analyzer and its gate
                   "devtools.check", "devtools.kfcheck", "devtools.kfcheck.core",
                   "devtools.kfcheck.rules", "devtools.kfcheck.__main__")

_PROBE = r"""
import importlib, json, pkgutil, sys
import kungfu_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kungfu_tpu_torch.__path__, "kungfu_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "kungfu_tpu", "ml_dtypes")
             or m.startswith(("jax.", "jaxlib.", "kungfu_tpu.", "ml_dtypes.")))
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
                "parallel.pipeline", "parallel.sharded") + HOST_PLANE_MODULES + TOOLING_MODULES:
        assert f"kungfu_tpu_torch.{mod}" in res["imported"]
    assert len(res["imported"]) >= 28 + len(HOST_PLANE_MODULES) + len(TOOLING_MODULES)


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
                "parallel.pipeline", "parallel.sharded") + HOST_PLANE_MODULES + TOOLING_MODULES:
        assert f"kungfu_tpu_torch.{mod}" in names
    assert (REPO / "kungfu_tpu_torch" / "csrc" / "flash_attention.cu").is_file()
    for src in ("reduce.cpp", "mst.cpp", "io_pump.cpp", "pdeathsig.c"):
        assert (REPO / "kungfu_tpu_torch" / "csrc" / "host" / src).is_file()
    assert (REPO / "chip_smoke.py").is_file()


def test_the_frontend_subpackage_leaves_resolve_device_working():
    """Importing `kungfu_tpu_torch.torch` sets the package attribute
    `torch`: the package's own module-level names must not be that."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import kungfu_tpu_torch, kungfu_tpu_torch.torch as f\n"
         "assert kungfu_tpu_torch.torch is f\n"
         "print(kungfu_tpu_torch.resolve_device('cpu'))"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "cpu"


def _entry_points():
    from kungfu_tpu_torch import bench, graft_entry
    from kungfu_tpu_torch import bench_resize
    from kungfu_tpu_torch.elastic.checkpoint import Checkpointer
    from kungfu_tpu_torch.examples import adaptive_batch, cyclegan_pair, multislice_train
    from kungfu_tpu_torch.examples import bert_sma, bert_ssgd, elastic_train, mnist_slp
    from kungfu_tpu_torch.ops.hierarchical import make_hier_train_step
    from kungfu_tpu_torch.monitor.noise_scale import gns_init
    from kungfu_tpu_torch.models.mlp import init_mlp
    from kungfu_tpu_torch.models.resnet import init_resnet, resnet18_thin
    from kungfu_tpu_torch.models.transformer import TransformerConfig, init_transformer
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.parallel.mesh import make_mesh
    from kungfu_tpu_torch.benchmarks.__main__ import bench_gns, bench_xla

    return {
        "resolve_device": lambda: kungfu_tpu_torch.resolve_device(),
        "init_transformer": lambda: init_transformer(TransformerConfig.tiny()),
        "initialize_device_plane": lambda: initialize_device_plane(environ={}),
        "make_mesh": lambda: make_mesh(),
        "make_mesh_2d": lambda: make_mesh(shape={"dp": 1, "sp": 1}),
        "bert_ssgd.main": lambda: bert_ssgd.main(["--steps", "1", "--batch", "2"]),
        "bert_sma.main": lambda: bert_sma.main(["--steps", "1", "--batch", "2"]),
        "init_resnet": lambda: init_resnet(resnet18_thin()),
        "init_mlp": lambda: init_mlp(),
        "mnist_slp.main": lambda: mnist_slp.main(["--epochs", "1"]),
        "bench.main": lambda: bench.main(["--batch", "2", "--image-size", "32"]),
        "graft_entry.entry": lambda: graft_entry.entry(),
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(2),
        "gns_init": lambda: gns_init(),
        "elastic_train.main": lambda: elastic_train.main(["--samples", "64"]),
        "Checkpointer": lambda: Checkpointer("unused-checkpoint-dir"),
        "adaptive_batch.main": lambda: adaptive_batch.main(["--steps", "1"]),
        "bench_resize.main": lambda: bench_resize.main([]),
        "cyclegan_pair.main": lambda: cyclegan_pair.main(["--steps", "1"]),
        "multislice_train.main": lambda: multislice_train.main(["--steps", "1"]),
        "make_hier_train_step": lambda: make_hier_train_step(
            lambda b: b, torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1)),
        "benchmarks.bench_xla": lambda: bench_xla("tiny", 1),
        "benchmarks.bench_gns": lambda: bench_gns(1),
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_transformer",
                                  "initialize_device_plane", "make_mesh", "make_mesh_2d",
                                  "bert_ssgd.main", "bert_sma.main", "init_resnet", "init_mlp",
                                  "mnist_slp.main", "bench.main", "graft_entry.entry",
                                  "dryrun_multichip", "gns_init", "elastic_train.main",
                                  "Checkpointer", "adaptive_batch.main", "bench_resize.main",
                                  "cyclegan_pair.main", "multislice_train.main",
                                  "make_hier_train_step", "benchmarks.bench_xla",
                                  "benchmarks.bench_gns"])
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


def _refused_worker(rank, peers, delay, out_dir):
    """One rank through the NCCL rendezvous on the CPU (the store and the
    card check need no card), rank 1 descheduled for `delay` s before each
    read of the store; writes what it raised."""
    import os
    import time

    import torch.distributed as dist

    from kungfu_tpu_torch.parallel import distributed as d

    os.environ.update(KF_SELF_SPEC=peers[rank], KF_INIT_PEERS=",".join(peers),
                      KF_DEVICE_SLOTS="0")
    if rank == 1:
        get = dist.TCPStore.get
        dist.TCPStore.get = lambda self, key: (time.sleep(delay), get(self, key))[1]
    spec = d.parse_worker_env()
    try:
        d._join(spec, torch.device("cuda", 0), "nccl", *d.rendezvous_address(spec))
        got = "no error"
    except Exception as e:  # noqa: BLE001 - the test reads what was raised
        got = f"{type(e).__name__}: {e}"
    (Path(out_dir) / f"rank{rank}").write_text(got)


@pytest.mark.parametrize("delay", [0.0, 0.5])
def test_a_slow_rank_still_sees_the_refusal(delay, tmp_path):
    """Rank 0 serves the rendezvous store and refuses first: the store
    stays up until rank 1 has read the cards, so a rank 1 that reads late
    gets the same ValueError, not a closed connection."""
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    spawn_world(_refused_worker, 2, 120, args=(delay, str(tmp_path)))
    for rank in range(2):
        got = (tmp_path / f"rank{rank}").read_text()
        assert got.startswith("ValueError: ranks 0 and 1 are both on card cuda:0"), got


def test_no_module_of_the_port_names_the_jax_package_ml_dtypes_or_jax():
    """Beyond what the import probe sees: no source of the port imports
    them, even inside a function."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ml_dtypes|kungfu_tpu)\b", re.M)
    sources = sorted((REPO / "kungfu_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_startup_probe.py"]
    assert len(sources) > 40
    offenders = [str(p.relative_to(REPO)) for p in sources if pattern.search(p.read_text())]
    assert offenders == []
