"""The slice as a whole: the host all-reduce of k simulated peers replayed
in one process (chip_smoke's `ring_replay` and `graph_replay`) through the
JAX package's host functions and through the port's, on ~10^5 seeded f32
values a peer. The segmented ring in f32, with the bf16 wire and with the
int8 wire, and the default strategy's graph pair, for k = 2, 3, 4: the
final buffers byte-equal across the two packages and to the port's plain
twins, every peer holding the same bits, and the sum within the wire's
limit (tests/test_wire_codec.py and tests/test_wire_q.py's)."""

import subprocess
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from kungfu_tpu.base import ops as rops
from kungfu_tpu.base.dtype import DType as RDType
from kungfu_tpu.collective.strategies import gen_global_strategies as r_gen_global
from kungfu_tpu.plan.peer import PeerID as RPeerID, PeerList as RPeerList
from kungfu_tpu_torch.base import ops
from kungfu_tpu_torch.base.dtype import DType
from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY
from kungfu_tpu_torch.collective.strategies import gen_global_strategies
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.plan.peer import PeerID, PeerList

REPO = Path(__file__).resolve().parent.parent
N = 100_003
WIRES = {"f32": (None, None, 0.0), "bf16": (DType.BF16, RDType.BF16, 2.0 ** -8),
         "int8": (ops.QWire(8, 16), rops.QWire(8, 16), 2.0 / 127.0)}


@pytest.fixture(scope="module")
def ref_ops(tmp_path_factory):
    """The JAX package's host functions on their C++ path (its own
    native/reduce.cpp behind its own loader, built afresh), as a replay's
    namespace over numpy buffers."""
    d = tmp_path_factory.mktemp("kfnative")
    subprocess.run([_build.find_cxx(), "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", "-o", str(d / "libkfnative.so"),
                    str(REPO / "native" / "reduce.cpp")], check=True, capture_output=True)
    native = types.ModuleType("reference_native_reduce")
    native.__file__ = str(d / "_native_reduce.py")
    src = (REPO / "kungfu_tpu" / "base" / "_native_reduce.py").read_text()
    exec(compile(src, native.__file__, "exec"), native.__dict__)
    return native, SimpleNamespace(
        reduce_segment=rops.reduce_segment, copy_segment=rops.copy_segment,
        transform_n=rops.transform_n, encode=rops.encode_wire_any,
        decode=rops.decode_wire_any, decode_accumulate=rops.decode_accumulate_any,
        empty=lambda count, dtype: np.empty(count, dtype))


def _grads(k: int):
    """Gradient-like inputs: mixed signs over four orders of magnitude."""
    rng = np.random.default_rng(40 + k)
    scale = 10.0 ** rng.integers(-4, 0, N)
    return [(rng.normal(0, 1, N) * scale).astype(np.float32) for _ in range(k)]


def _check(outs, ref_outs, plain_outs, xs, eps: float) -> None:
    for o, r, p in zip(outs, ref_outs, plain_outs):
        np.testing.assert_array_equal(o.numpy().view(np.uint32), r.view(np.uint32))
        np.testing.assert_array_equal(p.numpy().view(np.uint32), r.view(np.uint32))
        np.testing.assert_array_equal(o.numpy().view(np.uint32),
                                      outs[0].numpy().view(np.uint32))
    total = np.sum(np.stack(xs).astype(np.float64), axis=0)
    err = np.abs(outs[0].numpy().astype(np.float64) - total)
    if eps:  # the reference's wire limit: 2 max|sum| eps
        assert err.max() <= 2 * np.abs(total).max() * eps
    else:  # f32: the summation orders' bound, 2 (k - 1) u sum|x|
        k = len(xs)
        bound = 2 * (k - 1) * 2.0 ** -24 * np.sum(np.abs(np.stack(xs)), axis=0, dtype=np.float64)
        assert np.all(err <= bound)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_ring_replay_is_byte_equal_across_packages(mode, k, ref_ops, monkeypatch):
    native, rns = ref_ops
    monkeypatch.setattr(rops, "_native", native)
    wire, rwire, eps = WIRES[mode]
    xs = _grads(k)
    ref_outs = chip_smoke.ring_replay([x.copy() for x in xs], rns, rwire)
    outs = chip_smoke.ring_replay([torch.from_numpy(x.copy()) for x in xs],
                                  chip_smoke.host_ops(), wire)
    plain = chip_smoke.ring_replay([torch.from_numpy(x.copy()) for x in xs],
                                   chip_smoke.host_ops(plain=True), wire)
    _check(outs, ref_outs, plain, xs, eps)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_default_strategy_replay_is_byte_equal_across_packages(k, ref_ops, monkeypatch):
    native, rns = ref_ops
    monkeypatch.setattr(rops, "_native", native)
    xs = _grads(k)
    (pair,) = gen_global_strategies(PeerList(PeerID("h", 38000 + r) for r in range(k)),
                                    DEFAULT_STRATEGY)
    (rpair,) = r_gen_global(RPeerList(RPeerID("h", 38000 + r) for r in range(k)),
                            DEFAULT_STRATEGY)
    assert pair.digest() == rpair.digest()
    ref_outs = chip_smoke.graph_replay(xs, rpair, rns)
    outs = chip_smoke.graph_replay([torch.from_numpy(x) for x in xs], pair,
                                   chip_smoke.host_ops())
    plain = chip_smoke.graph_replay([torch.from_numpy(x) for x in xs], pair,
                                    chip_smoke.host_ops(plain=True))
    _check(outs, ref_outs, plain, xs, 0.0)
    ring = chip_smoke.ring_replay([torch.from_numpy(x.copy()) for x in xs],
                                  chip_smoke.host_ops())
    _check(ring, [o.numpy() for o in ring], ring, xs, 0.0)
