"""The port's `base/` (dtype, ops with the host C++, workspace, serialize)
against the JAX package's, byte for byte, on the same seeded numpy inputs.

The reference runs the path its engine runs where `libkfnative.so` is
built: its own `native/reduce.cpp`, compiled with `native/build.sh`'s
flags into a private directory and bound by its own loader
(`kungfu_tpu/base/_native_reduce.py`), whatever this checkout holds. Its
numpy fallback is held too where it agrees with its C++ (the wire
codecs). The port's plain twins are held against both.
"""

import subprocess
import types
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from kungfu_tpu.base import ops as rops
from kungfu_tpu.base import serialize as rser
from kungfu_tpu.base.dtype import DType as RDType
from kungfu_tpu.base.workspace import Workspace as RWorkspace
from kungfu_tpu.base.workspace import even_partition as r_even_partition
from kungfu_tpu_torch.base import _native, serialize
from kungfu_tpu_torch.base import ops
from kungfu_tpu_torch.base.dtype import DType
from kungfu_tpu_torch.base.workspace import Workspace, even_partition
from kungfu_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent
OPS = list(ops.ReduceOp)
N = 4099  # odd, not a multiple of any SIMD width


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The JAX package's C++ behind its own ctypes loader, built afresh."""
    d = tmp_path_factory.mktemp("kfnative")
    subprocess.run([_build.find_cxx(), "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", "-o", str(d / "libkfnative.so"),
                    str(REPO / "native" / "reduce.cpp"), str(REPO / "native" / "mst.cpp")],
                   check=True, capture_output=True)
    mod = types.ModuleType("reference_native_reduce")
    mod.__file__ = str(d / "_native_reduce.py")
    src = (REPO / "kungfu_tpu" / "base" / "_native_reduce.py").read_text()
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    assert mod.has_transform_n and mod.has_wire_codec and mod.has_wire_codec_q
    return mod


@pytest.fixture
def ref(ref_native, monkeypatch):
    """`kungfu_tpu.base.ops` on its C++ path."""
    monkeypatch.setattr(rops, "_native", ref_native)
    return rops


def _tt(a: np.ndarray) -> torch.Tensor:
    """A port tensor holding the bytes of numpy array `a` (any dtype,
    bfloat16 included)."""
    t = torch.from_numpy(np.ascontiguousarray(a).view(f"i{a.itemsize}").copy())
    return t.view(serialize.resolve_dtype(a.dtype.name))


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _values(dt: RDType, rng, n: int = N) -> np.ndarray:
    """Seeded finite values of `dt`: the whole range of an integer type,
    normals (and, in f16, ties of every sum) for the floats."""
    npdt = dt.to_numpy()
    if np.issubdtype(npdt, np.integer):
        info = np.iinfo(npdt)
        return rng.integers(info.min, info.max, n, dtype=npdt, endpoint=True)
    return rng.normal(0, 3, n).astype(np.float32).astype(npdt)


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rdt", list(RDType), ids=lambda d: d.name)
def test_dtype_codes_sizes_and_names_match(rdt):
    dt = DType[rdt.name]
    assert int(dt) == int(rdt) and dt.size == rdt.size
    assert DType.from_torch(dt.to_torch()) is dt
    assert dt.to_torch().itemsize == dt.size
    assert DType.from_numpy(rdt.to_numpy()) is dt  # bfloat16 by its ml_dtypes name
    if dt == DType.BF16:
        with pytest.raises(ValueError, match="ml_dtypes"):
            dt.to_numpy()
    else:
        assert dt.to_numpy() == rdt.to_numpy()
    with pytest.raises(ValueError):
        DType.from_torch(torch.bool)


# ---------------------------------------------------------------------------
# transform2 / transform_n: 12 dtypes x 4 ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS, ids=lambda o: o.name)
@pytest.mark.parametrize("rdt", list(RDType), ids=lambda d: d.name)
def test_transform2_matches_reference_and_plain(rdt, op, ref):
    rng = np.random.default_rng(int(rdt) * 10 + int(op))
    x, y = _values(rdt, rng), _values(rdt, rng)
    want = np.empty_like(x)
    ref.transform2(want, x, y, op)
    tx, ty = _tt(x), _tt(y)
    got, plain = torch.empty_like(tx), torch.empty_like(tx)
    ops.transform2(got, tx, ty, op)
    ops.transform2_plain(plain, tx, ty, op)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
    np.testing.assert_array_equal(_bytes(plain), _bytes(want))
    ops.reduce_inplace(tx, ty, op)  # dst aliasing x
    np.testing.assert_array_equal(_bytes(tx), _bytes(want))


@pytest.mark.parametrize("op", OPS, ids=lambda o: o.name)
@pytest.mark.parametrize("rdt", list(RDType), ids=lambda d: d.name)
def test_transform_n_matches_reference_and_plain(rdt, op, ref):
    rng = np.random.default_rng(100 + int(rdt) * 10 + int(op))
    srcs = [_values(rdt, rng) for _ in range(4)]
    for k in (1, 2, 4):
        want = np.empty_like(srcs[0])
        ref.transform_n(want, srcs[:k], op)
        ts = [_tt(s) for s in srcs[:k]]
        got, plain = torch.empty_like(ts[0]), torch.empty_like(ts[0])
        ops.transform_n(got, ts, op)
        ops.transform_n_plain(plain, ts, op)
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
        np.testing.assert_array_equal(_bytes(plain), _bytes(want))


@pytest.mark.parametrize("op", [ops.ReduceOp.MIN, ops.ReduceOp.MAX], ids=lambda o: o.name)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_nan_under_min_max_follows_the_cpp(dtype, op):
    """reduce.cpp's `a < b ? a : b` (and `>`): a NaN in x yields y, a NaN in
    y yields NaN; numpy's minimum/maximum would give NaN both times."""
    nan = float("nan")
    x = torch.tensor([nan, 1.0, nan, 2.0], dtype=dtype)
    y = torch.tensor([1.0, nan, nan, -3.0], dtype=dtype)
    want_last = -3.0 if op == ops.ReduceOp.MIN else 2.0
    for fn in (ops.transform2, ops.transform2_plain):
        out = torch.empty_like(x)
        fn(out, x, y, op)
        assert out[0].item() == 1.0 and out[3].item() == want_last
        assert out[1].isnan() and out[2].isnan()
    for fn in (ops.transform_n, ops.transform_n_plain):
        out = torch.empty_like(x)
        fn(out, [x, y], op)
        assert out[0].item() == 1.0 and out[1].isnan()
    if dtype == torch.float32:  # the fused decode-accumulate keeps the rule
        enc = torch.empty(4, dtype=torch.uint16)
        ops.encode_wire(enc, y, DType.BF16)
        for fn in (ops.decode_accumulate, ops.decode_accumulate_plain):
            acc = x.clone()
            fn(acc, 0, 4, enc, DType.BF16, op)
            assert acc[0].item() == 1.0 and acc[1].isnan() and acc[3].item() == want_last


def test_segments_match_reference(ref):
    rng = np.random.default_rng(5)
    acc, inc = _values(RDType.F32, rng, 100), _values(RDType.F32, rng, 30)
    want = acc.copy()
    ref.reduce_segment(want, 40, 70, inc, rops.ReduceOp.SUM)
    got, plain = _tt(acc), _tt(acc)
    ops.reduce_segment(got, 40, 70, _tt(inc), ops.ReduceOp.SUM)
    ops.reduce_segment_plain(plain, 40, 70, _tt(inc), ops.ReduceOp.SUM)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    ref.copy_segment(want, 0, 30, inc)
    ops.copy_segment(got, 0, 30, _tt(inc))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("begin,end,count", [(-1, 29, 30), (80, 110, 30), (50, 40, 0),
                                             (40, 70, 29)])
def test_segment_bounds_errors(begin, end, count):
    """Outside the buffer, reversed, or a payload of the wrong size: each
    segment function refuses, as the reference's do."""
    acc = torch.zeros(100)
    inc = torch.ones(count)
    enc = torch.zeros(count, dtype=torch.uint16)
    calls = [lambda: ops.reduce_segment(acc, begin, end, inc, ops.ReduceOp.SUM),
             lambda: ops.reduce_segment_plain(acc, begin, end, inc, ops.ReduceOp.SUM),
             lambda: ops.copy_segment(acc, begin, end, inc),
             lambda: ops.decode_accumulate(acc, begin, end, enc, DType.BF16, ops.ReduceOp.SUM)]
    for call in calls:
        with pytest.raises(ValueError, match="segment"):
            call()
    with pytest.raises(ValueError, match="segment"):
        rops.reduce_segment(acc.numpy(), begin, end, inc.numpy(), rops.ReduceOp.SUM)
    assert torch.equal(acc, torch.zeros(100))


def test_buffers_are_checked_before_the_cpp():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="mismatch"):
        ops.transform2(x, x, torch.zeros(7), ops.ReduceOp.SUM)
    with pytest.raises(ValueError, match="mismatch"):
        ops.transform2(x, x, torch.zeros(8, dtype=torch.float64), ops.ReduceOp.SUM)
    with pytest.raises(ValueError, match="one-dimensional"):
        ops.transform2(x.view(2, 4), x.view(2, 4), x.view(2, 4), ops.ReduceOp.SUM)
    with pytest.raises(ValueError, match="non-contiguous"):
        ops.transform2(x[::2], x[::2], x[1::2], ops.ReduceOp.SUM)
    with pytest.raises(ValueError, match="unsupported dtype"):
        b = torch.zeros(8, dtype=torch.bool)
        ops.transform2(b, b, b, ops.ReduceOp.SUM)
    with pytest.raises(ValueError, match="wire"):
        ops.encode_wire(torch.zeros(8, dtype=torch.uint16), x, DType.F32)
    with pytest.raises(ValueError, match="mismatch"):
        ops.encode_wire(torch.zeros(7, dtype=torch.uint16), x, DType.BF16)
    with pytest.raises(ValueError, match="mismatch"):
        ops.encode_wire_q(torch.zeros(8, dtype=torch.uint8), x, ops.QWire(8, 4))


# ---------------------------------------------------------------------------
# the 16-bit wire codec
# ---------------------------------------------------------------------------

WIRES = [DType.BF16, DType.F16]


def _payload() -> np.ndarray:
    """Normals, f16 subnormals, f16 overflow, +-inf, and ties of both
    formats (bf16: low 16 bits 0x8000 with either parity; f16: half an ulp
    at 1, 2^-20 in the subnormals, and at 65520, which rounds to inf)."""
    rng = np.random.default_rng(7)
    ties_bf16 = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x47FF8000],
                         np.uint32).view(np.float32)
    return np.concatenate([
        rng.uniform(-1e5, 1e5, 4000).astype(np.float32),
        rng.uniform(-1e-6, 1e-6, 2000).astype(np.float32),
        rng.normal(0, 1, 4001).astype(np.float32),
        np.array([0.0, -0.0, 65504.0, 65520.0, 65536.0, -70000.0, 3e38, -3.4e38,
                  2.0 ** -25, 2.0 ** -24, 2.0 ** -14, 3 * 2.0 ** -25, 2.0 ** -20 * 1.5,
                  1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, -(1 + 2.0 ** -11),
                  np.inf, -np.inf], np.float32),
        ties_bf16,
    ])


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w.name)
def test_encode_decode_match_reference_and_plain(wire, ref, monkeypatch):
    src = _payload()
    n = src.size
    rwire = RDType(int(wire))
    want = np.empty(n, np.uint16)
    ref.encode_wire(want, src, rwire)
    t = _tt(src)
    got, plain = torch.empty(n, dtype=torch.uint16), torch.empty(n, dtype=torch.uint16)
    ops.encode_wire(got, t, wire)
    ops.encode_wire_plain(plain, t, wire)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    dec_want = np.empty(n, np.float32)
    ref.decode_wire(dec_want, want, rwire)
    dec, dec_plain = torch.empty(n), torch.empty(n)
    ops.decode_wire(dec, got, wire)
    ops.decode_wire_plain(dec_plain, got, wire)
    np.testing.assert_array_equal(_bytes(dec), _bytes(dec_want))
    np.testing.assert_array_equal(_bytes(dec_plain), _bytes(dec_want))
    monkeypatch.setattr(rops, "_native", False)  # and the reference's numpy codec
    np_want = np.empty(n, np.uint16)
    rops.encode_wire(np_want, src, rwire)
    np.testing.assert_array_equal(got.numpy(), np_want)


@pytest.mark.parametrize("op", OPS, ids=lambda o: o.name)
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w.name)
def test_decode_accumulate_matches_reference_and_plain(wire, op, ref):
    rng = np.random.default_rng(11 + int(op))
    n = 5003
    enc = np.empty(n, np.uint16)
    ref.encode_wire(enc, rng.normal(0, 2, n).astype(np.float32), RDType(int(wire)))
    acc0 = rng.normal(0, 2, n + 10).astype(np.float32)
    want = acc0.copy()
    ref.decode_accumulate(want, 4, n + 4, enc, RDType(int(wire)), op)
    for fn in (ops.decode_accumulate, ops.decode_accumulate_plain,
               ops.decode_accumulate_any, ops.decode_accumulate_any_plain):
        got = _tt(acc0)
        fn(got, 4, n + 4, _tt(enc), wire, op)
        np.testing.assert_array_equal(_bytes(got), _bytes(want))


# ---------------------------------------------------------------------------
# the block-scaled int8/int4 wire codec
# ---------------------------------------------------------------------------

def _qpayload(n: int = 3001) -> np.ndarray:
    """Magnitudes from 1e4 to tiny (1e-30), all-zero leading blocks, an
    odd count."""
    rng = np.random.default_rng(3)
    out = np.concatenate([
        rng.uniform(-1e4, 1e4, n // 3).astype(np.float32),
        rng.normal(0, 1e-5, n // 3).astype(np.float32),
        rng.normal(0, 1.0, n - 2 * (n // 3) - 40).astype(np.float32),
        rng.normal(0, 1e-30, 40).astype(np.float32),
    ])
    out[:70] = 0.0
    return out


@pytest.mark.parametrize("block", [1, 16, 33])
@pytest.mark.parametrize("bits", [8, 4])
def test_qwire_matches_reference_and_plain(bits, block, ref, monkeypatch):
    src = _qpayload()
    n = src.size
    wire, rwire = ops.QWire(bits, block), rops.QWire(bits, block)
    nb = ops.wire_nbytes(n, wire)
    assert nb == rops.wire_nbytes(n, rwire) and ops.wire_nbytes_q(n, bits, block) == nb
    want = np.empty(nb, np.uint8)
    ref.encode_wire_q(want, src, rwire)
    t = _tt(src)
    got, plain = torch.empty(nb, dtype=torch.uint8), torch.empty(nb, dtype=torch.uint8)
    ops.encode_wire_q(got, t, wire)
    ops.encode_wire_any_plain(plain, t, wire)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    dec_want = np.empty(n, np.float32)
    ref.decode_wire_q(dec_want, want, rwire)
    for fn in (ops.decode_wire_q, ops.decode_wire_q_plain, ops.decode_wire_any):
        dec = torch.empty(n)
        fn(dec, got, wire)
        np.testing.assert_array_equal(_bytes(dec), _bytes(dec_want))
    again = torch.empty(nb, dtype=torch.uint8)  # re-encoding a decoded block is exact
    ops.encode_wire_q(again, _tt(dec_want), wire)
    assert torch.equal(again, got)
    rng = np.random.default_rng(bits + block)
    for op in OPS:
        acc0 = rng.normal(0, 2, n + 3).astype(np.float32)
        acc_want = acc0.copy()
        ref.decode_accumulate_q(acc_want, 2, n + 2, want, rwire, op)
        for fn in (ops.decode_accumulate_q, ops.decode_accumulate_q_plain):
            acc = _tt(acc0)
            fn(acc, 2, n + 2, got, wire, op)
            np.testing.assert_array_equal(_bytes(acc), _bytes(acc_want))
    monkeypatch.setattr(rops, "_native", False)  # and the reference's numpy codec
    np_want = np.empty(nb, np.uint8)
    rops.encode_wire_q(np_want, src, rwire)
    np.testing.assert_array_equal(got.numpy(), np_want)


def test_qwire_spec_matches_reference():
    for bits, block in ((8, 16), (4, 1), (4, 33)):
        w, r = ops.QWire(bits, block), rops.QWire(bits, block)
        assert (w.bits, w.block, w.name, repr(w)) == (r.bits, r.block, r.name, repr(r))
        assert w == ops.QWire(bits, block) and hash(w) == hash(ops.QWire(bits, block))
        assert w != ops.QWire(12 - bits, block)
    for bad in ((2, 16), (8, 0)):
        with pytest.raises(ValueError):
            ops.QWire(*bad)
    for count in (0, 1, 15, 16, 17, 1001):
        for wire in (DType.BF16, ops.QWire(8, 16), ops.QWire(4, 7)):
            rwire = wire if isinstance(wire, DType) else rops.QWire(wire.bits, wire.block)
            assert ops.wire_nbytes(count, wire) == rops.wire_nbytes(count, rwire)


# ---------------------------------------------------------------------------
# workspace and serialize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count,k", [(10, 3), (3, 5), (0, 2), (1001, 4)])
def test_workspace_split_matches_reference(count, k):
    assert even_partition(count, k) == r_even_partition(count, k)
    send = torch.arange(count, dtype=torch.float32)
    recv = torch.zeros(count)
    w = Workspace(send, recv, ops.ReduceOp.SUM, "grads")
    r = RWorkspace(send.numpy(), recv.numpy(), rops.ReduceOp.SUM, "grads")
    assert w.is_empty == r.is_empty == (count == 0)
    assert count == 0 or not w.is_inplace  # two empty tensors share the null pointer
    parts, rparts = w.split(even_partition, k), r.split(r_even_partition, k)
    assert [p.name for p in parts] == [p.name for p in rparts]
    assert [p.send.numel() for p in parts] == [p.send.size for p in rparts]
    for p in parts:
        p.forward()
    assert torch.equal(recv, send)
    assert Workspace(send, send, ops.ReduceOp.SUM, "x").is_inplace
    assert Workspace(send[:count], send, ops.ReduceOp.SUM, "x").is_inplace


def _leaves(case: str):
    rng = np.random.default_rng(9)
    if case == "mixed":
        return [rng.normal(size=(3, 4)).astype(np.float32), np.arange(7, dtype=np.int64),
                rng.normal(size=5).astype(np.float16), np.array(2.5, np.float64),
                np.array([True, False]), np.zeros((0, 3), np.float32)]
    if case == "bfloat16":
        return [rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16),
                rng.integers(0, 255, 9).astype(np.uint8)]
    return [rng.integers(-5, 5, (2, 2, 2)).astype(np.int8), np.arange(4, dtype=np.uint16)]


@pytest.mark.parametrize("case", ["mixed", "bfloat16", "ints"])
def test_pack_leaves_bytes_match_reference(case):
    leaves = _leaves(case)
    want = rser.pack_leaves(leaves)
    tensors = [_tt(a.reshape(-1)).reshape(a.shape) for a in leaves]
    got = serialize.pack_leaves(tensors)
    assert got == want
    back = serialize.unpack_leaves(want, len(leaves))
    for t, a in zip(back, leaves):
        assert tuple(t.shape) == a.shape
        assert serialize.dtype_name(t.dtype) == a.dtype.name
        np.testing.assert_array_equal(_bytes(t), _bytes(a))
    with pytest.raises(ValueError, match="expected"):
        serialize.unpack_leaves(want, len(leaves) + 1)
    assert serialize.resolve_dtype("bfloat16") == torch.bfloat16
    with pytest.raises(ValueError):
        serialize.resolve_dtype("float128x")


# ---------------------------------------------------------------------------
# the host library: no fallback
# ---------------------------------------------------------------------------

def test_a_library_that_does_not_build_raises(tmp_path, monkeypatch):
    """With CXX a compiler that fails and a fresh build directory, the first
    call raises RuntimeError naming the compiler and its error: there is no
    numpy path to fall back to."""
    fake = tmp_path / "failing-cxx"
    fake.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_lib", None)
    x = torch.ones(4)
    with pytest.raises(RuntimeError, match=r"failing-cxx failed building the host library"
                                           r"(.|\n)*no compiler here"):
        ops.transform2(x, x, x, ops.ReduceOp.SUM)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        ops.encode_wire(torch.empty(4, dtype=torch.uint16), x, DType.BF16)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_calls_are_counted():
    x = torch.ones(4)
    before = dict(_native.CALLS)
    ops.transform2(x, x, x, ops.ReduceOp.SUM)
    ops.transform2_plain(x, x, x, ops.ReduceOp.SUM)  # the twin never reaches the C++
    assert _native.CALLS["transform2"] == before["transform2"] + 1
    assert torch.equal(x, torch.full((4,), 4.0))
