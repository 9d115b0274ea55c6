"""The port's hierarchical all-reduce (`kungfu_tpu_torch/ops/hierarchical.py`)
and the examples of this slice against the JAX package's:

- `CrossSliceReducer` in mixed in-process worlds of 2 and of 4 peers
  (reference and port ranks alternating, the reference's host C++ built
  afresh), over f32, f64, bf16, f16, int32 and int64, with and without
  the bf16 wire: every peer's result bitwise equal to an all-reference
  world's on the same inputs;
- `_mean`'s dtype rules beside the reference's, and an unknown
  compression refused;
- a gloo world of 4 port processes under the port's kfrun: S-SGD as 2
  worlds x 2 ranks against one world of 4 (at most 2 ULP apart, the
  worlds bitwise equal to each other) and as 4 worlds of one with the
  device plane up (bitwise across ranks, within 2 ULP of one world of
  4), then
  `examples/multislice_train` at world sizes 2 and 1;
- `examples/adaptive_batch`'s GNS lines at size 1 equal to the
  reference's `main` run in process;
- `bench_resize` with its size schedule cut, printing its JSON line."""

import importlib.util
import io
import json
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from kungfu_tpu.ops.hierarchical import CrossSliceReducer as RCrossSliceReducer
from kungfu_tpu_torch.ops.hierarchical import CrossSliceReducer

from test_torch_port_runner import free_range, port_env
from test_torch_port_worlds import free_ports, make_world, ref_native, run_all  # noqa: F401
from test_torch_port_worlds import small_arenas  # noqa: F401 - autouse: small shm rings

REPO = Path(__file__).resolve().parent.parent
RUN_TIMEOUT = 240

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16), "f16": (np.float16, torch.float16),
          "i32": (np.int32, torch.int32), "i64": (np.int64, torch.int64)}


def _t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _leaves(dtype, rank, k):
    """Gradient-like leaves of one dtype on `rank` (two shapes; integers
    small enough for every sum)."""
    rng = np.random.default_rng(100 * k + rank)
    npdt = DTYPES[dtype][0]
    out = []
    for shape in [(37,), (3, 5, 7)]:
        if dtype.startswith("i"):
            out.append(rng.integers(-1000, 1000, shape).astype(npdt))
        else:
            out.append((rng.normal(size=shape) * 10.0 ** rng.integers(-3, 2, shape)).astype(npdt))
    return out


# ---------------------------------------------------------------------------
# CrossSliceReducer in mixed worlds
# ---------------------------------------------------------------------------

LAYOUTS = {2: ["ref", "port"], 4: ["port", "ref", "ref", "port"]}


@pytest.fixture(scope="module")
def reducer_worlds(ref_native):
    """{k: (mixed world, all-reference world)}, built once."""
    worlds = {k: (make_world(kinds), make_world(["ref"] * k)) for k, kinds in LAYOUTS.items()}
    yield worlds
    for pair in worlds.values():
        for world in pair:
            for p in world:
                p.stop()


def _reduce(world, dtype, compress, tag):
    k = len(world)
    outs = [None] * k

    def one(r):
        p = world[r]
        leaves = _leaves(dtype, r, k)
        if type(p).__module__.startswith("kungfu_tpu_torch"):
            red = CrossSliceReducer(peer=p, name=tag, compress=compress)
            outs[r] = [_np(o) for o in red(*[_t(a) for a in leaves])]
        else:
            red = RCrossSliceReducer(peer=p, name=tag, compress=compress)
            outs[r] = [np.asarray(o) for o in red(*leaves)]

    run_all([lambda r=r: one(r) for r in range(k)])
    return outs


@pytest.mark.parametrize("compress", ["", "bf16"], ids=["plain", "bf16wire"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", [2, 4])
def test_cross_slice_reducer_holds_the_reference_worlds_bits(k, dtype, compress, reducer_worlds):
    mixed, ref = reducer_worlds[k]
    tag = f"mx-{dtype}-{compress}"
    got = _reduce(mixed, dtype, compress, tag)
    want = _reduce(ref, dtype, compress, tag)
    for rank_out in got + want:
        for o, w in zip(rank_out, want[0]):
            assert o.dtype == w.dtype == DTYPES[dtype][0] and o.shape == w.shape
            assert o.tobytes() == w.tobytes()
    # and it is the mean, to the wire's precision
    exact = np.mean([np.stack([a.astype(np.float64) for a in _leaves(dtype, r, k)[0:1]])
                     for r in range(k)], axis=0)[0]
    if dtype.startswith("i"):
        exact = np.floor(np.sum([_leaves(dtype, r, k)[0].astype(np.int64) for r in range(k)],
                                axis=0) / k)
    tol = {"f32": 1e-6, "f64": 1e-12, "bf16": 2 ** -7, "f16": 2 ** -10, "i32": 0, "i64": 0}
    if compress and dtype in ("f32", "f64"):
        tol[dtype] = 2 ** -7
    scale = np.max([np.abs(_leaves(dtype, r, k)[0].astype(np.float64)) for r in range(k)])
    assert np.max(np.abs(got[0][0].astype(np.float64) - exact)) <= tol[dtype] * scale * k


def test_the_bf16_wire_halves_an_f32_payload(reducer_worlds):
    """The bytes the port peer's session sends, f32 leaves on the wire as
    they are and as bf16."""
    mixed, _ = reducer_worlds[2]
    port = next(p for p in mixed if type(p).__module__.startswith("kungfu_tpu_torch"))
    sizes = {}

    def one(r, compress):
        p = mixed[r]
        leaves = _leaves("f32", r, 2)
        if p is port:
            sess = p.current_session()
            sent0 = sum(sess.wire_bytes.values())
            CrossSliceReducer(peer=p, name=f"bytes-{compress}", compress=compress)(
                *[_t(a) for a in leaves])
            sizes[compress] = sum(sess.wire_bytes.values()) - sent0
        else:
            RCrossSliceReducer(peer=p, name=f"bytes-{compress}", compress=compress)(*leaves)

    for compress in ("", "bf16"):
        run_all([lambda r=r: one(r, compress) for r in range(2)])
    assert sizes[""] > 0 and sizes["bf16"] * 2 == sizes[""]


def test_cross_slice_reducer_single_world_identity():
    from kungfu_tpu_torch.peer import Peer
    from kungfu_tpu_torch.runner.env import parse_config_from_env

    peer = Peer(parse_config_from_env({}))
    peer.start()
    try:
        r = CrossSliceReducer(peer=peer)
        a = torch.arange(6, dtype=torch.float32)
        (out,) = r(a)
        assert torch.equal(out, a) and r.step == 1
    finally:
        peer.stop()


# ---------------------------------------------------------------------------
# _mean's dtype rules; refused arguments
# ---------------------------------------------------------------------------

MEAN_CASES = [
    # (wire dtype, n, out dtype or None)
    ("bf16", 2, None), ("bf16", 3, None), ("bf16", 3, "f32"), ("bf16", 4, "f64"),
    ("f16", 3, None), ("f16", 2, "f32"), ("f32", 3, None), ("f32", 4, "f64"),
    ("f64", 3, None), ("f64", 7, "f32"), ("i32", 2, None), ("i32", 3, None),
    ("i64", 4, None), ("i64", 3, "f64"), ("i32", 3, "f32"),
]


@pytest.mark.parametrize("case", MEAN_CASES, ids=lambda c: f"{c[0]}-n{c[1]}-{c[2]}")
def test_mean_follows_the_references_dtype_rules(case):
    """Integers floor-divide, sub-4-byte floats divide at f32, wider
    floats in their own dtype, one cast to the output dtype. bf16 is not
    an integer: 1.0 / 2 must be 0.5, not 0."""
    wire, n, out = case
    rng = np.random.default_rng(n)
    vals = rng.integers(-50, 50, 64) if wire.startswith("i") else rng.normal(size=64) * 7
    vals[:2] = [1, 3]
    a = vals.astype(DTYPES[wire][0])
    want = RCrossSliceReducer._mean(a, n, None if out is None else DTYPES[out][0])
    got = _np(CrossSliceReducer._mean(_t(a), n, None if out is None else DTYPES[out][1]))
    assert got.dtype == np.asarray(want).dtype and got.tobytes() == np.asarray(want).tobytes()
    if wire == "bf16" and n == 2:
        assert got[:2].astype(np.float32).tolist() == [0.5, 1.5]


def test_cross_slice_reducer_rejects_unknown_compression_and_worlds():
    with pytest.raises(ValueError, match="unknown compression"):
        CrossSliceReducer(compress="int8")
    with pytest.raises(ValueError, match="world_size"):
        CrossSliceReducer(world_size=0)


def test_cross_slice_mean_refuses_worlds_without_their_group():
    """None names torch's default group (every rank), never a world of
    two: the broadcast would run over the wrong ranks."""
    from kungfu_tpu_torch.ops.hierarchical import cross_slice_mean

    with pytest.raises(ValueError, match="need their group"):
        cross_slice_mean([torch.zeros(2)], CrossSliceReducer(world_size=2))


def test_hierarchical_steps_need_a_card_unless_asked_for_the_cpu():
    from kungfu_tpu_torch.ops.hierarchical import make_hier_train_step

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_hier_train_step(lambda b: (w * b).sum(), torch.optim.SGD([w], lr=0.1))
    step = make_hier_train_step(lambda b: (w * b).sum(), torch.optim.SGD([w], lr=0.5),
                                device="cpu")
    loss = step(torch.ones(2))  # a process of its own is a world of one
    assert float(loss) == 0.0 and w.tolist() == [-0.5, -0.5]


# ---------------------------------------------------------------------------
# a gloo world of 4 processes: 2 worlds x 2 ranks against one world of 4
# ---------------------------------------------------------------------------

HIER_WORKER = textwrap.dedent("""\
    import json, sys
    import numpy as np
    import torch
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.examples import multislice_train
    from kungfu_tpu_torch.ops.hierarchical import make_hier_train_step
    from kungfu_tpu_torch.parallel.distributed import initialize_device_plane
    from kungfu_tpu_torch.peer import get_default_peer

    STEPS = 3
    initialize_device_plane("cpu", peer=get_default_peer())
    rank = api.current_rank()

    def run(world_size):
        # tests/integration/hier_agent.py's dyadic constants, 2 rows a rank
        w1 = torch.tensor((np.arange(16).reshape(4, 4) % 5 - 2), dtype=torch.float32) / 8
        w2 = torch.tensor((np.arange(8).reshape(4, 2) % 3 - 1), dtype=torch.float32) / 4
        x = torch.tensor((np.arange(32).reshape(8, 4) % 7 - 3), dtype=torch.float32) / 2
        t = torch.tensor((np.arange(16).reshape(8, 2) % 4 - 2), dtype=torch.float32)
        params = {"w1": w1.requires_grad_(), "w2": w2.requires_grad_()}

        def loss_fn(batch):
            xb, tb = batch
            h = torch.relu(xb @ params["w1"])
            return torch.mean((h @ params["w2"] - tb) ** 2)

        step = make_hier_train_step(loss_fn, torch.optim.SGD(list(params.values()), lr=0.25),
                                    world_size=world_size, name=f"hier{world_size}",
                                    device="cpu")
        lo, hi = rank * 2, (rank + 1) * 2
        for _ in range(STEPS):
            loss = step((x[lo:hi], t[lo:hi]))
        return {k: v.detach().numpy().tobytes().hex() for k, v in sorted(params.items())}, \\
            float(loss)

    for ws in (4, 2, 1):
        params, loss = run(ws)
        print("HIER " + json.dumps({"rank": rank, "world_size": ws, "params": params,
                                    "loss": loss}), flush=True)
    for ws in ("2", "1"):
        out = multislice_train.main(["--device", "cpu", "--world-size", ws, "--steps", "3"])
        print("MULTI " + json.dumps({"rank": rank, "world_size": int(ws),
                                     "losses": out["losses"]}), flush=True)
""")


@pytest.fixture(scope="module")
def hier_world(tmp_path_factory):
    """4 port processes under the port's kfrun, their device plane (gloo)
    up: S-SGD with the hierarchical mean at world sizes 4 (the reducer
    then idle), 2 and 1 (the reference's layout: no in-world step), from
    the reference agent's dyadic constants; then the multislice example
    at world sizes 2 and 1. Yields the HIER records by world size and the
    run's stdout."""
    d = tmp_path_factory.mktemp("hier")
    (d / "w.py").write_text(HIER_WORKER)
    base, runner = free_range(4), free_ports(1)[0]
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "4", "-H", "127.0.0.1:4",
         "-port-range", f"{base}-{base + 3}", "-runner-port", str(runner),
         "--", sys.executable, str(d / "w.py")],
        env=port_env(), capture_output=True, text=True, timeout=RUN_TIMEOUT, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-4000:]}\nstderr:\n{r.stderr[-4000:]}"
    res = [json.loads(l.split("HIER ", 1)[1]) for l in r.stdout.splitlines() if "HIER " in l]
    assert len(res) == 12
    return {ws: {x["rank"]: x for x in res if x["world_size"] == ws} for ws in (1, 2, 4)}, r.stdout


def _ulps(a_hex, b_hex):
    """The largest distance in f32 ULPs between two hex-dumped arrays."""
    a, b = (np.frombuffer(bytes.fromhex(h), np.float32).view(np.int32).astype(np.int64)
            for h in (a_hex, b_hex))
    return int(np.abs(a - b).max())


def _multi_lines(stdout, ws):
    return [l for l in stdout.splitlines() if "MULTI " in l
            and json.loads(l.split("MULTI ", 1)[1])["world_size"] == ws]


def test_two_worlds_of_two_are_within_2_ulp_of_one_world_of_four(hier_world):
    """2 worlds x 2 ranks against one world of 4: at most 2 ULP apart,
    the worlds bitwise equal to each other; the multislice example at
    world size 2 ends with its worlds in sync."""
    by_ws, stdout = hier_world
    hier = by_ws[2][0]["params"]
    # the worlds hold the same bits: a torn or skipped host round would
    # diverge them at once
    assert all(by_ws[2][rk]["params"] == hier for rk in range(4))
    assert all(by_ws[4][rk]["params"] == by_ws[4][0]["params"] for rk in range(4))
    for k in hier:
        assert _ulps(hier[k], by_ws[4][0]["params"][k]) <= 2, k
    assert len(_multi_lines(stdout, 2)) == 4, stdout[-3000:]


def test_worlds_of_one_under_a_device_plane_are_within_2_ulp_of_one_world_of_four(hier_world):
    """World size 1 with the device plane up: no in-world mean or
    broadcast (torch's default group holds all 4 ranks, not the world),
    the host all-reduce alone averages. Every rank holds the same bits,
    within 2 ULP of world size 4's (gloo and the host's star add the 4
    gradients in different orders, which rounds apart by 1 ULP from the
    second step on); the multislice example at world size 1 ends with its
    worlds in sync."""
    by_ws, stdout = hier_world
    want = by_ws[4][0]["params"]
    assert all(by_ws[1][rk]["params"] == by_ws[1][0]["params"] for rk in range(4))
    for k in want:
        assert _ulps(by_ws[1][0]["params"][k], want[k]) <= 2, k
    assert len(_multi_lines(stdout, 1)) == 4, stdout[-3000:]


# ---------------------------------------------------------------------------
# the examples: adaptive batch at size 1, bench_resize cut short
# ---------------------------------------------------------------------------

def _gns_lines(text):
    return [l for l in text.splitlines() if l.startswith("step ")]


def test_adaptive_batch_prints_the_references_gns_lines_at_size_1(monkeypatch):
    """Both packages' example in one process, a world of one (no kfrun
    environment), --max-workers 1: every GNS line equal."""
    from kungfu_tpu import peer as rpeer
    from kungfu_tpu_torch import peer as tpeer
    from kungfu_tpu_torch.examples import adaptive_batch

    for k in [k for k in list(__import__("os").environ) if k.startswith("KF_")]:
        monkeypatch.delenv(k)
    spec = importlib.util.spec_from_file_location("ref_adaptive_batch",
                                                  REPO / "examples" / "adaptive_batch.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(sys, "argv", ["adaptive_batch.py", "--max-workers", "1"])
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            ref.main()
    finally:
        rpeer.finalize_default_peer()
    want = buf.getvalue()
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            out = adaptive_batch.main(["--max-workers", "1", "--device", "cpu"])
    finally:
        tpeer.finalize_default_peer()
    got = buf.getvalue()
    assert len(_gns_lines(want)) == 12 and _gns_lines(got) == _gns_lines(want), (got, want)
    assert "done rank=0 size=1 reason=finished" in got and "reason=finished" in want
    assert [s["size"] for s in out["steps"]] == [1] * 120
    assert [s["progress"] for s in out["steps"]] == list(range(120))
    assert out["steps"][-1]["gns"] > 0 and out["w"].dtype == torch.float64


def test_bench_resize_prints_its_json_line(monkeypatch, capsys):
    from kungfu_tpu_torch import bench_resize

    monkeypatch.setattr(bench_resize, "SIZES", [2, 3, 2])
    monkeypatch.setattr(bench_resize, "STEPS_PER_EPOCH", 3)
    monkeypatch.setattr(bench_resize, "SLEEP_S", 0.2)
    out = bench_resize.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert line["metric"] == "elastic_resize_latency" and line["unit"] == "ms"
    assert line["n_resizes"] >= 2 and 0 < line["min_ms"] <= line["value"] <= line["max_ms"]
    assert set(line["phase_median_ms"]) >= {"wait_config_ms", "consensus_ms", "update_ms"}
