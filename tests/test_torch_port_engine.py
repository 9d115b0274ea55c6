"""The port's host collective engine over its transport
(`kungfu_tpu_torch/collective/`, `peer.py`, `api.py`), in process.

- Pure-port worlds of k = 2, 3, 4 loopback peers (one per world size for
  the module, every case run inside it): every strategy, dtype and op on
  tests/test_segmented.py's exact payloads, the bf16 and int8 wires held
  to the reference's limits, the segmented ring's wire bytes, group
  fusion, the other collectives, the synchronous `api`, and each walk's
  first call against chip_smoke's in-process replays.
- A mixed world of 2 reference and 2 port `Peer`s in one cluster: the
  case matrix (strategies x dtypes x ops, then x wires, each with shm on
  and off) runs once, and every peer must hold the same bits, equal to an
  all-reference world's on the same inputs. The reference's host C++ is
  built afresh and bound in its place (its numpy fallback rounds
  otherwise).
- The device plane formed over a Peer's session at cluster versions 0
  and 1 in each of two spawned processes.

Ports are reserved by binding 0, never in kfrun's 38000-38999."""

import itertools
import socket
import subprocess
import threading
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from kungfu_tpu.base import ops as rops
from kungfu_tpu.base.ops import ReduceOp as RReduceOp
from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.base.workspace import Workspace as RWorkspace
from kungfu_tpu.collective.host_session import HostSession as RHostSession
from kungfu_tpu.peer import Peer as RPeer
from kungfu_tpu.plan.peer import PeerID as RPeerID, PeerList as RPeerList
from kungfu_tpu.runner.env import WorkerConfig as RWorkerConfig
from kungfu_tpu_torch import api
from kungfu_tpu_torch.base.dtype import DType
from kungfu_tpu_torch.base.ops import QWire, ReduceOp
from kungfu_tpu_torch.base.strategy import DEFAULT_STRATEGY, Strategy
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.collective.host_session import HostSession
from kungfu_tpu_torch.collective.strategies import gen_global_strategies
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan import topology as topo
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.runner.env import WorkerConfig

REPO = Path(__file__).resolve().parent.parent
STRATEGIES = ["STAR", "TREE", "CLIQUE", "RING", "RING_SEGMENTED", "BINARY_TREE_STAR", "AUTO"]
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64),
          "i32": (np.int32, torch.int32)}
OPS = ["SUM", "MIN", "MAX", "PROD"]
EXACT_SIZES = (1, 3, 5, 1000, 1001)  # tests/test_segmented.py:177
BIG = 70_001  # f32: above SEGMENT_MIN_BYTES, WIRE_MIN_BYTES and SHM_MIN_BYTES
WIRE_EPS = {"bf16": 2.0 ** -8, "int8": 2.0 / 127.0}  # the reference's limits
_NP_OPS = {"SUM": np.add, "MIN": np.minimum, "MAX": np.maximum, "PROD": np.multiply}


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------

def free_ports(n: int):
    """n ports the kernel calls free (bound to 0, then closed), none in
    kfrun's 38000-38999."""
    socks, out = [], []
    try:
        while len(out) < n:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            port = s.getsockname()[1]
            if not 38000 <= port < 39000:
                out.append(port)
    finally:
        for s in socks:
            s.close()
    return out


def _config(cls, P, PL, Strat, me, peers, version=0):
    return cls(self_id=me, peers=peers, runners=PL(), parent=None, cluster_version=version,
               strategy=Strat.STAR, config_server="", elastic_mode="", init_progress=0)


def make_world(kinds):
    """Start one peer per entry of `kinds` ("port" or "ref") on loopback."""
    ports = free_ports(len(kinds))
    pl = PeerList(PeerID("127.0.0.1", p) for p in ports)
    rpl = RPeerList([RPeerID("127.0.0.1", p) for p in ports])
    peers = []
    for r, kind in enumerate(kinds):
        if kind == "port":
            peers.append(Peer(_config(WorkerConfig, PeerID, PeerList, Strategy, pl[r], pl)))
        else:
            peers.append(RPeer(_config(RWorkerConfig, RPeerID, RPeerList, RStrategy,
                                       rpl[r], rpl)))
    run_all([p.start for p in peers])
    return peers


def run_all(fns, join: float = 120.0):
    """Run one callable per peer at once; re-raise the first error."""
    errs = []

    def wrap(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(join)
        assert not t.is_alive(), "collective hung"
    if errs:
        raise errs[0]


def sessions(world, strategy: str, timeout: float = 60.0):
    """Fresh sessions of `strategy` over each peer's live transport."""
    out = []
    for p in world:
        if isinstance(p, Peer):
            out.append(HostSession(Strategy[strategy], p.self_id, p.config.peers, p.client,
                                   p.collective, timeout=timeout))
        else:
            out.append(RHostSession(RStrategy[strategy], p.self_id, p.config.peers,
                                    p.client, p.collective, timeout=timeout))
    return out


def allreduce_all(sess, xs, op: str, name: str):
    """All-reduce xs[r] (numpy) on session r; returns each peer's result
    as numpy."""
    outs = [None] * len(sess)

    def one(r):
        s, x = sess[r], xs[r]
        if isinstance(s, HostSession):
            out = torch.empty(x.size, dtype=torch.from_numpy(x).dtype)
            s.all_reduce(Workspace(torch.from_numpy(x), out, ReduceOp[op], name))
            outs[r] = out.numpy()
        else:
            out = np.empty_like(x)
            s.all_reduce(RWorkspace(x, out, RReduceOp[op], name))
            outs[r] = out

    run_all([lambda r=r: one(r) for r in range(len(sess))])
    return outs


def exact_payload(rng, size, dtype, op):
    """Integer-valued arrays whose reduction is exact in every dtype and
    order (tests/test_segmented.py's)."""
    vals = rng.choice([1, -1, 2], size=size) if op == "PROD" else rng.integers(-8, 9, size=size)
    return vals.astype(dtype)


def grads(rng, k, n=BIG):
    """Gradient-like f32 inputs: mixed signs over four orders of magnitude."""
    scale = 10.0 ** rng.integers(-4, 0, n)
    return [(rng.normal(0, 1, n) * scale).astype(np.float32) for _ in range(k)]


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


def same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


ARENA_BYTES = 8 << 20  # each shm ring of these worlds, for both packages alike


@pytest.fixture(scope="module", autouse=True)
def small_arenas():
    """Rings of 8 MiB instead of KF_CONFIG_SHM_CAPACITY's 256 MiB, which
    tmpfs backs at creation: the largest payload here is 560 KB, and a
    full ring falls back to socket frames, as it would at any size."""
    from kungfu_tpu.transport import shm as rshm
    from kungfu_tpu_torch.transport import shm

    def small(cls):
        class Arena(cls):
            def __init__(self, path, capacity=ARENA_BYTES):
                super().__init__(path, capacity)
        return Arena

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shm, "SenderArena", small(shm.SenderArena))
        mp.setattr(rshm, "SenderArena", small(rshm.SenderArena))
        yield


@pytest.fixture(scope="module")
def worlds():
    built = {}

    def get(k):
        if k not in built:
            built[k] = make_world(["port"] * k)
        return built[k]

    yield get
    for world in built.values():
        for p in world:
            p.stop()


@pytest.fixture
def seg_min_zero(monkeypatch):
    """Segment payloads of every size (the segmented walk at 1-1001
    elements), in both packages alike."""
    monkeypatch.setattr(HostSession, "SEGMENT_MIN_BYTES", 0)
    monkeypatch.setattr(RHostSession, "SEGMENT_MIN_BYTES", 0)


# ---------------------------------------------------------------------------
# pure-port worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("k", [2, 3, 4])
def test_port_world_reduces_exact_payloads(k, strategy, dtype, worlds, seg_min_zero):
    world = worlds(k)
    sess = sessions(world, strategy)
    rng = np.random.default_rng(_seed(k, strategy, dtype))
    for op, size in itertools.product(OPS, EXACT_SIZES):
        xs = [exact_payload(rng, size, DTYPES[dtype][0], op) for _ in range(k)]
        want = xs[0].copy()
        for x in xs[1:]:
            _NP_OPS[op](want, x, out=want)
        outs = allreduce_all(sess, xs, op, f"exact:{dtype}:{op}:{size}")
        for o in outs:
            np.testing.assert_array_equal(o, want, err_msg=f"{strategy} k={k} {op} {size}")


@pytest.mark.parametrize("strategy", ["RING_SEGMENTED", "BINARY_TREE_STAR", "STAR"])
@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_port_world_wire_codecs_hold_the_references_limits(k, wire, strategy, worlds,
                                                          monkeypatch):
    monkeypatch.setenv("KF_CONFIG_WIRE", wire)
    sess = sessions(worlds(k), strategy)
    xs = grads(np.random.default_rng(k), k)
    outs = allreduce_all(sess, xs, "SUM", f"wire:{wire}")
    assert all(same_bits(o, outs[0]) for o in outs)
    total = np.sum(np.stack(xs).astype(np.float64), axis=0)
    err = np.abs(outs[0].astype(np.float64) - total).max()
    assert err <= 2 * np.abs(total).max() * WIRE_EPS[wire]
    codec = {(c, s) for (_, s, c) in sess[0].wire_bytes}
    label = strategy if strategy != "RING_SEGMENTED" else "RING_SEGMENTED"
    assert codec == {(wire, label)}


@pytest.mark.parametrize("k", [2, 3, 4])
def test_segmented_ring_sends_the_optimal_bytes(k, worlds):
    """Each peer sends 2N - seg(own) - seg(own+1) bytes; over the ring,
    exactly 2 (k - 1) N: the bandwidth-optimality claim."""
    sess = sessions(worlds(k), "RING_SEGMENTED")
    n = 40_000
    xs = [np.full(n, float(r + 1), np.float32) for r in range(k)]
    outs = allreduce_all(sess, xs, "SUM", "wire:seg")
    assert all(np.all(o == k * (k + 1) / 2) for o in outs)
    bounds = topo.segment_bounds(n, k)
    sent = []
    for r, s in enumerate(sess):
        sched = topo.gen_segmented_schedule(list(range(k)), r)
        want = 4 * sum(bounds[snd][1] - bounds[snd][0]
                       for snd, _ in sched.rs_steps + sched.ag_steps)
        assert s.wire_bytes == {("all_reduce", "RING_SEGMENTED", "off"): want}
        sent.append(want)
    assert sum(sent) == 2 * (k - 1) * 4 * n


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("mode", ["ring_f32", "ring_bf16", "ring_int8", "tree_f32"])
def test_first_call_equals_the_in_process_replay(k, mode, worlds, monkeypatch):
    """The first call of each of chip_smoke hostnet's modes, on a fresh
    session, is bitwise equal to chip_smoke's replay on the same inputs
    (only the first: the int8 wire's error feedback carries residuals)."""
    wires = {"ring_f32": ("off", None), "ring_bf16": ("bf16", DType.BF16),
             "ring_int8": ("int8", QWire(8, 16)), "tree_f32": ("off", None)}
    knob, wire = wires[mode]
    monkeypatch.setenv("KF_CONFIG_WIRE", knob)
    if mode.startswith("ring"):
        monkeypatch.setenv("KF_CONFIG_ALGO", "segmented")
    sess = sessions(worlds(k), DEFAULT_STRATEGY.name)
    xs = grads(np.random.default_rng(50 + k), k)
    outs = allreduce_all(sess, xs, "SUM", f"replay:{mode}")
    bufs = [torch.from_numpy(x.copy()) for x in xs]
    if mode.startswith("ring"):
        want = chip_smoke.ring_replay(bufs, chip_smoke.host_ops(), wire)
    else:
        (pair,) = gen_global_strategies(worlds(k)[0].config.peers, DEFAULT_STRATEGY)
        want = chip_smoke.graph_replay(bufs, pair, chip_smoke.host_ops())
    for o, w in zip(outs, want):
        assert same_bits(o, w.numpy())


@pytest.mark.parametrize("strategy", ["TREE", "CLIQUE", "RING", "RING_SEGMENTED"])
def test_group_all_reduce_fuses_and_matches(strategy, worlds, seg_min_zero, monkeypatch):
    """Several small tensors in pipelined buckets (a tiny bucket cap) and
    one large enough to chunk, exact on every peer; fewer tensors than
    FUSE_MIN walk as singles."""
    monkeypatch.setattr(HostSession, "GROUP_BUCKET_BYTES", 4096)
    k = 4
    sess = sessions(worlds(k), strategy)
    rng = np.random.default_rng(7)
    for sizes in ([17, 300, 5, 900, 33, 121, 64, 350_000], [9, 70]):
        xs = {r: [exact_payload(rng, s, np.float32, "SUM") for s in sizes] for r in range(k)}
        outs = {}

        def run(r):
            ins = [torch.from_numpy(x) for x in xs[r]]
            res = [torch.empty_like(x) for x in ins]
            sess[r].group_all_reduce([Workspace(x, o, ReduceOp.SUM, f"fuse:{len(sizes)}:{i}")
                                      for i, (x, o) in enumerate(zip(ins, res))])
            outs[r] = res

        run_all([lambda r=r: run(r) for r in range(k)])
        for i in range(len(sizes)):
            want = sum(xs[r][i] for r in range(k))
            for r in range(k):
                np.testing.assert_array_equal(outs[r][i].numpy(), want)


@pytest.mark.parametrize("root", [0, 1, 3])
def test_reduce_broadcast_gather_any_root(root, worlds):
    k = 4
    world = worlds(k)
    sess = sessions(world, "BINARY_TREE_STAR")
    res = {}

    def run(r):
        s = sess[r]
        x = torch.arange(6, dtype=torch.float64) + r
        red = torch.zeros(6, dtype=torch.float64)
        s.reduce(Workspace(x, red, ReduceOp.SUM, f"red{root}"), root=root)
        b = torch.full((6,), float(r))
        bo = torch.empty(6)
        s.broadcast(Workspace(b, bo, ReduceOp.SUM, f"bc{root}"), root=root)
        # unequal contributions: rank r sends r + 1 elements
        g = torch.full((r + 1,), r, dtype=torch.int32)
        go = torch.empty(10 if r == root else 0, dtype=torch.int32)
        s.gather(Workspace(g, go, ReduceOp.SUM, f"ga{root}"), root=root)
        res[r] = (red, bo, go)

    run_all([lambda r=r: run(r) for r in range(k)])
    want_red = sum(torch.arange(6, dtype=torch.float64) + r for r in range(k))
    assert torch.equal(res[root][0], want_red)
    for r in range(k):
        assert torch.equal(res[r][1], torch.full((6,), float(root)))
    assert res[root][2].tolist() == [0, 1, 1, 2, 2, 2, 3, 3, 3, 3]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_reduce_scatter_then_all_gather_is_all_reduce(k, worlds):
    sess = sessions(worlds(k), "RING_SEGMENTED")
    xs = grads(np.random.default_rng(9), k, 20_011)
    full = allreduce_all(sess, xs, "SUM", "rsag:ar")
    res = {}

    def run(r):
        s = sess[r]
        out = torch.empty(20_011)
        b, e = s.reduce_scatter(Workspace(torch.from_numpy(xs[r]), out, ReduceOp.SUM, "rsag:rs"))
        assert (b, e) == s.owned_bounds(20_011)
        buf = torch.empty(20_011)
        buf[b:e] = out[b:e]
        s.all_gather_shards(buf, "rsag:ag")
        res[r] = buf.numpy()

    run_all([lambda r=r: run(r) for r in range(k)])
    for r in range(k):
        assert same_bits(res[r], full[r])


def test_barrier_consensus_and_broadcast_bytes(worlds):
    k = 3
    sess = sessions(worlds(k), "STAR")
    res = {}

    def run(r):
        s = sess[r]
        s.barrier(":t")
        agree = s.bytes_consensus(b"same-bytes", "c1")
        differ = s.bytes_consensus(b"rank%d" % r, "c2")
        lens = s.bytes_consensus(b"x" * (r + 1), "c3")
        empty = s.bytes_consensus(b"", "c4")
        got = s.broadcast_bytes(b"from root 1" if r == 1 else b"", "bb", root=1)
        none = s.broadcast_bytes(b"", "bb0")
        res[r] = (agree, differ, lens, empty, got, none)

    run_all([lambda r=r: run(r) for r in range(k)])
    assert all(v == (True, False, False, True, b"from root 1", b"") for v in res.values())


def test_subset_all_reduce_with_trees_and_set_tree(worlds):
    k = 4
    sess = sessions(worlds(k), "STAR")
    res = {}
    forest = [0, 0, 2, 2]  # two trees: {0, 1} and {2, 3}
    tree = [0, 0, 1, 1]

    def run(r):
        s = sess[r]
        x = torch.full((1001,), float(r + 1))
        a, b, c = torch.empty(1001), torch.empty(1001), torch.empty(1001)
        s.subset_all_reduce(forest, Workspace(x, a, ReduceOp.SUM, "sub"))
        s.all_reduce_with(tree, Workspace(x, b, ReduceOp.SUM, "with"))
        s.set_tree(tree)
        assert s.active_candidate_name() == "SET_TREE"
        s.all_reduce(Workspace(x, c, ReduceOp.SUM, "settree"))
        res[r] = (a[0].item(), b[0].item(), c[0].item())

    run_all([lambda r=r: run(r) for r in range(k)])
    assert [res[r] for r in range(k)] == [(3.0, 10.0, 10.0)] * 2 + [(7.0, 10.0, 10.0)] * 2
    with pytest.raises(ValueError, match="rooted at rank 0"):
        sess[0].set_tree([1, 1, 1, 1])


def test_votes_switch_in_lockstep(worlds):
    """check_interference keeps the candidate without suspicion;
    check_precision flips the wire on a majority, on every peer."""
    k = 3
    sess = sessions(worlds(k), "RING_SEGMENTED")
    res = {}

    def run(r):
        s = sess[r]
        switched = s.check_interference()
        flip = s.check_precision("bf16" if r < 2 else None)
        again = s.check_precision()
        res[r] = (switched, flip, again, s.active_candidate_name())

    run_all([lambda r=r: run(r) for r in range(k)])
    assert all(v == (False, "bf16", None, "RING_SEGMENTED/bf16") for v in res.values())


def test_knob_consensus_names_the_diverging_knob(worlds):
    k = 2
    sess = sessions(worlds(k), "STAR")
    sess[1].wire_mode = "bf16"
    errs = {}

    def run(r):
        try:
            sess[r].check_knob_consensus()
        except RuntimeError as e:
            errs[r] = str(e)

    run_all([lambda r=r: run(r) for r in range(k)])
    assert set(errs) == {0, 1} and all("KF_CONFIG_WIRE" in e for e in errs.values())


# ---------------------------------------------------------------------------
# the synchronous api, one in-process world (each thread its own peer)
# ---------------------------------------------------------------------------

@pytest.fixture
def api_world(worlds, monkeypatch):
    tls = threading.local()
    monkeypatch.setattr(api, "get_default_peer", lambda: tls.peer)
    world = worlds(3)

    def run(fn):
        out = {}

        def one(r):
            tls.peer = world[r]
            out[r] = fn(r)

        run_all([lambda r=r: one(r) for r in range(len(world))])
        return [out[r] for r in range(len(world))]

    return run


def test_api_rank_queries(api_world):
    got = api_world(lambda r: (api.current_rank(), api.cluster_size(), api.current_local_rank(),
                               api.current_local_size(), api.host_count(),
                               api.current_cluster_version(), api.uid(), api.detached()))
    assert got == [(r, 3, r, 3, 1, 0, r, False) for r in range(3)]
    api_world(lambda r: api.run_barrier())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_api_all_reduce_array(dtype, api_world):
    def fn(r):
        x = (torch.arange(12).reshape(3, 4) + r).to(dtype)
        y = api.all_reduce_array(x, ReduceOp.MAX, name=f"ar{dtype}")
        z = api.all_reduce_array(x, name=f"ar2{dtype}")
        return y, z, x

    for y, z, x in api_world(fn):
        assert y.shape == (3, 4) and y.dtype == dtype
        assert torch.equal(y, (torch.arange(12).reshape(3, 4) + 2).to(dtype))
        assert torch.equal(z, (3 * torch.arange(12).reshape(3, 4) + 3).to(dtype))


@pytest.mark.parametrize("with_outs", [False, True])
def test_api_group_all_reduce_arrays(with_outs, api_world):
    shapes = [(3,), (2, 5), (7,), (1,), (4, 4)]

    def fn(r):
        xs = [torch.full(s, float(r + i)) for i, s in enumerate(shapes)]
        outs = [torch.empty(s) for s in shapes] if with_outs else None
        got = api.group_all_reduce_arrays(xs, name=f"g{with_outs}", outs=outs)
        if with_outs:
            assert all(g.data_ptr() == o.data_ptr() for g, o in zip(got, outs))
        return got

    for got in api_world(fn):
        for i, (g, s) in enumerate(zip(got, shapes)):
            assert g.shape == s and torch.equal(g, torch.full(s, float(3 * i + 3)))


def test_api_reduce_scatter_all_gather_broadcast_gather(api_world):
    def fn(r):
        x = torch.arange(10, dtype=torch.float32) * (r + 1)
        shard = api.reduce_scatter(x, name="rs")
        full = api.all_gather(shard, name="ag")
        b = api.broadcast_array(torch.full((2, 2), float(r)), root=2, name="b")
        g = api.gather_arrays(torch.full((2,), r, dtype=torch.int32), root=1, name="g")
        return full, b, g, api.all_reduce_int_max(r * 7), api.consensus(b"c", "c")

    for r, (full, b, g, m, c) in enumerate(api_world(fn)):
        assert torch.equal(full, torch.arange(10, dtype=torch.float32) * 6)
        assert torch.equal(b, torch.full((2, 2), 2.0))
        assert (g is None) == (r != 1)
        if g is not None:
            assert g.tolist() == [[0, 0], [1, 1], [2, 2]]
        assert (m, c) == (14, True)


def test_api_neighbours_queues_and_store(api_world):
    def fn(r):
        nb = [api.get_neighbour(t) for t in range(6)]
        rr = [api.round_robin_peer(t) for t in range(6)]
        dst, src = (r + 1) % 3, (r - 1) % 3
        q_out = q_in = 0  # new_queue's counters are the process's, shared here
        api.queue_put(dst, q_out, torch.tensor([r, r], dtype=torch.int16))
        api.queue_put(dst, q_out, b"second")
        got = (api.queue_get(src, q_in), api.queue_get(src, q_in))
        api.save("blob", f"rank{r}".encode())
        api.save("model", torch.full((3,), float(r)), version=4)
        api.run_barrier()
        fetched = (api.request(dst, "blob"), api.request(dst, "model", version="latest"),
                   api.request(dst, "absent"))
        return nb, rr, got, fetched

    for r, (nb, rr, got, fetched) in enumerate(api_world(fn)):
        n = 3
        bits = max(1, (n - 1).bit_length())
        want_nb = []
        for t in range(6):
            p = r ^ (1 << (t % bits))
            want_nb.append(p if p < n else (r + 1 + t % (n - 1)) % n)
        assert nb == want_nb
        assert rr == [(r + 1 + t % (n - 1)) % n for t in range(6)]
        src = (r - 1) % 3
        assert got == (np.array([src, src], np.int16).tobytes(), b"second")
        dst = (r + 1) % 3
        assert fetched[0] == f"rank{dst}".encode()
        assert fetched[1] == torch.full((3,), float(dst)).numpy().tobytes()
        assert fetched[2] is None


def test_api_new_queue_counts_per_pair_and_epoch(worlds, monkeypatch):
    peer = worlds(2)[0]
    monkeypatch.setattr(api, "get_default_peer", lambda: peer)
    monkeypatch.setattr(api, "_queue_ids", {})
    assert [api.new_queue(0, 1), api.new_queue(0, 1), api.new_queue(1, 0)] == [0, 1, 0]
    monkeypatch.setattr(peer, "cluster_version", 1)
    assert api.new_queue(0, 1) == 0  # a new epoch restarts the counters


def test_api_minimum_spanning_tree():
    from kungfu_tpu.api import minimum_spanning_tree as rmst

    w = np.random.default_rng(3).uniform(1, 9, (6, 6))
    w = w + w.T
    assert api.minimum_spanning_tree(w) == rmst(w)


# ---------------------------------------------------------------------------
# the mixed world: reference and port peers in one cluster
# ---------------------------------------------------------------------------

EXACT_CASES = [(s, d, o, shm) for s in STRATEGIES for d in DTYPES for o in OPS
               for shm in ("shm", "socket")]
# gradient-like f32 sums, where the order of the additions decides the bits
FLOAT_CASES = [(s, "f32", shm) for s in STRATEGIES for shm in ("shm", "socket")]
WIRE_CASES = [(s, w, shm) for s in STRATEGIES for w in WIRE_EPS for shm in ("shm", "socket")]


@pytest.fixture(scope="module")
def ref_native(tmp_path_factory):
    """The JAX package's host C++ (native/reduce.cpp), built afresh and
    bound through its own loader's source in place of whatever its
    `_load_native` found (a stale library, or its numpy fallback)."""
    d = tmp_path_factory.mktemp("kfnative")
    subprocess.run([_build.find_cxx(), "-O3", "-march=native", "-shared", "-fPIC",
                    "-std=c++17", "-o", str(d / "libkfnative.so"),
                    str(REPO / "native" / "reduce.cpp")], check=True, capture_output=True)
    native = types.ModuleType("reference_native_reduce")
    native.__file__ = str(d / "_native_reduce.py")
    src = (REPO / "kungfu_tpu" / "base" / "_native_reduce.py").read_text()
    exec(compile(src, native.__file__, "exec"), native.__dict__)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rops, "_native", native)
        yield native


# which package holds the even ranks (rank 0 roots the stars and trees)
LAYOUTS = {"ref_first": ["ref", "port", "ref", "port"],
           "port_first": ["port", "ref", "port", "ref"]}


def _run_matrix(mixed_world, ref_world, mp):
    """Every case on both worlds, the same inputs: {case: [(mixed outputs,
    reference outputs), ...]}."""
    k = 4
    results = {}
    for shm in ("shm", "socket"):
        mp.setenv("KF_CONFIG_SHM", "1" if shm == "shm" else "0")
        for s in STRATEGIES:
            ms, rs = sessions(mixed_world, s), sessions(ref_world, s)
            for d, o in itertools.product(DTYPES, OPS):
                rng = np.random.default_rng(_seed(s, d, o))
                outs = []
                for size in (1, 1001, BIG):
                    xs = [exact_payload(rng, size, DTYPES[d][0], o) for _ in range(k)]
                    name = f"mx:{d}:{o}:{size}"
                    outs.append((allreduce_all(ms, xs, o, name), allreduce_all(rs, xs, o, name)))
                results[(s, d, o, shm)] = outs
            xs = grads(np.random.default_rng(_seed(s, "f32")), k)
            results[(s, "f32", shm)] = [(allreduce_all(ms, xs, "SUM", "mxf"),
                                         allreduce_all(rs, xs, "SUM", "mxf"))]
        for w in WIRE_EPS:
            mp.setenv("KF_CONFIG_WIRE", w)
            for s in STRATEGIES:
                ms, rs = sessions(mixed_world, s), sessions(ref_world, s)
                xs = grads(np.random.default_rng(_seed(s, w)), k)
                results[(s, w, shm)] = [(allreduce_all(ms, xs, "SUM", f"mxw:{w}"),
                                         allreduce_all(rs, xs, "SUM", f"mxw:{w}"))]
            mp.delenv("KF_CONFIG_WIRE")
    return results


@pytest.fixture(scope="module")
def mixed(ref_native):
    """The case matrix run once on each mixed world (2 reference and 2
    port peers, in both layouts) and on an all-reference world, on the
    same inputs. Returns {layout: results}, the worlds and the port
    peers' frame counts."""
    worlds_ = {name: make_world(kinds) for name, kinds in LAYOUTS.items()}
    ref_world = make_world(["ref"] * 4)
    try:
        with pytest.MonkeyPatch.context() as mp:
            results = {name: _run_matrix(w, ref_world, mp) for name, w in worlds_.items()}
        frames = [p.client.frames for w in worlds_.values() for p in w if isinstance(p, Peer)]
        yield results, worlds_, frames
    finally:
        for p in [p for w in worlds_.values() for p in w] + ref_world:
            p.stop()


@pytest.mark.parametrize("case", EXACT_CASES, ids=lambda c: "-".join(c))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_world_holds_the_reference_worlds_bits(layout, case, mixed):
    results, _, _ = mixed
    for outs, ref_outs in results[layout][case]:
        for o in outs + ref_outs:
            assert same_bits(o, ref_outs[0])


@pytest.mark.parametrize("case", FLOAT_CASES + WIRE_CASES, ids=lambda c: "-".join(c))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_world_float_sums_and_wire_codecs_hold_the_reference_worlds_bits(layout, case,
                                                                               mixed):
    results, _, _ = mixed
    ((outs, ref_outs),) = results[layout][case]
    for o in outs + ref_outs:
        assert same_bits(o, ref_outs[0])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mixed_world_used_shm_and_sockets_and_agreed_on_knobs(layout, mixed):
    _, worlds_, frames = mixed
    assert all(f["shm"] > 0 and f["socket"] > 0 for f in frames)
    world = worlds_[layout]
    port = next(p for p in world if isinstance(p, Peer)).current_session()
    ref = next(p for p in world if not isinstance(p, Peer)).current_session()
    assert port.engine_knobs() == ref.engine_knobs()
    assert len(port.engine_knobs()) == 12
    res = {}

    def run(r):
        world[r].current_session().check_knob_consensus()
        res[r] = True

    run_all([lambda r=r: run(r) for r in range(4)])
    assert len(res) == 4


# ---------------------------------------------------------------------------
# the device plane over a Peer's session
# ---------------------------------------------------------------------------

def _devplane_worker(rank, _spawned, peers):
    import torch.distributed as dist

    from kungfu_tpu_torch.parallel import distributed as kdist

    pl = PeerList.parse(",".join(peers))
    peer = Peer(_config(WorkerConfig, PeerID, PeerList, Strategy, pl[rank], pl))
    peer.start()
    try:
        for version in (0, 1):
            if version:
                peer.cluster_version = version
                peer._update_to(pl)
                kdist.reinitialize_device_plane("cpu", peer=peer)
            else:
                kdist.initialize_device_plane("cpu", peer=peer)
            assert kdist.device_plane_initialized()
            assert kdist.current_device_plane_version() == version
            assert (dist.get_rank(), dist.get_world_size()) == (rank, 2)
            t = torch.tensor([float(rank + 1 + 10 * version)])
            dist.all_reduce(t)
            assert t.item() == 3 + 20 * version
        kdist.shutdown_device_plane()
        assert not kdist.device_plane_initialized() and not dist.is_initialized()
    finally:
        peer.stop()


def test_device_plane_forms_again_at_a_new_cluster_version():
    from kungfu_tpu_torch.parallel.distributed import spawn_world

    spawn_world(_devplane_worker, 2, 120,
                args=([f"127.0.0.1:{p}" for p in free_ports(2)],))


# ---------------------------------------------------------------------------
# the engine's small pieces against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 0.25, 1 / 3, 0.5, 1.0])
def test_span_sampler_matches_the_reference(rate):
    from kungfu_tpu.collective.profiler import SpanSampler as RSpanSampler
    from kungfu_tpu_torch.collective.profiler import SpanSampler

    mine, theirs = SpanSampler(rate), RSpanSampler(rate)
    assert [mine.sample() for _ in range(60)] == [theirs.sample() for _ in range(60)]


def test_walk_profiler_and_adaptive_state_match_the_reference():
    from kungfu_tpu.collective.adaptive import AdaptiveState as RAdaptiveState
    from kungfu_tpu.collective.profiler import WalkProfiler as RWalkProfiler
    from kungfu_tpu_torch.collective.adaptive import AdaptiveState
    from kungfu_tpu_torch.collective.profiler import WalkProfiler

    mine, theirs = WalkProfiler(), RWalkProfiler()
    rng = np.random.default_rng(5)
    for i in range(40):
        wall = float(rng.uniform(0.01, 0.1))
        args = ("all_reduce", ["RING_SEGMENTED", "STAR"][i % 2], 1 + i % 4, 1 << 20, wall,
                wall * float(rng.uniform(0, 0.7)), wall * float(rng.uniform(0, 0.7)))
        mine.record(*args)
        theirs.record(*args)
    assert mine.snapshot() == theirs.snapshot() and mine.signals() == theirs.signals()
    a, b = AdaptiveState(3, ["x", "y", "z"]), RAdaptiveState(3, ["x", "y", "z"])
    for i in range(30):
        for s in (a, b):
            s.current.update(1 << 20, 0.01 if i < 12 else 0.05)
    assert a.current.suspect_interference() and b.current.suspect_interference()
    a.advance()
    b.advance()
    sa, sb = a.summary(), b.summary()
    assert (sa["active"], sa["switches"], sa["stats"]) == (sb["active"], sb["switches"],
                                                           sb["stats"])


def test_trace_records_spans_and_durations():
    from kungfu_tpu_torch.utils import trace

    trace.clear()
    with trace.span("t.a", bytes=3) as sp:
        sp.args["more"] = 1
    trace.record("t.b", 0.25)
    names = [(n, round(d, 2)) for n, _, d in trace.events("t.")]
    assert names[0][0] == "t.a" and names[1] == ("t.b", 0.25)
    assert trace.events("none.") == []


def test_worker_env_round_trips_and_matches_the_reference():
    from kungfu_tpu.runner import env as renv
    from kungfu_tpu_torch.parallel.distributed import parse_worker_env
    from kungfu_tpu_torch.runner import env

    peers = PeerList.parse("127.0.0.1:40001,127.0.0.1:40002,10.0.0.2:40001")
    rpeers = RPeerList.parse("127.0.0.1:40001,127.0.0.1:40002,10.0.0.2:40001")
    block = env.worker_env(peers[1], peers, PeerList.parse("127.0.0.1:39000"), peers[0],
                           cluster_version=3, strategy=Strategy.RING, init_progress=7,
                           device_slots=[1])
    rblock = renv.worker_env(rpeers[1], rpeers, RPeerList.parse("127.0.0.1:39000"), rpeers[0],
                             cluster_version=3, strategy=RStrategy.RING, init_progress=7,
                             device_slots=[1])
    # the reference also mirrors the slots into TPU_VISIBLE_DEVICES
    assert block == {k: v for k, v in rblock.items() if k != "TPU_VISIBLE_DEVICES"}
    cfg, rcfg = env.parse_config_from_env(block), renv.parse_config_from_env(rblock)
    assert (str(cfg.self_id), str(cfg.peers), str(cfg.runners), str(cfg.parent),
            cfg.cluster_version, cfg.strategy.name, cfg.init_progress, cfg.device_slots) == \
        (str(rcfg.self_id), str(rcfg.peers), str(rcfg.runners), str(rcfg.parent),
         rcfg.cluster_version, rcfg.strategy.name, rcfg.init_progress, rcfg.device_slots)
    spec = parse_worker_env(block)  # the device plane reads the same values
    assert (spec.self_spec, spec.rank, spec.size, spec.device_slots) == \
        (str(cfg.self_id), 1, 3, (1,))
    alone = env.parse_config_from_env({})
    assert alone.single_process and str(alone.self_id) == "127.0.0.1:10000"


def test_client_pings_a_live_peer_and_not_a_closed_port(worlds):
    world = worlds(2)
    client = world[0].client
    assert client.ping(world[1].self_id)
    assert client.wait_peer(world[1].self_id, timeout=5)
    (closed,) = free_ports(1)
    assert not client.ping(PeerID("127.0.0.1", closed), timeout=0.5)
