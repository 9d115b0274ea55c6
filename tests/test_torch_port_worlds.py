"""In-process worlds of host-plane peers for the port's tests of the
asynchronous host plane (`test_torch_port_scheduler.py`, `_zero.py`,
`_frontend.py`, `_bert_sma.py` import from here): loopback peers of
either package on ports bound to 0 (never in kfrun's 38000-38999), runs
of one callable per peer with bounded joins, small shm rings, the JAX
package's host C++ built afresh, and per-thread copies of the
process-wide round counters. The cases below hold the helpers
themselves."""

import socket
import subprocess
import threading
import types
from pathlib import Path

import pytest

from kungfu_tpu.base import ops as rops
from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.peer import Peer as RPeer
from kungfu_tpu.plan.peer import PeerID as RPeerID, PeerList as RPeerList
from kungfu_tpu.runner.env import WorkerConfig as RWorkerConfig
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.runner.env import WorkerConfig

REPO = Path(__file__).resolve().parent.parent
ARENA_BYTES = 8 << 20  # each shm ring, for both packages alike


def free_ports(n):
    """n ports the kernel calls free, none in kfrun's 38000-38999."""
    socks, out = [], []
    try:
        while len(out) < n:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            if not 38000 <= s.getsockname()[1] < 39000:
                out.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return out


def run_all(fns, join=120.0):
    """One callable per peer at once, joins bounded; re-raise the first
    error."""
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


def make_world(kinds, strategy="STAR"):
    """One started peer per entry of `kinds` ("port" or "ref"), their
    sessions of `strategy`."""
    ports = free_ports(len(kinds))
    pl = PeerList(PeerID("127.0.0.1", p) for p in ports)
    rpl = RPeerList([RPeerID("127.0.0.1", p) for p in ports])
    peers = []
    for r, kind in enumerate(kinds):
        cls, PL, strat, ids = ((WorkerConfig, PeerList, Strategy, pl) if kind == "port"
                               else (RWorkerConfig, RPeerList, RStrategy, rpl))
        cfg = cls(self_id=ids[r], peers=ids, runners=PL(), parent=None, cluster_version=0,
                  strategy=strat[strategy], config_server="", elastic_mode="",
                  init_progress=0)
        peers.append(Peer(cfg) if kind == "port" else RPeer(cfg))
    run_all([p.start for p in peers])
    return peers


def new_epoch(world):
    """Every peer moves to the next cluster version at once: fresh
    sessions (which read the engine knobs as they start) and schedulers."""
    def one(p):
        p.cluster_version += 1
        assert p._update_to(p.config.peers)

    run_all([lambda p=p: one(p) for p in world])


class PerThreadCounter(list):
    """A process-wide round counter (`kungfu_tpu_torch.torch._sync_round`,
    `api._async_seq`) kept per thread: in these worlds each thread is a
    process of its own, and the ranks' wire names must agree."""

    def __init__(self):
        super().__init__([0])
        self._tls = threading.local()

    def __getitem__(self, i):
        return getattr(self._tls, "n", 0)

    def __setitem__(self, i, v):
        self._tls.n = v


@pytest.fixture(scope="module", autouse=True)
def small_arenas():
    """8 MiB shm rings instead of 256 MiB (tmpfs backs each at creation)."""
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
def ref_native(tmp_path_factory):
    """The JAX package's host C++ (native/reduce.cpp) built afresh and
    bound in place of its loader's pick (a stale library, or its numpy
    fallback, which rounds otherwise)."""
    d = tmp_path_factory.mktemp("kfnative")
    subprocess.run([_build.find_cxx(), "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                    "-o", str(d / "libkfnative.so"), str(REPO / "native" / "reduce.cpp")],
                   check=True, capture_output=True)
    native = types.ModuleType("reference_native_reduce")
    native.__file__ = str(d / "_native_reduce.py")
    src = (REPO / "kungfu_tpu" / "base" / "_native_reduce.py").read_text()
    exec(compile(src, native.__file__, "exec"), native.__dict__)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rops, "_native", native)
        yield native


def test_free_ports_are_distinct_and_outside_kfruns_range():
    ports = free_ports(16)
    assert len(set(ports)) == 16 and not any(38000 <= p < 39000 for p in ports)


def test_per_thread_counter_keeps_one_count_per_thread():
    c = PerThreadCounter()
    seen = {}

    def bump(name, times):
        for _ in range(times):
            c[0] += 1
        seen[name] = c[0]

    run_all([lambda: bump("a", 3), lambda: bump("b", 5)])
    assert seen == {"a": 3, "b": 5} and c[0] == 0


def test_mixed_world_starts_and_each_peer_moves_to_a_new_epoch():
    world = make_world(["ref", "port"], strategy="RING_SEGMENTED")
    try:
        new_epoch(world)
        assert [p.cluster_version for p in world] == [1, 1]
        assert [p.current_session().rank for p in world] == [0, 1]
    finally:
        for p in world:
            p.stop()
