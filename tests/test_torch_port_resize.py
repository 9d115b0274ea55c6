"""The port's elastic resize protocol against the JAX package's, in
process: worlds of host-plane peers (port, reference, or both) on ports
bound to 0 outside kfrun's 38000-38999, a config server, and a fake
runner that records each Stage it is sent and starts the joiners it
names, as kfrun's watcher would. The peers drive `ElasticState` over a
state of tensors (numpy arrays and ml_dtypes' bfloat16 on the reference
side): after each resize every peer's state must equal the root's bit for
bit, the Stage bytes a port rank 0 sends must equal the reference's, and
a rejected proposal must leave every peer where it was."""

import hashlib
import json
import threading
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kungfu_tpu import api as rapi
from kungfu_tpu import peer as rpeer_mod
from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.elastic.state import ElasticState as RElasticState
from kungfu_tpu.plan.cluster import Cluster as RCluster
from kungfu_tpu.plan.peer import PeerID as RPeerID, PeerList as RPeerList
from kungfu_tpu.runner.env import WorkerConfig as RWorkerConfig
from kungfu_tpu.runner.watch import Stage as RStage
from kungfu_tpu_torch import api
from kungfu_tpu_torch import peer as peer_mod
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.elastic.configserver import ConfigServer
from kungfu_tpu_torch.elastic.state import ElasticState, tree_flatten
from kungfu_tpu_torch.peer import Peer
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.peer import PeerID, PeerList
from kungfu_tpu_torch.runner.env import WorkerConfig
from kungfu_tpu_torch.runner.watch import Stage
from kungfu_tpu_torch.transport.message import ConnType
from kungfu_tpu_torch.transport.server import Server

from test_torch_port_worlds import free_ports, small_arenas  # noqa: F401 - autouse: small shm rings

JOIN = 120.0  # seconds a world may take


@pytest.fixture
def tls(monkeypatch):
    """Each thread's peer is both packages' default peer."""
    local = threading.local()
    for mod in (api, peer_mod, rapi, rpeer_mod):
        monkeypatch.setattr(mod, "get_default_peer", lambda: local.peer)
    return local


class FakeRunner:
    """A runner's control endpoint: keeps each Stage payload it is sent
    and starts, on a thread of its own, a peer for every worker of the
    new cluster that is not yet running (its kind from `joiners`)."""

    def __init__(self, world: "World"):
        self.world = world
        self.id = PeerID("127.0.0.1", free_ports(1)[0])
        self.payloads = []
        self.server = Server(self.id, use_unix=False)
        self.server.register(ConnType.CONTROL, self.handle)
        self.server.start()

    def handle(self, src, msg) -> None:
        payload = bytes(msg.data)
        self.payloads.append(payload)
        stage = Stage.from_json(json.loads(payload.decode()))
        for w in stage.cluster.workers:
            if str(w) not in self.world.started:
                self.world.spawn(self.world.joiners.pop(0), str(w), stage)

    def stop(self) -> None:
        self.server.stop()


class World:
    """Peers of `kinds` ("port" or "ref") under one config server and one
    fake runner, each running `worker(kind, peer)` on a thread of its own
    with its peer as the default; joiners (of `joiners`' kinds, in order)
    run the same worker."""

    def __init__(self, tls, kinds, joiners, worker):
        self.tls, self.kinds, self.joiners, self.worker = tls, list(kinds), list(joiners), worker
        self.ports = free_ports(len(kinds) + len(joiners))
        self.specs = [f"127.0.0.1:{p}" for p in self.ports]
        self.runner = FakeRunner(self)
        self.config = ConfigServer(0, self.cluster(self.specs[:len(kinds)]), host="127.0.0.1")
        self.config.start()
        self.url = f"http://127.0.0.1:{self.config.port}/config"
        self.started, self.results, self.errors, self.threads = {}, {}, [], []
        self.lock = threading.Lock()

    def cluster(self, specs) -> Cluster:
        return Cluster.from_json({"Runners": [str(self.runner.id)], "Workers": list(specs)})

    def put(self, specs) -> None:
        req = urllib.request.Request(self.url, data=self.cluster(specs).dumps().encode(),
                                     method="PUT")
        with urllib.request.urlopen(req, timeout=5) as resp:
            resp.read()

    def _config(self, kind, spec, peers, version, progress):
        if kind == "port":
            ids = PeerList.parse(",".join(peers))
            return Peer(WorkerConfig(
                self_id=PeerID.parse(spec), peers=ids, runners=PeerList([self.runner.id]),
                parent=None, cluster_version=version, strategy=Strategy.STAR,
                config_server=self.url, elastic_mode="", init_progress=progress))
        ids = RPeerList.parse(",".join(peers))
        return rpeer_mod.Peer(RWorkerConfig(
            self_id=RPeerID.parse(spec), peers=ids,
            runners=RPeerList([RPeerID.parse(str(self.runner.id))]), parent=None,
            cluster_version=version, strategy=RStrategy.STAR, config_server=self.url,
            elastic_mode="", init_progress=progress))

    def spawn(self, kind, spec, stage=None) -> None:
        peers = [str(w) for w in stage.cluster.workers] if stage else self.specs[:len(self.kinds)]
        version, progress = (stage.version, stage.progress) if stage else (0, 0)
        p = self._config(kind, spec, peers, version, progress)
        self.started[spec] = p

        def body():
            try:
                self.tls.peer = p
                p.start()
                got = self.worker(kind, p)
                with self.lock:
                    self.results[spec] = got
            except BaseException as e:  # noqa: BLE001 - re-raised by run()
                self.errors.append(e)

        t = threading.Thread(target=body)
        with self.lock:
            self.threads.append(t)
        t.start()

    def run(self) -> dict:
        try:
            for kind, spec in zip(self.kinds, self.specs):
                self.spawn(kind, spec)
            done = 0
            while True:
                with self.lock:
                    ts = self.threads[done:]
                if not ts:
                    break
                for t in ts:
                    t.join(JOIN)
                    assert not t.is_alive(), "resize world hung"
                done += len(ts)
            if self.errors:
                raise self.errors[0]
            return self.results
        finally:
            for p in self.started.values():
                p.stop()
            self.runner.stop()
            self.config.stop()


# ---------------------------------------------------------------------------
# the state: the same values in either package's types
# ---------------------------------------------------------------------------

def make_state(kind, fill):
    """A state tree with dict keys out of sorted order, nesting, four
    dtypes and a Python number; `fill` sets every value."""
    def arr(shape, dt):
        return np.full(shape, fill, dt)

    if kind == "port":
        return {"w": torch.from_numpy(arr((3, 4), np.float32)),
                "opt": [torch.from_numpy(arr((5,), np.int64)),
                        (torch.full((2, 2), float(fill), dtype=torch.bfloat16),)],
                "b": arr((3,), np.float64), "count": 0, "nothing": None}
    return {"w": arr((3, 4), np.float32),
            "opt": [arr((5,), np.int64), (arr((2, 2), ml_dtypes.bfloat16),)],
            "b": arr((3,), np.float64), "count": 0, "nothing": None}


def leaves_of(kind, state):
    return tree_flatten(state)[0] if kind == "port" else jax.tree.leaves(state)


def digest(kind, state) -> str:
    """sha256 over each leaf's dtype name and bytes, in jax's leaf order."""
    h = hashlib.sha256()
    for x in leaves_of(kind, state):
        if isinstance(x, torch.Tensor):
            name = str(x.dtype).removeprefix("torch.")
            raw = x.contiguous().view(torch.uint8).numpy().tobytes()
        else:
            a = np.asarray(x)
            name, raw = a.dtype.name, a.tobytes()
        h.update(name.encode() + b":" + raw)
    return h.hexdigest()


def advance(kind, state, step):
    """One deterministic 'training' update, the same in both packages."""
    if kind == "port":
        state["w"] += 1.0
        state["opt"][0] += step
        state["opt"][1][0].add_(0.5)
    else:
        state["w"] = state["w"] + np.float32(1.0)
        state["opt"][0] = state["opt"][0] + step
        state["opt"][1] = (state["opt"][1][0] + ml_dtypes.bfloat16(0.5),)
    state["b"] = state["b"] * 1.5
    state["count"] = state["count"] + 1


def elastic_worker(world, plan, max_progress):
    """The peers' loop: ElasticState over the state above; at progress p
    in `plan`, rank 0 PUTs the cluster of `plan[p]` (spec indices)."""
    def worker(kind, peer):
        state = make_state(kind, -1)  # a joiner's sentinel until the sync
        if peer.epoch_count == 1 and peer.cluster_version == 0:
            state = make_state(kind, 0)
        es = (ElasticState if kind == "port" else RElasticState)(max_progress=max_progress)

        def set_state(tree):
            state.update(tree)

        es.register_state(lambda: state, set_state)
        rec = []
        while not es.stopped():
            with es.scope():
                mod = api if kind == "port" else rapi
                rank, size = mod.current_rank(), mod.cluster_size()
                rec.append({"progress": es.progress, "size": size, "rank": rank,
                            "digest": digest(kind, state), "version": peer.cluster_version,
                            "sync": dict(getattr(es, "last_sync", {}))})
                advance(kind, state, es.progress)
                if rank == 0 and es.progress in plan:
                    world.put([world.specs[i] for i in plan[es.progress]])
                es.end(1)
        leaves = leaves_of(kind, state)
        return {"kind": kind, "steps": rec, "stop": es.stop_reason, "final": es.progress,
                "dtypes": [str(np.asarray(x).dtype) if not isinstance(x, torch.Tensor)
                           else str(x.dtype) for x in leaves],
                "phases": dict(peer.last_resize_phases)}
    return worker


def check_world(results, sizes_by_progress, max_progress):
    """Every peer that trained at a progress holds the same state there,
    at the expected size; survivors finish, the shed detach."""
    by_progress = {}
    for res in results.values():
        for r in res["steps"]:
            by_progress.setdefault(r["progress"], []).append(r)
    assert sorted(by_progress) == list(range(max_progress))
    for prog, recs in by_progress.items():
        assert len({r["digest"] for r in recs}) == 1, (prog, recs)
        assert {r["size"] for r in recs} == {sizes_by_progress[prog]}, (prog, recs)
        assert sorted(r["rank"] for r in recs) == list(range(sizes_by_progress[prog]))
    finished = [s for s, res in results.items() if res["stop"] == "finished"]
    assert len(finished) == sizes_by_progress[max_progress - 1]
    assert all(res["stop"] in ("finished", "detached") for res in results.values())
    assert all(res["final"] == max_progress for s, res in results.items() if s in finished)


# kinds of the first world, of the joiner, where the joiner stands in the
# grown cluster (0: listed first, so its rank 0 must not be the root), and
# which original peer the shrink sheds
LAYOUTS = {
    "port-only": (["port", "port"], ["port"], "last", 1),
    "port-only-joiner-first": (["port", "port"], ["port"], "first", 0),
    "ref-root-port-joiner": (["ref", "port"], ["port"], "last", 1),
    "port-root-ref-joiner": (["port", "ref"], ["ref"], "last", 1),
    "ref-root-port-joiner-first": (["ref", "port"], ["port"], "first", 0),
    "port-root-ref-joiner-first": (["port", "ref"], ["ref"], "first", 1),
    "2ref-2port-port-joins": (["ref", "port", "ref"], ["port"], "last", 2),
    "2ref-2port-ref-joins": (["port", "ref", "port"], ["ref"], "last", 0),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grow_then_shrink_keeps_every_peer_on_the_roots_state(layout, tls):
    """k -> k+1 -> k through the config server: the joiner's state after
    the grow's sync equals the survivors' bit for bit, in either
    direction of root and joiner."""
    kinds, joiners, where, shed = LAYOUTS[layout]
    k = len(kinds)
    world = World(tls, kinds, joiners, None)
    first = list(range(k))
    grown = [k] + first if where == "first" else first + [k]
    shrunk = [i for i in grown if i != shed]
    plan = {2: grown, 5: shrunk}
    max_progress = 8
    world.worker = elastic_worker(world, plan, max_progress)
    results = world.run()
    sizes = {p: (k if p <= 2 else k + 1 if p <= 5 else k) for p in range(max_progress)}
    check_world(results, sizes, max_progress)
    joiner = world.specs[k]
    assert results[world.specs[shed]]["stop"] == "detached"
    assert results[joiner]["stop"] == "finished" and results[joiner]["steps"][0]["progress"] == 3
    # the joiner's leaves came back in its own package's types
    same = [r for s, r in results.items() if r["kind"] == joiners[0] and s != joiner]
    assert all(r["dtypes"] == results[joiner]["dtypes"] for r in same)
    # two Stages (grow, shrink), byte for byte the reference's form
    payloads = world.runner.payloads
    assert len(payloads) == 2
    for payload, version, members in zip(payloads, (1, 2), (grown, shrunk)):
        ref = json.dumps({"Version": version, "Progress": 0,
                          "Cluster": RCluster.from_json(
                              {"Runners": [str(world.runner.id)],
                               "Workers": [world.specs[i] for i in members]}).to_json()})
        assert payload == ref.encode()
        assert RStage.from_json(json.loads(payload)).digest() == \
            Stage.from_json(json.loads(payload)).digest()
    # the survivors timed each resize's phases; the port's sync its bytes
    for spec, res in results.items():
        if res["stop"] == "finished" and spec != joiner:
            assert {"wait_config_ms", "consensus_ms", "update_ms"} <= set(res["phases"])
    if joiners[0] == "port":  # the grow's sync sent the whole state to the joiner
        assert results[joiner]["steps"][0]["sync"]["bytes"] > 0


@pytest.mark.parametrize("kinds", [["port", "port"], ["ref", "port"], ["port", "ref"],
                                   ["port", "ref", "port", "ref"]])
def test_a_proposal_the_peers_disagree_on_is_rejected(kinds, tls):
    """Peers proposing different clusters: every one gets (False, keep)
    and stays at its version and members."""
    world = World(tls, kinds, [], None)
    extra = free_ports(len(kinds))

    def worker(kind, peer):
        rank = peer.rank
        mine = world.specs[:len(kinds)] + [f"127.0.0.1:{extra[rank]}"]
        cl = (Cluster if kind == "port" else RCluster).from_json(
            {"Runners": [str(world.runner.id)], "Workers": mine})
        got = peer._propose(cl)
        return {"got": got, "version": peer.cluster_version, "size": peer.size,
                "phases": dict(peer.last_resize_phases), "steps": []}

    world.worker = worker
    results = world.run()
    assert [results[s]["got"] for s in world.specs] == [(False, True)] * len(kinds)
    assert all(r["version"] == 0 and r["size"] == len(kinds) and r["phases"] == {}
               for r in results.values())
    assert world.runner.payloads == []


@pytest.mark.parametrize("kinds", [["port", "port"], ["ref", "port"], ["port", "ref"]])
def test_resize_to_the_same_members_is_no_change(kinds, tls):
    """The config server's cluster equals the current one: resize()
    returns (False, False) and no Stage is sent."""
    world = World(tls, kinds, [], None)

    def worker(kind, peer):
        got = [(api if kind == "port" else rapi).resize() for _ in range(3)]
        return {"got": got, "seq": dict(peer._cfg_consensus_seq), "steps": []}

    world.worker = worker
    results = world.run()
    for res in results.values():
        assert res["got"] == [(False, False)] * 3
        assert res["seq"] == {0: 3}  # one round-stamped name per poll round
    assert world.runner.payloads == []


@pytest.mark.parametrize("kinds", [["port", "port"], ["ref", "port"], ["port", "ref"]])
def test_explicit_resize_grows_through_the_runner(kinds, tls):
    """resize_cluster(3) (api.resize(3)): Cluster.resize picks the new
    worker's port; the runner gets the Stage and starts it; every peer
    moves to version 1 and size 3."""
    world = World(tls, kinds, ["port"], None)
    world.joiners = []  # the port Cluster.resize picks is not pre-reserved

    def worker(kind, peer):
        mod = api if kind == "port" else rapi
        if peer.cluster_version == 0:
            got = mod.resize(3)
        else:
            got = None
        mod.run_barrier()
        return {"got": got, "version": peer.cluster_version, "size": peer.size, "steps": []}

    def handle(src, msg):
        world.runner.payloads.append(bytes(msg.data))
        stage = Stage.from_json(json.loads(bytes(msg.data).decode()))
        for w in stage.cluster.workers:
            if str(w) not in world.started:
                world.spawn("port", str(w), stage)

    world.runner.server.register(ConnType.CONTROL, handle)
    world.worker = worker
    results = world.run()
    assert len(results) == 3
    assert all(r["version"] == 1 and r["size"] == 3 for r in results.values())
    assert sum(r["got"] == (True, False) for r in results.values()) == len(kinds)


@pytest.mark.parametrize("kinds", [["port", "port"], ["ref", "port"], ["port", "ref"]])
def test_change_cluster_sends_a_reload_stage_and_detaches_all(kinds, tls):
    """Reload mode: the agreed cluster goes to the runner with Reload
    set (the reference's bytes) and every peer detaches."""
    world = World(tls, kinds, [], None)
    world.runner.handle = lambda src, msg: world.runner.payloads.append(bytes(msg.data))
    world.runner.server.register(ConnType.CONTROL, world.runner.handle)
    spare = free_ports(1)[0]

    def worker(kind, peer):
        mod = api if kind == "port" else rapi
        if peer.rank == 0:
            world.put(world.specs[:len(kinds)] + [f"127.0.0.1:{spare}"])
        mod.run_barrier()
        got = mod.change_cluster(7)
        return {"got": got, "detached": peer.detached, "steps": []}

    world.worker = worker
    results = world.run()
    assert all(r["got"] == (True, True) and r["detached"] for r in results.values())
    ref = json.dumps({"Version": 1, "Progress": 7, "Cluster": RCluster.from_json(
        {"Runners": [str(world.runner.id)],
         "Workers": world.specs[:len(kinds)] + [f"127.0.0.1:{spare}"]}).to_json(),
        "Reload": True}).encode()
    assert world.runner.payloads == [ref]


@pytest.mark.parametrize("rounds", [1, 2, 5])
def test_consensus_names_are_stamped_per_epoch_and_round(rounds):
    """`_cfg_consensus_name` follows the reference's sequence: per
    version, per kind-independent round."""
    class Bare:
        pass

    mine, theirs = Bare(), Bare()
    for o in (mine, theirs):
        o._cfg_consensus_seq, o.cluster_version = {}, 0
    got, want = [], []
    for v in range(3):
        mine.cluster_version = theirs.cluster_version = v
        for i in range(rounds):
            kind = "cfg" if i % 2 == 0 else "reload"
            got.append(Peer._cfg_consensus_name(mine, kind))
            want.append(rpeer_mod.Peer._cfg_consensus_name(theirs, kind))
    assert got == want and len(set(got)) == len(got)
