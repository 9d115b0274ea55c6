"""The port's runner (`kungfu_tpu_torch/runner/`, `cmd.py`) against the
JAX package's: kfrun's parser and the worker environments it plans, the
Stage digests, card slots, CPU affinity, platform discovery, the
heartbeat monitor, the watcher's decisions over fake processes, the
standby's FIFO protocol and the orphan-protection shim, each on the same
inputs in both packages; then the port's kfrun spawned in its simple,
reload and monitored (`-auto-recover`) modes and behind `distribute`
with a fake ssh, one world at a time, on free ports outside 38000-38999."""

import argparse
import json
import os
import signal
import stat
import subprocess
import sys
import textwrap
import time
import urllib.request
from pathlib import Path

import pytest

from kungfu_tpu.base.strategy import Strategy as RStrategy
from kungfu_tpu.plan.cluster import Cluster as RCluster
from kungfu_tpu.plan.hostspec import HostList as RHostList
from kungfu_tpu.runner import affinity as raff
from kungfu_tpu.runner import cli as rcli
from kungfu_tpu.runner import monitored as rmon
from kungfu_tpu.runner import platform as rplat
from kungfu_tpu.runner import proc as rproc
from kungfu_tpu.runner import slots as rslots
from kungfu_tpu.runner import standby as rstandby
from kungfu_tpu.runner import watch as rwatch
from kungfu_tpu_torch import cmd
from kungfu_tpu_torch.base.strategy import Strategy
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.plan.cluster import Cluster
from kungfu_tpu_torch.plan.hostspec import HostList
from kungfu_tpu_torch.runner import affinity, cli, monitored, platform, proc, slots, standby, watch

from test_torch_port_worlds import free_ports

REPO = Path(__file__).resolve().parent.parent
RUN_TIMEOUT = 180  # seconds one spawned world may take


def free_range(n: int) -> int:
    """The first of n consecutive ports that bind now, in 12000-19999
    (below the ephemeral range, outside kfrun's 38000-38999 and the
    device plane's 20000-29999)."""
    import random
    import socket

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(12000, 20000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    for k in [k for k in env if k.startswith("KF_")]:
        env.pop(k)
    return env


def kfrun(args, timeout=RUN_TIMEOUT, **kw):
    return subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.runner.cli", *args],
                          env=port_env(), capture_output=True, text=True, timeout=timeout,
                          cwd=REPO, **kw)


# ---------------------------------------------------------------------------
# kfrun's parser and the worker environments it plans
# ---------------------------------------------------------------------------

ARGVS = [
    [],
    ["-np", "4"],
    ["-np", "3", "-H", "127.0.0.1:4"],
    ["-np", "4", "-H", "10.0.0.1:2,10.0.0.2:2", "-self", "10.0.0.2"],
    ["-np", "6", "-H", "10.0.0.1:4,10.0.0.2:4", "-self", "10.0.0.1", "-strategy", "RING"],
    ["-np", "2", "-port-range", "21000-21010", "-runner-port", "21500"],
    ["-np", "2", "-w", "-builtin-config-port", "0", "-warm-spares", "2"],
    ["-np", "2", "-w", "-config-server", "http://127.0.0.1:9100/config"],
    ["-np", "2", "-elastic-mode", "reload", "-w"],
    ["-np", "2", "-auto-recover", "5s", "-monitor-port", "0"],
    ["-np", "2", "-auto-recover", "500ms", "-monitor-peers", "127.0.0.1:7756,127.0.0.2:7756"],
    ["-np", "4", "-H", "127.0.0.1:4", "-devices-per-host", "8"],
    ["-np", "2", "-H", "127.0.0.1:2", "-devices-per-host", "2", "-use-affinity"],
    ["-np", "2", "-standby-preload", "none", "-debug-port", "0"],
    ["-np", "1", "-logdir", "/tmp/x", "-q", "-delay", "0.5", "-timeout", "30"],
    ["-np", "2", "-strategy", "BINARY_TREE_STAR"],
    ["-np", "2", "-strategy", "STAR", "-H", "127.0.0.1:3"],
    ["-np", "5", "-H", "127.0.0.1:2,127.0.0.2:3", "-self", "127.0.0.2"],
]


def _parsed(parser_mod, argv):
    return vars(parser_mod.build_parser().parse_args(argv + ["--", "python3", "w.py"]))


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults" for a in ARGVS])
def test_parser_reads_every_flag_as_the_reference(argv):
    assert _parsed(cli, argv) == _parsed(rcli, argv)


def _plan(pkg, args):
    """The cluster and this host's worker environments, as main() plans
    them, in package `pkg` (the port or the reference)."""
    HL, Cl, St, mod = ((HostList, Cluster, Strategy, cli) if pkg == "port"
                       else (RHostList, RCluster, RStrategy, rcli))
    hosts = HL.parse(args.hosts or f"127.0.0.1:{args.np}")
    cluster = Cl(runners=hosts.gen_runner_list(args.runner_port),
                 workers=hosts.gen_peer_list(args.np, mod.parse_port_range(args.port_range)))
    cluster.validate()
    self_host = args.self_host or mod.infer_self_host(hosts)
    args.host_capacity = next((h.slots for h in hosts if h.host == self_host), 1)
    procs = mod.make_worker_procs(args, ["python3", "w.py"], cluster, self_host,
                                  St.parse(args.strategy), "http://cfg/config")
    envs = []
    for p in procs:
        env = dict(p.env)
        env.pop("KF_SPAWN_TS")
        env.pop("TPU_VISIBLE_DEVICES", None)  # the port's slots ride KF_DEVICE_SLOTS alone
        envs.append((p.name, p.rank, env, p.argv, p.cpus))
    return cluster.to_bytes(), [str(w) for w in cluster.workers], \
        [str(r) for r in cluster.runners], envs


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "defaults" for a in ARGVS])
def test_planned_cluster_and_worker_environments_match_the_reference(argv):
    mine = _plan("port", argparse.Namespace(**_parsed(cli, argv)))
    theirs = _plan("ref", argparse.Namespace(**_parsed(rcli, argv)))
    assert mine == theirs
    assert all("TPU_VISIBLE_DEVICES" not in p.env and "CUDA_VISIBLE_DEVICES" not in p.env
               for p in cli.make_worker_procs(
                   argparse.Namespace(**_parsed(cli, argv), host_capacity=8),
                   ["w"], Cluster.from_json({"Runners": ["127.0.0.1:1"],
                                             "Workers": ["127.0.0.1:2"]}),
                   "127.0.0.1", Strategy.STAR))


@pytest.mark.parametrize("spec", ["", "38000", "100-200", "5-5"])
def test_port_range_parsing(spec):
    if not spec:
        for mod in (cli, rcli):
            with pytest.raises(ValueError):
                mod.parse_port_range(spec)
        return
    assert cli.parse_port_range(spec) == rcli.parse_port_range(spec)


def test_kfrun_refuses_bad_plans_as_the_reference():
    for argv in ([], ["-np", "2", "-H", "127.0.0.1:1", "x"],
                 ["-np", "4", "-devices-per-host", "2", "-H", "127.0.0.1:4", "x"]):
        assert cli.main(argv) == rcli.main(argv) == 2


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

STAGES = [
    {"Version": 0, "Cluster": {"Runners": ["127.0.0.1:38080"], "Workers": ["127.0.0.1:38000"]}},
    {"Version": 3, "Progress": 640,
     "Cluster": {"Runners": ["127.0.0.1:38080"],
                 "Workers": ["127.0.0.1:38000", "127.0.0.1:38001", "127.0.0.1:38002"]}},
    {"Version": 7, "Progress": 12, "Reload": True,
     "Cluster": {"Runners": ["10.0.0.1:38080", "10.0.0.2:38080"],
                 "Workers": ["10.0.0.2:38000", "10.0.0.1:38000"]}},
    {"Version": "12", "Progress": "5",
     "Cluster": {"Runners": ["h:1"], "Workers": []}},
    {"Version": 1, "Reload": False,
     "Cluster": {"Runners": ["127.0.0.1:1"], "Workers": ["127.0.0.1:2", "127.0.0.1:3"]}},
    {"Version": 1000000, "Progress": 1 << 40,
     "Cluster": {"Runners": ["127.0.0.1:1"], "Workers": ["127.0.0.1:2"]}},
]


@pytest.mark.parametrize("i", range(len(STAGES)))
def test_stage_from_json_and_digest_match_the_reference(i):
    obj = json.loads(json.dumps(STAGES[i]))
    mine, theirs = watch.Stage.from_json(obj), rwatch.Stage.from_json(obj)
    assert (mine.version, mine.progress, mine.reload) == \
        (theirs.version, theirs.progress, theirs.reload)
    assert mine.digest() == theirs.digest()
    assert mine.cluster.to_bytes() == theirs.cluster.to_bytes()
    # and back to the bytes a worker sends
    assert watch.Stage.from_json(mine.to_json()).digest() == mine.digest()


# ---------------------------------------------------------------------------
# card slots
# ---------------------------------------------------------------------------

SLOT_OPS = [
    [("get", 2), ("get", 1), ("put", [0]), ("get", 2), ("available",)],
    [("get", 5)],
    [("get", 4), ("put", [3, 1]), ("put", [1]), ("available",)],
    [("put", [9]), ("get", 5), ("available",)],
    [("get", 0), ("get", 4), ("get", 1)],
]


def _run_ops(pool, ops):
    out = []
    for op in ops:
        try:
            if op[0] == "get":
                out.append(pool.get(op[1]))
            elif op[0] == "put":
                out.append(pool.put(op[1]))
            else:
                out.append(pool.available)
        except (RuntimeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    return out, pool.capacity, pool.available


@pytest.mark.parametrize("i", range(len(SLOT_OPS)))
def test_slot_pool_sequences_match_the_reference(i):
    assert _run_ops(slots.SlotPool.of_size(4), SLOT_OPS[i]) == \
        _run_ops(rslots.SlotPool.of_size(4), SLOT_OPS[i])
    assert _run_ops(slots.SlotPool([7, 3, 3, 5]), SLOT_OPS[i]) == \
        _run_ops(rslots.SlotPool([7, 3, 3, 5]), SLOT_OPS[i])


@pytest.mark.parametrize("n_dev", range(0, 10))
def test_slot_partition_matches_the_reference(n_dev):
    for n_workers in range(-1, 6):
        assert slots.partition(n_dev, n_workers) == rslots.partition(n_dev, n_workers)


# ---------------------------------------------------------------------------
# CPU affinity and platforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", ["0-3", "0-3,8,10-11", "5", "", "2,1,1,0-1", "0-0,7-9\n"])
def test_cpulist_parsing_matches_the_reference(text):
    assert affinity.parse_cpulist(text) == raff.parse_cpulist(text)


TOPOLOGIES = [
    (8, None, []),
    (8, None, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (16, None, [list(range(8)), list(range(8, 16))]),
    (12, [0, 1, 2, 3, 8, 9], [[0, 1, 2, 3], [8, 9, 10, 11]]),
    (6, None, [[0, 1], [2, 3], [4, 5]]),
    (4, None, [[0, 1, 2, 3]]),
    (32, None, [list(range(i, i + 8)) for i in range(0, 32, 8)]),
]


@pytest.mark.parametrize("i", range(len(TOPOLOGIES)))
def test_plan_affinity_on_fake_topologies_matches_the_reference(i):
    n_cpus, cpus, nodes = TOPOLOGIES[i]
    cpus = cpus if cpus is not None else list(range(n_cpus))
    for n_workers in range(0, 7):
        assert affinity.plan_affinity(n_workers, cpus, nodes) == \
            raff.plan_affinity(n_workers, cpus, nodes)
        if n_workers:
            assert affinity.partition(cpus, n_workers) == raff.partition(cpus, n_workers)


def test_numa_nodes_from_a_fake_sysfs(tmp_path):
    for i, text in enumerate(["0-3\n", "4-7\n", ""]):
        (tmp_path / f"node{i}").mkdir()
        (tmp_path / f"node{i}" / "cpulist").write_text(text)
    (tmp_path / "nodeX").mkdir()
    assert affinity.numa_nodes(str(tmp_path)) == raff.numa_nodes(str(tmp_path)) == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert affinity.numa_nodes(str(tmp_path / "none")) == []


TPU_ENVS = [
    {"TPU_WORKER_ID": "1", "TPU_WORKER_HOSTNAMES": "a,b,c"},
    {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": " a , b ,"},
    {"TPU_WORKER_HOSTNAMES": "only"},
    {},
    {"TPU_WORKER_ID": "3", "TPU_WORKER_HOSTNAMES": "a,b"},
]


def _outcome(fn):
    try:
        got = fn()
    except ValueError as e:
        return ("ValueError", str(e))
    if got is None:
        return None
    return ([(h.host, h.slots) for h in got.hosts], got.self_host, got.self_index)


@pytest.mark.parametrize("i", range(len(TPU_ENVS)))
def test_tpu_env_discovery_matches_the_reference(i):
    for slots_per_host in (1, 4):
        assert _outcome(lambda: platform.from_tpu_env(TPU_ENVS[i], slots_per_host)) == \
            _outcome(lambda: rplat.from_tpu_env(TPU_ENVS[i], slots_per_host))


METADATA = [
    {"agent-worker-number": "2", "worker-network-endpoints": "10.0.0.7:8470,10.0.0.8,10.0.0.9:1:8470"},
    {"agent-worker-number": "0", "worker-network-endpoints": ""},
    {"agent-worker-number": "5", "worker-network-endpoints": "10.0.0.1,10.0.0.2"},
    {},
]


@pytest.mark.parametrize("i", range(len(METADATA)))
def test_metadata_discovery_matches_the_reference(i):
    def fetch(attr):
        if attr not in METADATA[i]:
            raise OSError("no such attribute")
        return METADATA[i][attr]

    assert _outcome(lambda: platform.from_gce_metadata(fetch)) == \
        _outcome(lambda: rplat.from_gce_metadata(fetch))
    # "auto" tries the environment first, then the (fake) metadata server
    assert _outcome(lambda: platform.detect("auto", {}, fetch)) == \
        _outcome(lambda: rplat.detect("auto", {}, fetch))
    with pytest.raises(ValueError):
        platform.detect("nowhere", {}, fetch)


# ---------------------------------------------------------------------------
# the heartbeat monitor
# ---------------------------------------------------------------------------

HEARTBEATS = [
    [("begin", 0), ("end", 0), ("epoch", 0), ("epoch", 1)],
    [("epoch", 0), ("epoch", 0), ("epoch", 1), ("trainend", 0), ("trainend", 1)],
    [("begin", 1), ("otherdown", 3), ("epoch", 1)],
    [("epoch", 0), ("otherfinish", 0), ("reset", 4), ("epoch", 1)],
    [("begin", 0), ("trainend", 0), ("begin", 1), ("reset", 2), ("epoch", 0), ("epoch", 1),
     ("epoch", 1)],
    [("bogus", 0), ("end", 5)],
]


def _beats(state, seq):
    out = []
    for kind, v in seq:
        if kind == "reset":
            state.reset(v)
        else:
            state.signal(kind, v)
        out.append((sorted(state.in_batch), dict(state.epochs), state.base_epoch,
                    dict(state.train_ended), state.other_down, state.other_finish,
                    state.min_epoch(), state.min_epoch(2), state.all_done(2),
                    sorted(state.stuck_ranks(0.0)), state.stuck_ranks(60.0)))
    return out


@pytest.mark.parametrize("i", range(len(HEARTBEATS)))
def test_heartbeat_state_sequences_match_the_reference(i):
    assert _beats(monitored.HeartbeatState(), HEARTBEATS[i]) == \
        _beats(rmon.HeartbeatState(), HEARTBEATS[i])


@pytest.mark.parametrize("spec", ["10s", "250ms", "2m", "1.5", " 3s "])
def test_parse_duration_matches_the_reference(spec):
    assert monitored.parse_duration(spec) == rmon.parse_duration(spec)


def test_heartbeats_reach_either_packages_monitor():
    """The port's send_heartbeat (and cmd's helpers) and the reference's
    POST the same bodies: both monitors count them alike; a bad body is
    a 400, a missing monitor no error."""
    states = [monitored.HeartbeatState(), rmon.HeartbeatState()]
    servers = [monitored.MonitorServer(states[0], 0), rmon.MonitorServer(states[1], 0)]
    for s in servers:
        s.start()
    try:
        for s in servers:
            for send in (monitored.send_heartbeat, rmon.send_heartbeat):
                send("begin", 1, port=s.port)
                send("epoch", 1, host="127.0.0.1", port=s.port)
        for st in states:
            assert sorted(st.in_batch) == [1] and st.epochs == {1: 2}
        req = urllib.request.Request(f"http://127.0.0.1:{servers[0].port}/signal",
                                     data=b"begin:x", method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 400
        dead = free_ports(1)[0]
        monitored.send_heartbeat("end", 0, port=dead)  # best-effort: no monitor, no error
    finally:
        for s in servers:
            s.stop()


def test_cmd_helpers_post_to_the_monitor_from_the_environment(monkeypatch):
    state = monitored.HeartbeatState()
    server = monitored.MonitorServer(state, 0)
    server.start()
    try:
        monkeypatch.setenv(monitored.MONITOR_ADDR_ENV, f"127.0.0.1:{server.port}")
        cmd.monitor_batch_begin(3)
        cmd.monitor_epoch_end(3)
        cmd.monitor_batch_end(3)
        cmd.monitor_train_end(3)
        assert state.epochs == {3: 1} and state.train_ended == {3: True} and not state.in_batch
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the watcher's decisions over fake processes
# ---------------------------------------------------------------------------

class FakePopen:
    """A Popen that runs nothing: alive until `exit(code)`."""
    _pid = [1000]

    def __init__(self):
        FakePopen._pid[0] += 1
        self.pid, self.returncode = FakePopen._pid[0], None

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode

    def terminate(self):
        self.returncode = -15

    kill = terminate


@pytest.fixture
def fake_spawns(monkeypatch):
    def start(self):
        self.proc = FakePopen()

    for mod in (proc, rproc):
        monkeypatch.setattr(mod.WorkerProc, "start", start)


def _watcher(pkg, n_dev=0, cap=4, auto_recover=""):
    W, St = (watch.Watcher, Strategy) if pkg == "port" else (rwatch.Watcher, RStrategy)
    args = argparse.Namespace(runner_port=38080, elastic_mode="", logdir="", quiet=True,
                              devices_per_host=n_dev, host_capacity=cap, debug_port=-1,
                              warm_spares=0, auto_recover=auto_recover, timeout=0.0)
    return W(args, ["python3", "w.py"], "127.0.0.1", St.STAR, "")


def _stage(pkg, version, members, progress=0, reload=False, hosts=("127.0.0.1",)):
    S = watch.Stage if pkg == "port" else rwatch.Stage
    return S.from_json({"Version": version, "Progress": progress, "Reload": reload,
                        "Cluster": {"Runners": [f"{h}:38080" for h in hosts],
                                    "Workers": [f"127.0.0.1:{38000 + i}" for i in members]}})


def _view(w):
    """What the watcher decided: running workers with their env, the
    leavers it waits for, the card slots."""
    cur = {}
    for peer, p in w.current.items():
        env = dict(p.env)
        env.pop("KF_SPAWN_TS")
        env.pop("TPU_VISIBLE_DEVICES", None)
        env.pop("KF_MONITOR_ADDR", None)  # an ephemeral port of each watcher's own monitor
        cur[str(peer)] = (p.name, p.rank, env, p.running)
    return (cur, sorted(p.name for p in w._gone), {str(k): v for k, v in w._worker_slots.items()},
            w.slot_pool.available if w.slot_pool else None)


PLANS = {
    "grow-shrink": [(0, [0, 1]), (1, [0, 1, 2]), (2, [0, 2])],
    "grow-by-two": [(0, [0]), (1, [0, 1, 2]), (2, [1, 2])],
    "swap": [(0, [0, 1]), (1, [1, 0]), (2, [2, 3])],
    "reload": [(0, [0, 1]), (1, [0, 1, 2], True), (2, [1], True)],
    "mixed": [(0, [0, 1, 2, 3]), (1, [3], False), (2, [3, 0], True), (3, [3, 0, 1])],
}


@pytest.mark.parametrize("n_dev,cap", [(0, 4), (8, 4), (4, 4)])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_watcher_applies_stages_as_the_reference(plan, n_dev, cap, fake_spawns):
    """apply_delta/apply_full over a plan of Stages: the same workers
    spawned with the same environments, leavers, and card slots."""
    views = {}
    for pkg in ("port", "ref"):
        w = _watcher(pkg, n_dev, cap)
        seen = []
        for step in PLANS[plan]:
            version, members, *rest = step
            st = _stage(pkg, version, members, progress=10 * version, reload=bool(rest and rest[0]))
            (w.apply_full if st.reload else w.apply_delta)(st)
            seen.append(_view(w))
        views[pkg] = seen
    assert views["port"] == views["ref"]


@pytest.mark.parametrize("auto", ["", "3s"])
def test_watcher_control_endpoint_and_recovery_match_the_reference(auto, fake_spawns):
    """Stages through handle_control (dedupe, the diverged-version abort)
    and a worker's death under -auto-recover: the recovery Stage's
    version, progress and members, and what it spawns."""
    from kungfu_tpu.transport.message import Message as RMessage
    from kungfu_tpu_torch.transport.message import Message

    out = {}
    for pkg in ("port", "ref"):
        w = _watcher(pkg, auto_recover=auto)
        M = Message if pkg == "port" else RMessage
        init = _stage(pkg, 0, [0, 1, 2])
        w.seen_versions[0] = init.digest()
        w.apply_delta(init)
        body = json.dumps(_stage(pkg, 1, [0, 1, 2, 3], progress=64).to_json()
                          if pkg == "port" else
                          {"Version": 1, "Progress": 64, "Cluster": _stage(
                              pkg, 1, [0, 1, 2, 3]).cluster.to_json()}).encode()
        w.handle_control(None, M(name="update", data=body))
        w.handle_control(None, M(name="update", data=body))  # a duplicate
        w.handle_control(None, M(name="other", data=b"x"))
        queued = w.stage_q.qsize()
        w.apply_delta(w.stage_q.get())
        # a worker dies: recovery shrinks it out and reloads the rest
        victim = sorted(w.current, key=str)[1]
        w.current[victim].proc.returncode = 9
        dead = w._dead_workers()
        w.recover_from_failure(dead)
        stages = list(w.stage_log)
        view = _view(w)
        w.handle_control(None, M(name="update", data=json.dumps(
            {"Version": 1, "Progress": 0, "Cluster": {"Runners": ["127.0.0.1:38080"],
                                                      "Workers": ["127.0.0.1:38000"]}}).encode()))
        out[pkg] = (queued, [str(d) for d in dead], stages, view, w.exit_code, w.done.is_set())
        if w.monitor is not None:
            w.monitor.stop()
    assert out["port"] == out["ref"]
    assert out["port"][4] == 1 and out["port"][5]  # the diverged version aborts


def test_debug_server_dumps_the_stages(fake_spawns):
    w = _watcher("port")
    w.apply_delta(_stage("port", 0, [0, 1]))
    w.record_stage(_stage("port", 0, [0, 1]))
    srv = watch.DebugServer(w, 0)
    srv.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/", timeout=5) as r:
            dump = json.loads(r.read())
    finally:
        srv.stop()
    assert dump["self"] == "127.0.0.1" and len(dump["stages"]) == 1
    assert set(dump["workers"].values()) == {"running"}


# ---------------------------------------------------------------------------
# standbys and the orphan-protection shim
# ---------------------------------------------------------------------------

def test_auto_preload_is_the_ports_device_stack():
    assert standby.resolve_preload("auto") == "torch,kungfu_tpu_torch.api"
    for spec in ("none", "", "numpy,json"):
        assert standby.resolve_preload(spec) == rstandby.resolve_preload(spec)


_NO_CUDA_PROBE = r"""
import importlib, pkgutil, sys
import torch
def refuse(*a, **k):
    raise RuntimeError("torch.cuda touched at import")
for name in ("is_available", "current_device", "device_count", "init", "_lazy_init",
             "synchronize", "set_device", "get_device_name"):
    setattr(torch.cuda, name, refuse)
import kungfu_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kungfu_tpu_torch.__path__, "kungfu_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import kungfu_tpu_torch.api
print("OK", len(names), torch.cuda.is_initialized())
"""


def test_no_module_of_the_port_touches_cuda_at_import():
    """What a standby preloads must not create a CUDA context before the
    worker's slot is known."""
    r = subprocess.run([sys.executable, "-c", _NO_CUDA_PROBE], cwd=REPO, env=port_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    ok, n, initialized = r.stdout.split()
    assert ok == "OK" and int(n) > 60 and initialized == "False"


@pytest.mark.parametrize("how", ["-c", "-m", "script"])
def test_standby_runs_its_activation_in_process(how, tmp_path):
    """A standby preloads the port's stack, then runs the activated
    command (-c, -m or a script) with the activation's environment; the
    CUDA state is untouched after the preload."""
    script = tmp_path / "job.py"
    script.write_text("import os, sys, torch\n"
                      "print('JOB', os.environ['KF_GREETING'], sys.argv[1:],"
                      " torch.cuda.is_initialized(), 'kungfu_tpu_torch.api' in sys.modules)\n")
    argv = {"-c": [sys.executable, "-c", script.read_text(), "a", "b"],
            "-m": [sys.executable, "-m", "job", "a", "b"],
            "script": [sys.executable, str(script), "a", "b"]}[how]
    pool = standby.StandbyPool(1, logdir=str(tmp_path / "logs"), quiet=True,
                               preload=standby.resolve_preload("auto"))
    old = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = os.pathsep.join([str(REPO), str(tmp_path), old])
    try:
        pool.refill()
        slot = pool.take()
        deadline = time.time() + 60
        while not slot.activate({"KF_GREETING": "warm"}, argv, "w0", 0):
            assert time.time() < deadline, "standby never opened its fifo"
            time.sleep(0.1)
        assert slot.proc.wait(120) == 0
        out = "\n".join(slot.proc.output_tail())
        assert "JOB warm ['a', 'b'] False True" in out, out
        assert slot.proc.name == "w0" and not os.path.exists(slot.fifo)
    finally:
        os.environ["PYTHONPATH"] = old
        pool.kill_all()


def test_a_dead_standby_is_skipped_and_refilled():
    pool = standby.StandbyPool(2, quiet=True, preload="")
    try:
        pool.refill()
        first = pool.slots[0]
        first.proc.kill()
        assert not first.activate({}, ["true"], "x", 0, wait=0.5)
        got = pool.take()
        assert got is not None and got.alive and got is not first
        pool.refill()
        assert len(pool.slots) == 2
    finally:
        pool.kill_all()


def test_the_shim_builds_and_a_failed_build_raises(tmp_path, monkeypatch):
    shim = _build.compile_pdeathsig()
    assert shim.is_file() and os.access(shim, os.X_OK)
    assert shim.parent == _build.BUILD_DIR and shim.name.startswith("kf-pdeathsig-")
    r = subprocess.run([str(shim), sys.executable, "-c", "print('through the shim')"],
                       capture_output=True, text=True, timeout=30)
    assert r.stdout.strip() == "through the shim"
    assert subprocess.run([str(shim)], capture_output=True).returncode == 2
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    with pytest.raises(RuntimeError, match="kf-pdeathsig"):
        _build.compile_pdeathsig(str(fake))


_RUNNER = r"""
import sys, time
from kungfu_tpu_torch.runner.proc import WorkerProc
p = WorkerProc("w", [sys.executable, "-c", "import time; time.sleep(120)"], {}, quiet=True)
p.start()
print(p.proc.pid, flush=True)
time.sleep(120)
"""


def test_workers_die_with_a_hard_killed_runner():
    """SIGKILL the runner: the shim's PR_SET_PDEATHSIG takes its worker
    down too (the runner's cleanup never runs)."""
    runner = subprocess.Popen([sys.executable, "-c", _RUNNER], stdout=subprocess.PIPE,
                              text=True, env=port_env(), cwd=REPO)
    try:
        child = int(runner.stdout.readline())
        os.kill(runner.pid, signal.SIGKILL)
        runner.wait(10)
        deadline = time.time() + 15
        while time.time() < deadline:
            try:
                os.kill(child, 0)
            except ProcessLookupError:
                break
            with open(f"/proc/{child}/stat") as f:
                if f.read().split()[2] == "Z":
                    break
            time.sleep(0.1)
        else:
            os.kill(child, signal.SIGKILL)
            pytest.fail("the worker outlived its runner")
    finally:
        if runner.poll() is None:
            runner.kill()


def test_run_all_returns_each_workers_exit_code():
    procs = [proc.WorkerProc("bad", [sys.executable, "-c", "raise SystemExit(3)"], {},
                             quiet=True),
             proc.WorkerProc("ok", [sys.executable, "-c", "print('ok')"], {}, rank=1,
                             quiet=True)]
    assert proc.run_all(procs) == [3, 0]
    assert procs[1].output_tail() == ["[ ] ok"]


# ---------------------------------------------------------------------------
# the port's kfrun, spawned: simple, reload, monitored, distribute
# ---------------------------------------------------------------------------

HOST_WORKER = textwrap.dedent("""
    import os, sys, torch
    from kungfu_tpu_torch import api
    rank, size = api.current_rank(), api.cluster_size()
    got = api.all_reduce_array(torch.tensor([rank + 1.0, 2.0]))
    assert got.tolist() == [size * (size + 1) / 2, 2.0 * size], got
    print(f"OK rank={rank}/{size} host={os.environ['KF_SELF_SPEC']}", flush=True)
""")


def test_simple_mode_runs_np2(tmp_path):
    (tmp_path / "w.py").write_text(HOST_WORKER)
    base, runner = free_range(4), free_ports(1)[0]
    r = kfrun(["-np", "2", "-port-range", f"{base}-{base + 3}", "-runner-port", str(runner),
               "-logdir", str(tmp_path / "logs"), "--", sys.executable, str(tmp_path / "w.py")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK rank=0/2" in r.stdout and "OK rank=1/2" in r.stdout
    assert sorted(os.listdir(tmp_path / "logs")) == ["0_2.log", "1_2.log"]
    bad = kfrun(["-np", "2", "-port-range", f"{base}-{base + 3}", "-runner-port", str(runner),
                 "--", sys.executable, "-c", "raise SystemExit(5)"])
    assert bad.returncode == 1 and "2/2 workers failed" in bad.stderr


RELOAD_WORKER = textwrap.dedent("""
    import json, os, sys, urllib.request
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.elastic import ElasticState
    es = ElasticState(max_progress=8, reload_mode=True)
    start = es.progress
    while not es.stopped():
        with es.scope():
            rank, size = api.current_rank(), api.cluster_size()
            if rank == 0 and es.progress == 3 and size == 2:
                url = os.environ["KF_CONFIG_SERVER"]
                runners = os.environ["KF_INIT_RUNNERS"].split(",")
                me = os.environ["KF_INIT_PEERS"].split(",")
                host, port = me[-1].rsplit(":", 1)
                body = json.dumps({"Runners": runners,
                                   "Workers": me + [f"{host}:{int(port) + 1}"]}).encode()
                urllib.request.urlopen(urllib.request.Request(url, data=body, method="PUT"),
                                       timeout=5).read()
            es.end(1)
    print(f"stopped reason={es.stop_reason} start={start} progress={es.progress} "
          f"size={api.cluster_size()}", flush=True)
""")


def test_reload_mode_restarts_the_world_from_the_progress(tmp_path):
    (tmp_path / "w.py").write_text(RELOAD_WORKER)
    base, runner = free_range(4), free_ports(1)[0]
    r = kfrun(["-np", "2", "-H", "127.0.0.1:4", "-w", "-elastic-mode", "reload",
               "-builtin-config-port", "0", "-warm-spares", "0", "-port-range",
               f"{base}-{base + 3}", "-runner-port", str(runner), "-monitor-port", "0",
               "--", sys.executable, str(tmp_path / "w.py")])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [l.split("] ", 1)[1] for l in r.stdout.splitlines() if "stopped reason" in l]
    assert sorted(lines) == sorted(["stopped reason=reload start=0 progress=4 size=2"] * 2
                                   + ["stopped reason=finished start=4 progress=8 size=3"] * 3)


RECOVER_WORKER = textwrap.dedent("""
    import argparse, os, signal, sys, time, torch
    from kungfu_tpu_torch import api, cmd
    ap = argparse.ArgumentParser()
    ap.add_argument("--restart", type=int, default=0)
    args = ap.parse_args()
    rank = api.current_rank()
    start = int(os.environ.get("KF_RECOVER_EPOCH", "0") or 0) if args.restart else 0
    for epoch in range(start, 3):
        cmd.monitor_batch_begin()
        if epoch == 1 and rank == 1 and not args.restart:
            os.kill(os.getpid(), signal.SIGKILL)
        api.all_reduce_array(torch.ones(4), name=f"e{epoch}")
        cmd.monitor_batch_end()
        cmd.monitor_epoch_end()
    cmd.monitor_train_end()
    print(f"done rank={rank} restart={args.restart} from={start}", flush=True)
""")


def test_auto_recover_relaunches_after_a_killed_worker(tmp_path):
    (tmp_path / "w.py").write_text(RECOVER_WORKER)
    base, runner = free_range(4), free_ports(1)[0]
    r = kfrun(["-np", "2", "-auto-recover", "3s", "-monitor-port", "0", "-port-range",
               f"{base}-{base + 3}", "-runner-port", str(runner),
               "--", sys.executable, str(tmp_path / "w.py")])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "restarting" in r.stderr
    done = sorted(l.split("] ", 1)[1] for l in r.stdout.splitlines() if "done rank" in l)
    assert done == ["done rank=0 restart=1 from=1", "done rank=1 restart=1 from=1"], r.stdout


@pytest.fixture
def fake_ssh(tmp_path):
    """An ssh(1) stand-in: `fake_ssh [options...] host command` runs the
    command here, as sshing into this host would."""
    sh = tmp_path / "fake_ssh"
    sh.write_text("#!/bin/sh\n"
                  'while [ "${1#-}" != "$1" ]; do shift; shift; done\n'
                  "shift\n"
                  'exec sh -c "$*"\n')
    sh.chmod(sh.stat().st_mode | stat.S_IEXEC)
    return str(sh)


def test_distribute_launches_one_kfrun_a_host(tmp_path, fake_ssh):
    (tmp_path / "w.py").write_text(HOST_WORKER)
    hosts = "127.0.0.1:1,127.0.0.2:1"
    base, runner = free_range(2), free_ports(1)[0]
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.distribute", "-H", hosts,
         "-ssh", fake_ssh, "--", sys.executable, "-m", "kungfu_tpu_torch.runner.cli",
         "-np", "2", "-H", hosts, "-self", "{host}", "-port-range", f"{base}-{base + 1}",
         "-runner-port", str(runner), sys.executable, str(tmp_path / "w.py")],
        env=port_env(), capture_output=True, text=True, timeout=RUN_TIMEOUT, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "[127.0.0.1]" in r.stdout and "[127.0.0.2]" in r.stdout
    assert "OK rank=0/2 host=127.0.0.1" in r.stdout and "OK rank=1/2 host=127.0.0.2" in r.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.distribute", "-H", hosts,
         "-ssh", fake_ssh, "--", "sh", "-c", "exit {index}"],
        env=port_env(), capture_output=True, text=True, timeout=60, cwd=REPO)
    assert bad.returncode == 1
    none = subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.runner.distribute", "--",
                           "true"], env=port_env(), capture_output=True, text=True, timeout=60,
                          cwd=REPO)
    assert none.returncode == 2


def test_host_argv_matches_the_reference():
    from kungfu_tpu.runner import distribute as rdist
    from kungfu_tpu_torch.runner import distribute

    for cmd_ in (["python", "-c", "print('{host} {index}')"], ["a b", "{host}"]):
        assert distribute.host_argv("ssh -o X=y", "h1", 3, cmd_) == \
            rdist.host_argv("ssh -o X=y", "h1", 3, cmd_)


LAUNCHED = textwrap.dedent("""
    import os, torch
    from kungfu_tpu_torch import api

    def work(rank):
        got = api.all_reduce_array(torch.tensor([rank + 1.0]))
        with open(os.path.join(os.environ["LM_OUT"], f"{rank}.txt"), "w") as f:
            f.write(f"{api.current_rank()} {api.cluster_size()} {got.item()}")

    def fail(rank):
        raise SystemExit(rank)
""")


def test_launch_multiprocess_wires_one_cluster(tmp_path, monkeypatch):
    (tmp_path / "lm_worker.py").write_text(LAUNCHED)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("LM_OUT", str(tmp_path))
    import lm_worker

    cmd.launch_multiprocess(lm_worker.work, 3)
    got = sorted((tmp_path / f"{r}.txt").read_text() for r in range(3))
    assert got == ["0 3 6.0", "1 3 6.0", "2 3 6.0"]
    with pytest.raises(RuntimeError, match=r"workers failed: \[\(1, 1\)\]"):
        cmd.launch_multiprocess(lm_worker.fail, 2)
