"""The port's elastic modules against the JAX package's: the step-based
schedule (parsing, targets, and `maybe_propose` under the reference's
monkeypatched cases), the elastic dataset index for index over grids of
(progress, rank, size), the config server's bodies and status codes
beside the reference's server, ElasticState's leaf order beside
`jax.tree.flatten`; then `examples/elastic_train.py` under the port's
kfrun in watch mode, grown 2 -> 3 -> 2 by config PUTs, its loss
trajectory held against a one-process replay of the same global batches
through the JAX package's MLP."""

import collections
import json
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kungfu_tpu.elastic import configserver as rconfigserver
from kungfu_tpu.elastic import dataset as rdataset
from kungfu_tpu.elastic import schedule as rschedule
from kungfu_tpu.models.mlp import mlp_loss as rmlp_loss
from kungfu_tpu.plan.cluster import Cluster as RCluster
from kungfu_tpu_torch.elastic import configserver, dataset, schedule
from kungfu_tpu_torch.elastic.state import _like, tree_flatten
from kungfu_tpu_torch.examples import elastic_train
from kungfu_tpu_torch.models.mlp import init_mlp
from kungfu_tpu_torch.plan.cluster import Cluster

from test_torch_port_runner import free_range, port_env
from test_torch_port_worlds import free_ports

REPO = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

SPECS = ["2:10,4:20,1:5", " 3:7 ", "1:1", "2:3,4:3,2:3", "8:100,4:1,", "", "0:5", "2:-1",
         "2:0", "x:1", "2", "3:4:5"]


def _parse(mod, spec):
    try:
        return mod.parse_schedule(spec)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_schedule_matches_the_reference(spec):
    assert _parse(schedule, spec) == _parse(rschedule, spec)


@pytest.mark.parametrize("spec", [s for s in SPECS[:5]])
def test_schedule_target_matches_the_reference(spec):
    sched = schedule.parse_schedule(spec)
    total = sum(n for _, n in sched)
    for step in range(-1, total + 3):
        assert schedule.schedule_target(sched, step) == rschedule.schedule_target(sched, step)
    assert schedule.StepBasedSchedule(spec).total_steps() == \
        rschedule.StepBasedSchedule(spec).total_steps() == total


def _patch(monkeypatch, mod, rank, size, fail_once=False):
    calls = []
    state = {"fail": fail_once}

    def propose(n):
        if state["fail"]:
            state["fail"] = False
            raise ConnectionError("config server blip")
        calls.append(n)

    monkeypatch.setattr(mod.api, "current_rank", lambda: rank)
    monkeypatch.setattr(mod.api, "cluster_size", lambda: size)
    monkeypatch.setattr(mod.api, "propose_new_size", propose)
    return calls


def _both(monkeypatch, rank, size, fail_once=False):
    return {m: _patch(monkeypatch, m, rank, size, fail_once) for m in (schedule, rschedule)}


def test_a_failed_proposal_is_retried(monkeypatch):
    calls = _both(monkeypatch, rank=0, size=2, fail_once=True)
    for m in (schedule, rschedule):
        s = m.StepBasedSchedule("4:10")
        assert s.maybe_propose(0) is None  # the blip is swallowed
        assert s.maybe_propose(1) == 4  # retried
        assert s.maybe_propose(2) is None  # proposed, awaiting consensus
        assert calls[m] == [4]


def test_a_new_acting_rank0_reproposes(monkeypatch):
    calls = _both(monkeypatch, rank=1, size=2)
    for m in (schedule, rschedule):
        s = m.StepBasedSchedule("4:10")
        assert s.maybe_propose(0) is None  # not rank 0: never proposes
        monkeypatch.setattr(m.api, "current_rank", lambda: 0)
        assert s.maybe_propose(1) == 4
        assert calls[m] == [4]


def test_a_satisfied_target_is_not_proposed(monkeypatch):
    calls = _both(monkeypatch, rank=0, size=4)
    for m in (schedule, rschedule):
        s = m.StepBasedSchedule("4:10,2:5")
        assert s.maybe_propose(0) is None  # already at 4
        assert calls[m] == []
        assert s.maybe_propose(10) == 2  # the next boundary proposes
        assert calls[m] == [2]
        assert s.maybe_propose(20) is None  # exhausted


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_maybe_propose_over_a_schedule_matches_the_reference(size, monkeypatch):
    """Step by step over "2:3,4:3,2:3" at a fixed observed size, the
    proposals and returns agree; REPROPOSE_AFTER rate-limits repeats."""
    calls = _both(monkeypatch, rank=0, size=size)
    got = {}
    for m in (schedule, rschedule):
        s = m.StepBasedSchedule("2:3,4:3,2:3")
        got[m] = [s.maybe_propose(step) for step in range(11)]
        s.REPROPOSE_AFTER = 0.0
        got[m].append(s.maybe_propose(4))
    assert got[schedule] == got[rschedule] and calls[schedule] == calls[rschedule]


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,batch,seed", [(100, 8, 1), (10, 8, 0), (4096, 64, 1), (37, 5, 7),
                                          (16, 16, 3), (1000, 10, 42)])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_dataset_batches_match_the_reference_index_for_index(n, batch, seed, size):
    x = np.arange(n, dtype=np.int64)
    y = (np.arange(n) * 7 % 13).astype(np.float32)
    mine = dataset.ElasticDataset([x, y], batch, seed=seed)
    theirs = rdataset.ElasticDataset([x, y], batch, seed=seed)
    step = batch * size
    for progress in list(range(0, 5 * step, step)) + [n - 1, 3 * n + 2]:
        for rank in range(size):
            a, b = mine.batch_at(progress, rank, size), theirs.batch_at(progress, rank, size)
            assert len(a) == 2 and all(np.array_equal(u, v) and u.dtype == v.dtype
                                       for u, v in zip(a, b))
            assert np.array_equal(x[mine.indices_at(progress, rank, size)], b[0])
    assert mine.cluster_delta(size) == theirs.cluster_delta(size)


def test_dataset_steps_cover_an_epoch_without_repeats():
    """Progress continuity across a resize: 2 ranks, then 3, then 2, in
    one epoch, never repeat a sample and cover a contiguous prefix of
    the epoch's order."""
    ds = dataset.ElasticDataset([np.arange(600)], 10, seed=1)
    seen, progress = [], 0
    for size in [2] * 5 + [3] * 6 + [2] * 4:
        for r in range(size):
            seen.extend(ds.indices_at(progress, r, size).tolist())
        progress += ds.cluster_delta(size)
    assert len(seen) == len(set(seen)) == progress == 360
    assert seen == ds._epoch_perm(0)[:360].tolist()


def test_dataset_rejects_what_the_reference_rejects():
    for bad in ([], [np.arange(4), np.arange(5)]):
        for m in (dataset, rdataset):
            with pytest.raises(ValueError):
                m.ElasticDataset(bad, 2)


# ---------------------------------------------------------------------------
# the config server
# ---------------------------------------------------------------------------

INITIAL = {"Runners": ["127.0.0.1:38080"], "Workers": ["127.0.0.1:38000", "127.0.0.1:38001"]}
GROWN = {"Runners": ["127.0.0.1:38080"],
         "Workers": ["127.0.0.1:38000", "127.0.0.1:38001", "127.0.0.1:38002"]}
REQUESTS = {
    "get": [("GET", "/config", None)],
    "put-get": [("PUT", "/config", GROWN), ("GET", "/config", None), ("GET", "/", None)],
    "put-twice": [("PUT", "/config", GROWN), ("PUT", "/config", INITIAL), ("GET", "/config", None)],
    "put-invalid": [("PUT", "/config", {"Runners": [], "Workers": ["127.0.0.1:1"]}),
                    ("GET", "/config", None)],
    "put-garbage": [("PUT", "/config", "{not json"), ("GET", "/config", None)],
    "put-duplicate": [("PUT", "/config", {"Runners": ["127.0.0.1:1"],
                                          "Workers": ["127.0.0.1:2", "127.0.0.1:2"]})],
    "delete": [("DELETE", "/config", None), ("GET", "/config", None),
               ("PUT", "/config", GROWN), ("GET", "/config", None)],
    "post-reset": [("PUT", "/config", GROWN), ("POST", "/config", INITIAL),
                   ("GET", "/config", None)],
    "post-empty": [("POST", "/config", ""), ("GET", "/config", None)],
    "stop": [("GET", "/stop", None)],
}


def _request(port, method, path, body):
    data = None
    if body is not None:
        data = (body if isinstance(body, str) else json.dumps(body)).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_config_server_answers_as_the_reference(case):
    replies, stopped = {}, {}
    for name, mod, C in (("port", configserver, Cluster), ("ref", rconfigserver, RCluster)):
        srv = mod.ConfigServer(0, C.from_json(INITIAL), host="127.0.0.1")
        srv.start()
        try:
            replies[name] = [_request(srv.port, *r) for r in REQUESTS[case]]
            stopped[name] = srv.stop_event.wait(5) if case == "stop" else srv.stop_event.is_set()
        finally:
            srv.stop()
    assert replies["port"] == replies["ref"]
    assert stopped["port"] == stopped["ref"] == (case == "stop")


def test_config_server_main_serves_an_initial_file(tmp_path):
    (tmp_path / "c.json").write_text(json.dumps(INITIAL))
    port = free_ports(1)[0]
    p = subprocess.Popen([sys.executable, "-m", "kungfu_tpu_torch.elastic.configserver",
                          "-port", str(port), "-init", str(tmp_path / "c.json")],
                         env=port_env(), cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        assert p.stdout.readline().strip() == f"config server on :{port}"
        status, _, body = _request(port, "GET", "/config", None)
        assert status == 200 and json.loads(body) == {**INITIAL, "Version": 0}
        assert _request(port, "GET", "/stop", None)[0] == 200
        assert p.wait(10) == 0
    finally:
        if p.poll() is None:
            p.kill()


# ---------------------------------------------------------------------------
# ElasticState's leaf order and leaf types
# ---------------------------------------------------------------------------

Pair = collections.namedtuple("Pair", "first second")

TREES = {
    "flat": lambda t: {"b": t(2), "a": t(3), "c": t(1)},
    "nested": lambda t: {"params": {"w2": t(3), "w1": t(2)}, "opt": [t(1), (t(4), t(5))],
                         "step": 7},
    "none": lambda t: {"z": None, "a": [None, t(2)], "m": {}},
    "namedtuple": lambda t: Pair(first={"y": t(1), "x": t(2)}, second=[t(3)]),
    "ordered": lambda t: collections.OrderedDict([("z", t(1)), ("a", t(2))]),
    "scalars": lambda t: {"lr": 0.5, "n": 3, "flag": True, "v": t(6)},
    "list": lambda t: [t(1), {"k": t(2)}, (t(3),)],
}


def _val(i):
    return np.full((i, 2), float(i), np.float32)


@pytest.mark.parametrize("name", sorted(TREES))
def test_state_flattens_in_jaxs_leaf_order(name):
    """The port's flatten of a tree of tensors gives the leaves in the
    order jax.tree.flatten gives the same tree of arrays; unflatten
    rebuilds the same containers."""
    mine, unflatten = tree_flatten(TREES[name](lambda i: torch.from_numpy(_val(i))))
    theirs = jax.tree.leaves(TREES[name](_val))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = unflatten(mine)
    again, _ = tree_flatten(back)
    assert type(back) is type(TREES[name](_val))
    assert all(x is y for x, y in zip(again, mine))


def test_state_rejects_a_leaf_it_cannot_send():
    with pytest.raises(TypeError, match="str"):
        tree_flatten({"a": "text"})


@pytest.mark.parametrize("dtype", ["float32", "float64", "int64", "int32", "bfloat16", "bool",
                                   "uint8", "float16"])
def test_set_state_gives_each_leaf_the_old_leafs_type(dtype):
    """A received leaf takes the old leaf's dtype and shape: tensors stay
    tensors on their device, numpy and numbers come back as numpy, as
    the reference gives them."""
    tdt = getattr(torch, dtype)
    new = torch.arange(6).reshape(2, 3).to(tdt)
    old = torch.zeros(3, 2, dtype=tdt)
    got = _like(new.reshape(-1), old)
    assert isinstance(got, torch.Tensor) and got.dtype == tdt and got.shape == (3, 2)
    assert torch.equal(got.reshape(-1), new.reshape(-1))
    if dtype != "bfloat16":  # numpy has no bfloat16 without ml_dtypes, which the port never uses
        got = _like(new.reshape(-1), np.zeros((6,), dtype))
        assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype) and got.shape == (6,)
        assert np.array_equal(got, new.reshape(-1).numpy())
    num = _like(torch.tensor(3, dtype=torch.int64), 5)
    assert isinstance(num, np.ndarray) and num.dtype == np.int64 and num.shape == ()


# ---------------------------------------------------------------------------
# examples/elastic_train.py under the port's kfrun, grown 2 -> 3 -> 2
# ---------------------------------------------------------------------------

BATCH, SAMPLES, LR = 16, 512, 0.5
# rank 0 PUTs these clusters at these progresses (in samples): 5 steps at
# 2 workers, 4 at 3, 5 at 2 again
GROW_AT, SHRINK_AT = 4 * 2 * BATCH, 5 * 2 * BATCH + 3 * 3 * BATCH
SIZES = [2] * 5 + [3] * 4 + [2] * 5
LOSS_RTOL = 1e-4  # f32, the host all-reduce's summation order against jax's mean

WRAPPER = textwrap.dedent("""
    import json, os, sys, urllib.request
    from kungfu_tpu_torch.elastic import state as st
    from kungfu_tpu_torch.examples import elastic_train

    PLAN = {int(k): v for k, v in json.loads(os.environ["ET_PLAN"]).items()}
    end = st.ElasticState.end

    def put_then_end(self, delta=1):
        # rank 0 publishes the planned cluster before it polls for it
        if self.progress in PLAN and self._peer.rank == 0:
            body = json.dumps({"Runners": os.environ["KF_INIT_RUNNERS"].split(","),
                               "Workers": PLAN[self.progress]}).encode()
            req = urllib.request.Request(os.environ["KF_CONFIG_SERVER"], data=body, method="PUT")
            urllib.request.urlopen(req, timeout=5).read()
        end(self, delta)

    st.ElasticState.end = put_then_end
    out = elastic_train.main(sys.argv[1:])
    print("RESULT " + json.dumps({"spec": os.environ["KF_SELF_SPEC"], **out}), flush=True)
""")


def replay(records):
    """The one-process replay: the same initial MLP (the port's seeded
    init), the same global batch at each step, the gradients averaged
    over the ranks' batches as the host all-reduce does, optax.sgd; the
    loss of rank 0's batch at each step."""
    x, y = elastic_train.synthetic_mnist()
    ds = rdataset.ElasticDataset([x, y], BATCH, seed=1)
    params = {k: jnp.asarray(v.detach().numpy())
              for k, v in init_mlp(torch.Generator().manual_seed(0), device="cpu").tree().items()}
    opt = optax.sgd(LR)
    opt_state = opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(rmlp_loss))
    losses = []
    for progress, size in records:
        per_rank = [grad_fn(params, tuple(jnp.asarray(a) for a in ds.batch_at(progress, r, size)))
                    for r in range(size)]
        losses.append(float(per_rank[0][0]))
        grads = jax.tree.map(lambda *g: sum(g) / size, *[g for _, g in per_rank])
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return losses


def test_elastic_train_grows_and_shrinks_under_kfrun_watch_mode(tmp_path):
    (tmp_path / "et.py").write_text(WRAPPER)
    base, runner = free_range(8), free_ports(1)[0]
    specs = [f"127.0.0.1:{base + i}" for i in range(3)]
    env = port_env()
    env["ET_PLAN"] = json.dumps({GROW_AT: specs, SHRINK_AT: specs[:2]})
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "2", "-H", "127.0.0.1:4",
         "-w", "-builtin-config-port", "0", "-port-range", f"{base}-{base + 7}",
         "-runner-port", str(runner), "-monitor-port", "0", "-timeout", "150",
         "--", sys.executable, str(tmp_path / "et.py"), "--device", "cpu",
         "--samples", str(SAMPLES), "--batch", str(BATCH), "--lr", str(LR)],
        env=env, capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    results = {}
    for line in r.stdout.splitlines():
        if "RESULT " in line:
            res = json.loads(line.split("RESULT ", 1)[1])
            results[res["spec"]] = res
    assert sorted(results) == specs
    r0, r1, joiner = (results[s] for s in specs)
    assert r0["sizes"] == r1["sizes"] == SIZES
    assert r0["stop_reason"] == r1["stop_reason"] == "finished"
    assert r0["final_progress"] == r1["final_progress"] == SAMPLES
    assert joiner["stop_reason"] == "detached" and joiner["sizes"] == [3] * 4
    assert joiner["progress"] == r0["progress"][5:9]  # it adopted the survivors' progress
    # no sample skipped or trained twice: consecutive global batches
    steps = list(zip(r0["progress"], r0["sizes"]))
    assert [p for p, _ in steps] == [sum(BATCH * s for _, s in steps[:i]) for i in range(14)]
    want = replay(steps)
    np.testing.assert_allclose(r0["losses"], want, rtol=LOSS_RTOL, atol=1e-6)
    assert all(np.isfinite(r0["losses"]))
