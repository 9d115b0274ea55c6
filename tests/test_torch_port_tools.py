"""The port's tooling twins on the CPU against the JAX package's:
`kungfu_tpu_torch/models/fake.py` and `kungfu_tpu_torch/info/`; mirrors
tests/test_models.py's fake-model case, tests/test_info.py and
tests/test_info_postmortem.py.

- fake: every model's sizes and byte totals are the reference's, and
  `fake_gradients` gives the reference's bits for several seeds and
  dtypes.
- info renders: `render_top`, `render_links`, `render_steps`,
  `render_resources`, `render_memory` and the decisions view give the
  reference's text byte for byte, on documents of the port's aggregator
  (a world of 4 in-process TelemetryServers, one slow edge) and of the
  planes' merges, and on hand-made edge cases: stragglers of each cause,
  an unreachable peer, an overloaded plane, a two-level plan with a
  demoted rank, a split wire, a pending re-plan, empty planes, missing
  fields.
- info's CLI: each command with and without `--json`, once and under
  `--watch`, by URL and by `KF_CLUSTER_HEALTH_URL`, against a local HTTP
  server: the same output and exit code as the reference's; the flag and
  fetch errors are the reference's; `postmortem` over the committed
  fixture journal, harvested run dirs of four scenarios, a single peer
  dir, an empty dir, the environment's dir and a URL gives the
  reference's text."""

import contextlib
import http.server
import io
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from kungfu_tpu.info import __main__ as rinfo
from kungfu_tpu.models import fake as rfake
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu.telemetry import memory as rmemory
from kungfu_tpu.telemetry import resource as rresource
from kungfu_tpu_torch.info import __main__ as info
from kungfu_tpu_torch.models import fake
from kungfu_tpu_torch.telemetry import audit, cluster, config, decisions, memory, resource
from kungfu_tpu_torch.telemetry import steptrace
from test_torch_port_cluster import K, SharedFetch, Worker
from test_torch_port_flight import _run_dir
from test_torch_port_memory import _mem_docs
from test_torch_port_resource import _docs as _res_docs

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "flightrec"


# ---------------------------------------------------------------------------
# models/fake.py
# ---------------------------------------------------------------------------

def test_the_model_names_are_the_references():
    assert list(fake.FAKE_MODELS) == list(rfake.FAKE_MODELS)


@pytest.mark.parametrize("name", list(rfake.FAKE_MODELS))
def test_each_models_sizes_are_the_references(name):
    assert fake.FAKE_MODELS[name] == rfake.FAKE_MODELS[name]
    assert all(isinstance(s, int) and s > 0 for s in fake.FAKE_MODELS[name])


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64, np.int32])
@pytest.mark.parametrize("name", list(rfake.FAKE_MODELS))
def test_total_size_bytes_is_the_references(name, dtype):
    assert fake.total_size_bytes(name, dtype) == rfake.total_size_bytes(name, dtype)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.float64])
@pytest.mark.parametrize("name", ["tiny", "slp-mnist", "mlp-4mib"])
def test_fake_gradients_are_the_references_bits(name, dtype, seed):
    mine = fake.fake_gradients(name, dtype=dtype, seed=seed)
    theirs = rfake.fake_gradients(name, dtype=dtype, seed=seed)
    assert [g.shape for g in mine] == [(s,) for s in fake.FAKE_MODELS[name]]
    assert all(a.dtype == b.dtype == np.dtype(dtype) and a.tobytes() == b.tobytes()
               for a, b in zip(mine, theirs))


def test_resnet50s_fake_gradients_are_the_references_bits():
    mine, theirs = fake.fake_gradients("resnet50-imagenet"), rfake.fake_gradients(
        "resnet50-imagenet")
    assert sum(g.size for g in mine) == 23_435_432  # the convolutions and the head, no norms
    assert all(a.tobytes() == b.tobytes() for a, b in zip(mine, theirs))


# ---------------------------------------------------------------------------
# info's renderers on documents of the port's aggregator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def agg_docs():
    """The six views of the port's aggregator over a world of 4 in-process
    TelemetryServers of the port (rank 3 slow, the edge 1 -> 2 slow) after
    each of 5 sweeps."""
    for mod in (config,):
        mod.refresh(None)
    audit.clear()
    decisions.reset_ledger()
    steptrace.reset_store()
    rng = np.random.default_rng(2024)
    world = [Worker(r, rng) for r in range(K)]
    fetch = SharedFetch()
    agg = cluster.TelemetryAggregator(interval=5.0, timeout=5.0, fetch=fetch)
    agg.set_peers([(w.label, w.url) for w in world])
    labels = [w.label for w in world]
    sweeps = []
    try:
        for _ in range(5):
            for w in world:
                w.step(labels)
            fetch.new_sweep()
            agg.scrape_once()
            sweeps.append({"top": agg.cluster_health(), "links": agg.cluster_links(),
                           "steps": agg.cluster_steps(), "decisions": agg.cluster_decisions(),
                           "resources": agg.cluster_resources(),
                           "memory": agg.cluster_memory()})
    finally:
        agg.stop()
        for w in world:
            w.srv.stop()
        audit.clear()
    return labels, json.loads(json.dumps(sweeps))


def _both(view, doc, **kw):
    """The view rendered by each package."""
    if view == "decisions":
        return (decisions.render_decisions(doc, **kw),
                rdecisions.render_decisions(doc, **kw))
    return (getattr(info, f"render_{view}")(doc, **kw),
            getattr(rinfo, f"render_{view}")(doc, **kw))


@pytest.mark.parametrize("sweep", [0, 2, 4])
@pytest.mark.parametrize("view", ["top", "links", "steps", "decisions"])
def test_each_view_of_the_aggregator_renders_as_the_reference(view, sweep, agg_docs):
    labels, sweeps = agg_docs
    mine, theirs = _both(view, sweeps[sweep][view])
    assert mine == theirs
    if view in ("top", "links"):
        assert all(label in mine for label in labels)


def test_the_aggregators_top_and_links_name_the_slow_edge(agg_docs):
    labels, sweeps = agg_docs
    top = info.render_top(sweeps[-1]["top"])
    assert f"last step critical: {labels[1]} →{labels[2]}" in top
    assert "STRAGGLER" in top
    links = info.render_links(sweeps[-1]["links"])
    peers = sweeps[-1]["links"]["peers"]  # the matrix numbers the peers in this order
    assert f"slowest edge [{peers.index(labels[1])}]→[{peers.index(labels[2])}]" in links


@pytest.mark.parametrize("limit", [1, 3, 8, 100])
def test_render_steps_limits_as_the_reference(limit, agg_docs):
    doc = agg_docs[1][-1]["steps"]
    mine, theirs = _both("steps", doc, limit=limit)
    assert mine == theirs
    shown = min(limit, len(doc["steps"]))
    assert mine.startswith(f"{len(doc['steps'])} merged steps on record, showing {shown}")


@pytest.mark.parametrize("seed", range(8))
def test_render_resources_of_merged_planes_is_the_references(seed):
    docs, offsets = _res_docs(seed)
    merged = rresource.merge_resources(docs, offsets)
    assert resource.merge_resources(docs, offsets) == merged
    mine, theirs = _both("resources", merged)
    assert mine == theirs


@pytest.mark.parametrize("seed", range(8))
def test_render_memory_of_merged_planes_is_the_references(seed):
    docs, offsets = _mem_docs(seed)
    merged = rmemory.merge_memory(docs, offsets)
    assert memory.merge_memory(docs, offsets) == merged
    mine, theirs = _both("memory", merged)
    assert mine == theirs


# ---------------------------------------------------------------------------
# info's renderers on hand-made edge cases
# ---------------------------------------------------------------------------

P = ["10.0.0.1:12000", "10.0.0.1:12001", "10.0.0.2:12000", "10.0.0.2:12001"]


def _peer(**kw):
    row = {"step_rate": 2.5, "step_time_p50_ms": 380.0, "step_time_p99_ms": 410.5,
           "bytes_tx": 3 << 30, "bytes_rx": 1500, "rtt_ms": 0.21, "last_scrape_age_s": 1.2,
           "straggler": False, "rtt_outlier": False, "error": None}
    row.update(kw)
    return row


def _links(bw=None, ring=None, **kw):
    bw = bw or {(0, 1): 8e8, (1, 2): 2e7, (2, 3): 7e8, (3, 0): 9e8, (0, 2): 5e8}
    edges = {}
    for (a, b), v in bw.items():
        edges.setdefault(P[a], {})[P[b]] = {"bw": v, "lat": 0.001}
    doc = {"peers": list(P), "edges": edges, "min_bw": 2e7, "slowest_edge": [P[1], P[2], 2e7]}
    if ring is not None:
        doc["ring"] = ring
    doc.update(kw)
    return doc


def _role(level, role, group):
    return {"level": level, "role": role, "group": group}


TOP_CASES = {
    "empty": {},
    "one_peer_missing_fields": {"peers": {P[0]: {}}},
    "stragglers_by_cause": {
        "peers": {P[0]: _peer(straggler=True, straggler_cause="network"),
                  P[1]: _peer(straggler=True, straggler_cause="compute"),
                  P[2]: _peer(straggler=True, straggler_cause="unknown"),
                  P[3]: _peer(straggler=True, straggler_cause="memory", rtt_outlier=True)},
        "stragglers": [P[0], P[1], P[2], P[3]], "step_skew": 1.87},
    "unreachable": {"peers": {P[0]: _peer(), P[1]: _peer(error="timed out", step_rate=None)}},
    "steps_and_planes": {
        "peers": {p: _peer() for p in P},
        "steps": {"crit_frac": {P[1]: 0.75, P[2]: 0.25}, "crit_edge": {P[1]: P[2]},
                  "critical_peer": P[1], "critical_edge": P[2], "overlap_frac": 0.42},
        "resources": {"peers": {P[0]: {"cpu_frac": 0.93, "train_frac": 0.6},
                                P[1]: {"cpu_frac": None}}, "saturated": [P[0]]},
        "memory": {"peers": {P[2]: {"used_frac": 0.91, "headroom_frac": 0.05}},
                   "pressure": [P[2]], "leak_suspects": {P[2]: ["pool", "untracked"]}}},
    "plane_overloaded": {"peers": {P[0]: _peer()}, "plane": {
        "mode": "hier", "sweep_seconds": 7.5, "effective_interval_s": 5.0,
        "scraped_peers": 64, "stale_peers": 3, "oldest_link_row_age_s": 42.0}},
    "plane_stale_list": {"peers": {P[0]: _peer()}, "plane": {
        "mode": "flat", "sweep_seconds": 0.2, "interval_s": 2.0, "stale_peers": [P[1], P[3]]}},
    "plane_stale_bool": {"peers": {P[0]: _peer()}, "plane": {"mode": "sampled",
                                                             "stale_peers": True}},
    "critical_without_edge": {"peers": {P[0]: _peer()},
                              "steps": {"critical_peer": P[0], "overlap_frac": None}},
}

LINKS_CASES = {
    "no_peers": {"peers": []},
    "rank_order_ring": _links(ring={"order": list(P)}),
    "replanned_ring": _links(ring={"order": [P[0], P[2], P[1], P[3]]}),
    "rotated_ring": _links(ring={"order": [P[2], P[3], P[0], P[1]]}),
    "one_wire": _links(ring={"order": list(P), "wire": {p: "int8" for p in P}}),
    "split_wire": _links(ring={"order": list(P), "wire": {P[0]: "bf16", P[1]: "int8",
                                                          P[2]: "bf16", P[3]: "bf16"}}),
    "two_level": _links(ring={"order": list(P), "role": {
        P[0]: _role("intra", "head", 0), P[1]: _role("intra", "member", 0),
        P[2]: _role("intra", "head", 1), P[3]: _role("intra", "member", 1)}}),
    "two_level_demoted": _links(ring={"order": list(P), "role": {
        P[0]: _role("intra", "member", 0), P[1]: _role("intra", "head", 0),
        P[2]: _role("intra", "head", 1), P[3]: _role("intra", "demoted", 1)}}),
    "flat_roles": _links(ring={"order": list(P), "role": {p: _role("flat", "member", 0)
                                                          for p in P}}),
    "no_estimates": _links(bw={(0, 1): 0.0}, min_bw=None, slowest_edge=None),
    "missing_ring": _links(),
    "bad_matrix": _links(bw={(0, 1): float("nan"), (1, 0): -3.0}),
}

STEPS_CASES = {
    "none": {},
    "empty": {"steps": []},
}


@pytest.mark.parametrize("case", sorted(TOP_CASES))
def test_render_top_edge_cases_are_the_references(case):
    mine, theirs = _both("top", TOP_CASES[case])
    assert mine == theirs


@pytest.mark.parametrize("case", sorted(LINKS_CASES))
def test_render_links_edge_cases_are_the_references(case):
    mine, theirs = _both("links", LINKS_CASES[case])
    assert mine == theirs


def test_a_demoted_rank_is_marked_in_the_hierarchy_line():
    text = info.render_links(LINKS_CASES["two_level_demoted"])
    assert "hierarchy:      {[0],[1]|h[1]}→{[2],[3]▽|h[2]} (▽ demoted)" in text


@pytest.mark.parametrize("case", sorted(STEPS_CASES))
def test_render_steps_without_steps_is_the_references(case):
    mine, theirs = _both("steps", STEPS_CASES[case])
    assert mine == theirs and mine.startswith("no merged steps yet")


@pytest.mark.parametrize("view", ["resources", "memory"])
@pytest.mark.parametrize("doc", [{}, {"peers": {}}, {"peers": None}])
def test_empty_planes_render_as_the_reference(view, doc):
    mine, theirs = _both(view, doc)
    assert mine == theirs and mine.startswith(f"no {view[:-1] if view == 'resources' else view}")


@pytest.mark.parametrize("doc", [{}, {"decisions": []}])
def test_empty_decisions_render_as_the_reference(doc):
    mine, theirs = _both("decisions", doc)
    assert mine == theirs


# ---------------------------------------------------------------------------
# info's CLI
# ---------------------------------------------------------------------------

class _Server:
    """A local HTTP server answering GETs from a dict path -> document."""

    def __init__(self, docs):
        self.docs = docs
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                doc = outer.docs.get(self.path.partition("?")[0])
                body = json.dumps(doc).encode() if doc is not None else b"not found"
                self.send_response(200 if doc is not None else 404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


CMDS = ["top", "links", "steps", "decisions", "resources", "memory"]


@pytest.fixture(scope="module")
def server(agg_docs):
    docs = agg_docs[1][-1]
    res, _ = _res_docs(3)
    mem, _ = _mem_docs(5)
    routes = {f"/cluster/{'health' if v == 'top' else v}": docs[v] for v in CMDS}
    routes["/cluster/resources"] = resource.merge_resources(res, {})
    routes["/cluster/memory"] = memory.merge_memory(mem, {})
    routes["/cluster/postmortem"] = {"deaths": 1, "peers": {P[3]: [_fixture_pm()]}}
    srv = _Server(routes)
    yield srv
    srv.stop()


def _fixture_pm():
    from kungfu_tpu_torch.telemetry import flight

    pm = flight.harvest_run_dir(str(FIXTURE))[0]
    return json.loads(json.dumps(pm))


def _cli(mod, argv, monkeypatch=None):
    """(exit code, stdout, stderr) of one package's `main(argv)`."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            mod.main(list(argv))
            rc = 0
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def _cli_both(argv):
    return _cli(info, argv), _cli(rinfo, argv)


@pytest.mark.parametrize("json_flag", [False, True])
@pytest.mark.parametrize("cmd", CMDS)
def test_each_command_prints_the_references_frame(cmd, json_flag, server, monkeypatch):
    monkeypatch.delenv("KF_CLUSTER_HEALTH_URL", raising=False)
    argv = [cmd] + (["--json"] if json_flag else []) + [server.url]
    mine, theirs = _cli_both(argv)
    assert mine == theirs
    assert mine[0] == 0 and mine[1].strip()
    if json_flag:
        route = "/cluster/health" if cmd == "top" else f"/cluster/{cmd}"
        assert json.loads(mine[1]) == server.docs[route]


@pytest.mark.parametrize("cmd", CMDS)
def test_each_command_finds_the_url_in_the_environment(cmd, server, monkeypatch):
    monkeypatch.setenv("KF_CLUSTER_HEALTH_URL", server.url + "/cluster/health")
    mine, theirs = _cli_both([cmd, "-n", "2"] if cmd in ("steps", "decisions") else [cmd])
    assert mine == theirs and mine[0] == 0


@pytest.mark.parametrize("cmd", CMDS)
def test_watch_refreshes_in_place_as_the_reference(cmd, server, monkeypatch):
    """One frame of `--watch`, the interval's sleep interrupted."""
    naps = []
    sleep, me = time.sleep, threading.current_thread()

    def nap(s):
        if threading.current_thread() is not me:  # another thread's sleep
            return sleep(s)
        naps.append(s)
        raise KeyboardInterrupt

    monkeypatch.setattr(time, "sleep", nap)
    mine, theirs = _cli_both([cmd, "--watch", "--interval", "0.25", server.url])
    assert mine == theirs and mine[0] == 0
    assert mine[1].startswith("\x1b[H\x1b[2J") and naps == [0.25, 0.25]


ERRORS = [(cmd, "bad_interval") for cmd in CMDS] + [(cmd, "no_url") for cmd in CMDS] + [
    (cmd, "bad_count") for cmd in ("steps", "decisions")] + [
    (cmd, "dead_url") for cmd in CMDS]


@pytest.mark.parametrize("cmd,error", ERRORS)
def test_flag_and_fetch_errors_are_the_references(cmd, error, monkeypatch):
    from test_torch_port_worlds import free_ports

    monkeypatch.delenv("KF_CLUSTER_HEALTH_URL", raising=False)
    argv = {"bad_interval": [cmd, "--interval", "soon"], "no_url": [cmd],
            "bad_count": [cmd, "-n", "many"],
            "dead_url": [cmd, f"http://127.0.0.1:{free_ports(1)[0]}"]}[error]
    mine, theirs = _cli_both(argv)
    assert mine == theirs
    assert mine[0] == (1 if error == "dead_url" else 2) and mine[2] and not mine[1]


# ---------------------------------------------------------------------------
# info postmortem
# ---------------------------------------------------------------------------

@pytest.fixture
def frozen_clock(monkeypatch):
    """One wall clock for both packages' harvests: a postmortem prints the
    harvest's time and the journal's age at it."""
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now)


def test_postmortem_over_the_fixture_journal_is_the_references(monkeypatch, frozen_clock):
    monkeypatch.delenv("KF_TELEMETRY_DIR", raising=False)
    mine, theirs = _cli_both(["postmortem", str(FIXTURE)])
    assert mine == theirs and mine[0] == 0
    out = mine[1]
    assert "1 worker death(s) on record" in out
    assert "== postmortem: 127.0.0.1:38002 ==" in out and "last step: 1234" in out
    assert "truncated frame header" in out and "no exit record" in out


@pytest.mark.parametrize("scenario", ["killed", "clean", "respawned", "empty"])
def test_postmortem_over_a_harvested_run_dir_is_the_references(scenario, tmp_path,
                                                               monkeypatch, frozen_clock):
    monkeypatch.delenv("KF_TELEMETRY_DIR", raising=False)
    run, peer = _run_dir(tmp_path, scenario, np.random.default_rng(11))
    mine, theirs = _cli_both(["postmortem", run])
    assert mine == theirs and mine[0] == 0
    if scenario != "empty":
        assert peer in mine[1]


@pytest.mark.parametrize("how", ["peer_dir", "env", "empty_dir", "no_target", "not_a_dir",
                                 "url", "dead_url"])
def test_postmortem_targets_are_the_references(how, server, tmp_path, monkeypatch,
                                               frozen_clock):
    from test_torch_port_worlds import free_ports

    monkeypatch.delenv("KF_TELEMETRY_DIR", raising=False)
    argv = ["postmortem"]
    if how == "peer_dir":
        argv.append(str(FIXTURE / "127.0.0.1_38002"))
    elif how == "env":
        monkeypatch.setenv("KF_TELEMETRY_DIR", str(FIXTURE))
    elif how == "empty_dir":
        argv.append(str(tmp_path))
    elif how == "not_a_dir":
        argv.append(str(tmp_path / "missing"))
    elif how == "url":
        argv.append(server.url)
    elif how == "dead_url":
        argv.append(f"http://127.0.0.1:{free_ports(1)[0]}")
    mine, theirs = _cli_both(argv)
    assert mine == theirs
    want_rc = {"no_target": 2, "not_a_dir": 2, "dead_url": 1}.get(how, 0)
    assert mine[0] == want_rc


def test_the_report_names_torch_and_the_cluster_env(monkeypatch):
    monkeypatch.setenv("KF_SELF_SPEC", "127.0.0.1:7")
    rc, out, _ = _cli(info, ["--no-devices"])
    assert rc == 0
    assert "kungfu_tpu_torch: 0.1.0" in out and "torch: " in out and "CUDA: " in out
    assert "KF_SELF_SPEC=127.0.0.1:7" in out and "cpus: " in out
    assert "JAX" not in out


def test_the_report_names_the_cards_torch_sees():
    rc, out, _ = _cli(info, [])
    assert rc == 0
    import torch

    if torch.cuda.is_available():
        assert f"x {torch.cuda.get_device_name(0)} (cuda, sm_" in out
    else:
        assert "devices: none (torch.cuda sees no card)" in out


def test_the_telemetry_report_dumps_this_process(monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    config.refresh(None)
    try:
        rc, out, _ = _cli(info, ["--no-devices", "--telemetry"])
    finally:
        monkeypatch.delenv("KF_TELEMETRY")
        config.refresh(None)
    assert rc == 0
    assert "telemetry: metrics (KF_TELEMETRY='metrics')" in out
    assert "local trace buffer:" in out


# ---------------------------------------------------------------------------
# the small gaps: the frontend's numpy bridge, the MST's native flag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_with_no_grad_copy_is_the_references(dtype):
    import ml_dtypes
    import torch

    from kungfu_tpu.torch import with_no_grad_copy as rcopy
    from kungfu_tpu_torch.torch import with_no_grad_copy

    rng = np.random.default_rng(3)
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    arr = rng.standard_normal((3, 5)).astype(np_dtype)
    mine, theirs = (torch.nn.Parameter(torch.zeros(3, 5, dtype=getattr(torch, dtype)))
                    for _ in range(2))
    with_no_grad_copy(mine, arr)
    rcopy(theirs, arr)
    assert torch.equal(mine, theirs) and mine.requires_grad
    with_no_grad_copy(mine, torch.ones(15, dtype=mine.dtype))  # a tensor of its elements
    assert torch.equal(mine, torch.ones_like(mine))


def test_the_mst_runs_in_the_ports_host_cpp():
    from kungfu_tpu.plan import mst as rmst
    from kungfu_tpu_torch.plan import mst

    assert mst.uses_native() is True
    w = np.random.default_rng(5).random((6, 6))
    w = w + w.T
    assert mst.minimum_spanning_tree(w) == rmst.minimum_spanning_tree(w)
