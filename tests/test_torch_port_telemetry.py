"""The port's telemetry core (`kungfu_tpu_torch/telemetry/`) against the
JAX package's, in process:

- the metrics registry: the same seeded sequence of calls renders a
  byte-equal Prometheus exposition in both packages (label escaping,
  value formatting, histogram bounds, the per-family series cap), and
  both refuse the same misuse;
- tracing: Chrome traces of the same spans match once `ts`, `tid` and
  `pid` are masked; step scopes and open spans;
- audit: `to_json` records and `since` cursors of the same sequence;
- config: feature parsing and the metrics gate;
- the per-worker HTTP endpoint: routes, 404 and 500, queries, headers,
  and the reference's promparse scraping the port's server;
- telemetry off: a world that runs collectives registers no family, and
  no peer serves;
- every `kungfu_*` family the port can register is a row of
  docs/telemetry.md.

Both packages keep one registry, one trace ring and one audit log per
process: every case starts and ends with all of them cleared and the
feature cache refreshed (`clean_telemetry`)."""

import json
import math
import random
import re
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from kungfu_tpu.monitor import net as rnet
from kungfu_tpu.telemetry import audit as raudit
from kungfu_tpu.telemetry import config as rconfig
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu.telemetry import link as rlink
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu.telemetry import promparse as rpromparse
from kungfu_tpu.telemetry import tracing as rtracing
from kungfu_tpu_torch import telemetry
from kungfu_tpu_torch.monitor import net
from kungfu_tpu_torch.telemetry import audit, config, decisions, link, metrics, promparse, tracing
from kungfu_tpu_torch.telemetry.http import CLOCK_HEADER, WALL_HEADER, TelemetryServer

REPO = Path(__file__).resolve().parent.parent


def _reset_all():
    for cfg, reg, trc, aud, mon, lnk, dec in (
            (config, metrics, tracing, audit, net, link, decisions),
            (rconfig, rmetrics, rtracing, raudit, rnet, rlink, rdecisions)):
        cfg.refresh(None)
        reg.get_registry().clear()
        trc.clear()
        aud.clear()
        mon._global_monitor = None
        lnk._table = None  # its families live in the registry just cleared
        dec.reset_ledger()


@pytest.fixture(autouse=True)
def clean_telemetry(monkeypatch):
    """Both packages' process-wide telemetry state, empty before and
    after the case, with the feature caches re-read."""
    for name in ("KF_TELEMETRY", "KF_CONFIG_ENABLE_MONITORING", "KF_TELEMETRY_MAX_SERIES",
                 "KF_TELEMETRY_SPAN_SAMPLE"):
        monkeypatch.delenv(name, raising=False)
    _reset_all()
    yield
    monkeypatch.undo()
    _reset_all()


def both(fn):
    """fn(metrics module) for the port's and the reference's registry
    module; returns (port's, reference's)."""
    return fn(metrics), fn(rmetrics)


# ---------------------------------------------------------------------------
# the registry: byte-equal exposition
# ---------------------------------------------------------------------------

LABEL_VALUES = ['plain', '', 'a"quote', 'back\\slash', 'new\nline', 'all"\\\n3',
                '\\"', '}{=,', 'ünïcödé', '127.0.0.1:12345', ' spaces ', '\\n literal']


@pytest.mark.parametrize("value", LABEL_VALUES)
def test_label_values_render_byte_equal(value):
    def run(m):
        reg = m.Registry()
        reg.counter("t_total", "a \"help\" \\ line", ("peer", "kind")).labels(value, "x").inc(3)
        reg.gauge("t_gauge", "", ("peer",)).labels(peer=value).set(-2)
        reg.histogram("t_seconds", "h", ("peer",), buckets=(0.5, 1)).labels(value).observe(0.7)
        return reg.render()

    mine, theirs = both(run)
    assert mine == theirs
    assert metrics._escape_label(value) == rmetrics._escape_label(value)


VALUES = [0, 1, -1, 7.0, 2 ** 53, 1e15 - 1, 1e15, 1e16, 0.1, 1 / 3, -2.5e-7, 1e-300,
          123456789.125, math.inf, -math.inf, math.nan]


@pytest.mark.parametrize("value", VALUES, ids=[repr(v) for v in VALUES])
def test_values_format_byte_equal(value):
    def run(m):
        reg = m.Registry()
        reg.gauge("v_gauge", "value").set(value)
        reg.gauge("v_labelled", "value", ("k",)).labels("a").set(value)
        if value == value and value >= 0:
            reg.counter("v_total", "counter").inc(value)
        return reg.render()

    mine, theirs = both(run)
    assert mine == theirs
    assert metrics._fmt_value(value) == rmetrics._fmt_value(value)


BOUNDS = [(1.0,), (0.001, 0.01, 0.1), (5, 1, 3), (-1.0, 0.0, 1.0), (1e-9, 1e9),
          tuple(rmetrics.DEFAULT_BUCKETS)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bounds", BOUNDS, ids=[f"b{i}" for i in range(len(BOUNDS))])
def test_histograms_with_custom_bounds_render_byte_equal(bounds, seed):
    obs = random.Random(seed)
    values = [obs.choice([-2.0, 0.0, 0.001, 0.5, 1.0, 3.0, 1e10, obs.uniform(-1, 2)])
              for _ in range(40)]

    def run(m):
        reg = m.Registry()
        h = reg.histogram("h_seconds", "hist", ("op",), buckets=bounds)
        plain = reg.histogram("h_plain_seconds", "plain", buckets=bounds)
        for i, v in enumerate(values):
            h.labels(("a", "b")[i % 2]).observe(v)
            plain.observe(v)
        qs = [plain.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 1.0)]
        return reg.render(), qs, plain.count, plain.sum

    (mine, *rest), (theirs, *rrest) = both(run)
    assert mine == theirs
    assert repr(rest) == repr(rrest)


@pytest.mark.parametrize("cap", ["0", "1", "3", "10", "bad"])
def test_the_series_cap_drops_alike(cap, monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY_MAX_SERIES", cap)

    def run(m):
        reg = m.Registry()
        c = reg.counter("capped_total", "capped", ("peer",))
        g = reg.gauge("capped_gauge", "capped", ("peer",))
        for i in range(12):
            c.labels(f"p{i % 7}").inc(i)
            g.labels(f"p{i}").set(i)
        reg.counter("free_total", "no labels").inc()
        return reg.render()

    mine, theirs = both(run)
    assert mine == theirs
    if cap in ("1", "3"):
        assert "kungfu_telemetry_dropped_series_total" in mine


def _drive(m, seed: int) -> str:
    """A seeded random sequence of registry calls: counters, gauges and
    histograms over a small name pool (so families are re-fetched), label
    values from LABEL_VALUES, removals and child clears."""
    rng = random.Random(seed)
    reg = m.Registry()
    pool = [("kungfu_a_total", "counter", ("peer",)), ("kungfu_b_total", "counter", ()),
            ("kungfu_c", "gauge", ("level", "role")), ("kungfu_d", "gauge", ()),
            ("kungfu_e_seconds", "histogram", ("collective",)),
            ("kungfu_f_seconds", "histogram", ())]
    for _ in range(120):
        name, kind, labels = rng.choice(pool)
        vals = [rng.choice(LABEL_VALUES[:8]) for _ in labels]
        x = rng.choice([0, 1, 2.5, 1 / 7, 1e6, 3e-5])
        if kind == "counter":
            fam = reg.counter(name, f"help of {name}", labels)
            (fam.labels(*vals) if labels else fam).inc(x)
        elif kind == "gauge":
            fam = reg.gauge(name, f"help of {name}", labels)
            child = fam.labels(*vals) if labels else fam
            op = rng.choice(["set", "inc", "dec"])
            getattr(child, op)(x)
            if labels and rng.random() < 0.05:
                fam.clear_children()
            elif labels and rng.random() < 0.05:
                fam.remove(*vals)
        else:
            fam = reg.histogram(name, f"help of {name}", labels)
            (fam.labels(*vals) if labels else fam).observe(x)
    return reg.render()


@pytest.mark.parametrize("seed", range(20))
def test_seeded_call_sequences_render_byte_equal(seed):
    mine, theirs = both(lambda m: _drive(m, seed))
    assert mine == theirs


def test_extra_renderers_and_include_extras_alike():
    def run(m):
        reg = m.Registry()
        reg.counter("x_total").inc()
        fn = lambda: "# TYPE extra gauge\nextra 1\n"  # noqa: E731
        reg.add_renderer(fn)
        reg.add_renderer(fn)  # idempotent
        reg.add_renderer(lambda: 1 / 0)  # a failing renderer is skipped
        return reg.render(), reg.render(include_extras=False), sorted(reg.collect())

    assert both(run)[0] == both(run)[1]


BAD_NAMES = ["", "__reserved", "9starts_with_digit", "has-dash", "has space", "dot.ted",
             "has/slash"]


@pytest.mark.parametrize("name", BAD_NAMES)
def test_bad_names_are_refused_alike(name):
    for m in (metrics, rmetrics):
        with pytest.raises(ValueError):
            m.Registry().counter(name)


@pytest.mark.parametrize("misuse", ["retype", "relabel", "rebucket", "negative", "no_labels",
                                    "wrong_arity", "mixed_labels", "missing_label",
                                    "quantile_range", "empty_buckets"])
def test_misuse_is_refused_alike(misuse):
    def run(m):
        reg = m.Registry()
        c = reg.counter("m_total", "", ("peer",))
        h = reg.histogram("m_seconds", "", buckets=(1, 2))
        acts = {
            "retype": lambda: reg.gauge("m_total", "", ("peer",)),
            "relabel": lambda: reg.counter("m_total", "", ("dst",)),
            "rebucket": lambda: reg.histogram("m_seconds", "", buckets=(1, 3)),
            "negative": lambda: c.labels("a").inc(-1),
            "no_labels": lambda: c.inc(),
            "wrong_arity": lambda: c.labels("a", "b"),
            "mixed_labels": lambda: c.labels("a", peer="b"),
            "missing_label": lambda: c.labels(dst="b"),
            "quantile_range": lambda: h.quantile(1.5),
            "empty_buckets": lambda: reg.histogram("n_seconds", "", buckets=()),
        }
        with pytest.raises(ValueError) as e:
            acts[misuse]()
        return str(e.value)

    mine, theirs = both(run)
    assert mine == theirs


def test_process_health_samples_the_same_gauges():
    mine = metrics.update_process_health(metrics.Registry())
    theirs = rmetrics.update_process_health(rmetrics.Registry())
    assert sorted(mine) == sorted(theirs)
    assert mine["threads"] >= 1 and mine["rss_bytes"] > 0


def test_concurrent_increments_are_not_lost():
    c = metrics.Registry().counter("t_total", "", ("w",))

    def run(i):
        child = c.labels(str(i % 2))
        for _ in range(2000):
            child.inc()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sum(v for _, _, v in c.samples()) == 16000


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _mask(doc: dict) -> dict:
    """A Chrome trace without its clock, thread and process identities."""
    evs = [{k: v for k, v in e.items() if k not in ("ts", "tid", "pid", "dur")}
           for e in doc["traceEvents"]]
    return {"traceEvents": evs, "displayTimeUnit": doc["displayTimeUnit"],
            "metadata": sorted(doc["metadata"])}


def _spans(t, seed: int) -> None:
    """A seeded tree of spans, records and instants, some inside step
    scopes, on the calling thread."""
    rng = random.Random(seed)

    def level(depth: int) -> None:
        for i in range(rng.randint(1, 3)):
            kind = rng.choice(["span", "record", "instant", "scope"])
            if kind == "span" and depth < 3:
                with t.span(f"s{depth}.{i}", bytes=rng.randint(0, 9)) as sp:
                    level(depth + 1)
                    if rng.random() < 0.5:
                        sp.args["late"] = depth
            elif kind == "record":
                t.record(f"r{depth}.{i}", rng.random() * 1e-3, n=i)
            elif kind == "instant":
                t.instant(f"i{depth}.{i}", what="x")
            elif kind == "scope" and depth < 3:
                with t.step_scope(rng.randint(0, 3), rng.randint(0, 99)):
                    level(depth + 1)
            else:
                t.record(f"plain{depth}", 0.0)

    level(0)


@pytest.mark.parametrize("seed", range(8))
def test_chrome_traces_of_the_same_spans_match(seed):
    _spans(tracing, seed)
    _spans(rtracing, seed)
    mine, theirs = tracing.chrome_trace(), rtracing.chrome_trace()
    assert _mask(mine) == _mask(theirs)
    assert _mask(json.loads(tracing.chrome_trace_json())) == _mask(mine)
    assert sorted(tracing.summary_ms()) == sorted(rtracing.summary_ms())
    assert [n for n, _, _ in tracing.events("s")] == [n for n, _, _ in rtracing.events("s")]


def test_span_nesting_depth_and_open_spans():
    seen = {}
    with tracing.span("outer"):
        with tracing.span("inner"):
            seen.update(tracing.open_spans())
    (stack,) = seen.values()
    assert stack == ["outer", "inner"]
    depths = {e.name: e.depth for e in tracing.full_events()}
    assert depths == {"inner": 1, "outer": 0}
    assert tracing.open_spans() == {}


def test_step_scope_stamps_and_restores():
    assert tracing.current_step() is None
    with tracing.step_scope(2, 7):
        with tracing.step_scope(2, 8):
            tracing.record("x", 0.0)
            assert tracing.current_step() == (2, 8)
        assert tracing.current_step() == (2, 7)
        with tracing.span("y", step="mine"):
            pass
    assert tracing.current_step() is None
    args = {e.name: e.args for e in tracing.full_events()}
    assert args == {"x": {"step": [2, 8]}, "y": {"step": "mine"}}


def test_the_ring_holds_kf_trace_buffer_events(tmp_path):
    import subprocess
    import sys

    code = ("from kungfu_tpu_torch.telemetry import tracing as t\n"
            "[t.record('x', 0.0) for _ in range(50)]\n"
            "print(t.MAX_EVENTS, len(t.full_events()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={"KF_TRACE_BUFFER": "16",
                                                      "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["16", "16"], out.stderr
    assert tracing.MAX_EVENTS == rtracing.MAX_EVENTS == 8192
    path = tracing.export_chrome(str(tmp_path / "t.json"))
    assert json.loads(Path(path).read_text())["traceEvents"] == []


def test_utils_trace_is_the_telemetry_ring():
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch.utils import trace

    assert trace.span is tracing.span and trace.record is tracing.record
    trace.record("worker.x", 0.002)
    assert api.trace_summary("worker.") == {"worker.x": 2.0}
    assert [e["name"] for e in tracing.chrome_trace()["traceEvents"]] == ["worker.x"]


# ---------------------------------------------------------------------------
# audit
# ---------------------------------------------------------------------------

def _audit_sequence(a, seed: int) -> list:
    """A seeded sequence of audit calls; returns the `since` cursors
    taken between them."""
    rng = random.Random(seed)
    cursors = []
    for i in range(rng.randint(3, 8)):
        kind = rng.choice(["resize", "event", "annotate", "cursor"])
        if kind == "resize":
            old = [f"127.0.0.1:{10000 + j}" for j in range(rng.randint(1, 4))]
            new = [f"127.0.0.1:{10000 + j}" for j in range(rng.randint(1, 4))]
            phases = rng.choice([None, {"wait_config_ms": 12.5, "consensus_ms": 1.0,
                                        "update_ms": 3.25}, {"consensus_ms": 0.1}])
            a.record_resize(peer=rng.choice(["", old[0]]), cluster_version=i,
                            trigger=rng.choice(["", "explicit", "config_server"]),
                            old_peers=old, new_peers=new, phases_ms=phases,
                            progress=rng.choice([None, 5]), detached=rng.random() < 0.3)
        elif kind == "event":
            a.record_event(rng.choice(["strategy_switch", "config_put", "run_abort"]),
                           peer="p", trigger="t", n=i, skipped=None)
        elif kind == "annotate":
            a.annotate_last(progress=i, checkpoint_version=rng.choice([None, 3]), extra=i)
        else:
            cursors.append(a.next_since())
    return cursors


def _masked_records(recs):
    return [{k: v for k, v in r.items() if k != "wall_time"} for r in recs]


@pytest.mark.parametrize("seed", range(8))
def test_audit_records_and_cursors_match(seed):
    mine, theirs = _audit_sequence(audit, seed), _audit_sequence(raudit, seed)
    assert mine == theirs
    assert _masked_records(audit.to_json()) == _masked_records(raudit.to_json())
    for since in mine + [0, 10 ** 6]:
        assert (_masked_records(audit.to_json(since=since))
                == _masked_records(raudit.to_json(since=since)))
    assert (_masked_records(json.loads(l) for l in audit.to_jsonl().splitlines())
            == _masked_records(json.loads(l) for l in raudit.to_jsonl().splitlines()))
    # the metric hooks register the same families
    assert metrics.render() == rmetrics.render()
    assert [e.name for e in tracing.full_events()] == [e.name for e in rtracing.full_events()]


def test_resize_duration_excludes_the_config_wait():
    rec = audit.record_resize(phases_ms={"wait_config_ms": 900.0, "consensus_ms": 2.0,
                                         "notify_ms": 1.5, "update_ms": 6.5}, trigger="x")
    assert rec.duration_ms == 10.0 and "old_size" not in rec.to_json()
    assert audit.records(kind="resize") == [rec] and audit.records(kind="other") == []


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

FEATURES = ["", "0", "off", "none", "1", "yes", "all", "*", "metrics", "trace,audit",
            " Metrics , TRACE ", "metrics,typo", "typo", "metrics,all"]


@pytest.mark.parametrize("raw", FEATURES)
def test_features_parse_as_the_reference(raw, monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY", raw)
    config.refresh(None)
    rconfig.refresh(None)
    assert config.features() == rconfig.features()
    assert config.metrics_enabled() == rconfig.metrics_enabled()
    assert config.trace_enabled() == rconfig.trace_enabled()


@pytest.mark.parametrize("raw", ["1", "true", "YES", "on", "enabled", "0", "no", "", "maybe"])
def test_the_monitoring_knob_gates_metrics_as_the_reference(raw, monkeypatch):
    monkeypatch.setenv("KF_CONFIG_ENABLE_MONITORING", raw)
    assert config.metrics_enabled() == rconfig.metrics_enabled() == config.truthy(raw)
    assert config.env_truthy("KF_CONFIG_ENABLE_MONITORING") == config.truthy(raw)


@pytest.mark.parametrize("raw", ["", "1.0", "0.25", "0", "-3", "7", "x"])
def test_span_sample_reads_as_the_reference(raw, monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY_SPAN_SAMPLE", raw)
    assert config.span_sample() == rconfig.span_sample()


def test_enable_and_refresh():
    assert config.features() == frozenset()
    config.enable("metrics", "bogus")
    assert config.features() == {"metrics"} and config.metrics_enabled()
    config.enable("trace")
    assert config.features() == {"metrics", "trace"}
    config.refresh(None)
    assert not config.metrics_enabled()
    with pytest.raises(KeyError, match="not a declared knob"):
        config.env_truthy("KF_NOT_A_KNOB")


def test_dump_has_the_references_shape():
    tracing.record("x", 0.001)
    audit.record_event("e")
    rtracing.record("x", 0.001)
    raudit.record_event("e")
    mine, theirs = telemetry.dump(), __import__("kungfu_tpu.telemetry").telemetry.dump()
    assert sorted(mine) == sorted(theirs)
    assert mine["spans"] == theirs["spans"] and mine["features"] == theirs["features"]
    assert [e["name"] for e in mine["trace"]["traceEvents"]] == ["x", "audit.e"]


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------

def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


@pytest.fixture
def server():
    metrics.counter("kungfu_t_total", "t").inc(2)
    tracing.record("srv.span", 0.001)
    audit.record_event("first")
    srv = TelemetryServer(0, host="127.0.0.1", extra_routes={
        "/boom": lambda: 1 / 0, "/echo": lambda q: (json.dumps(q), "application/json")})
    srv.start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("path,status", [
    ("/metrics", 200), ("/", 200), ("/metrics/", 200), ("/metrics?t=123", 200),
    ("/trace", 200), ("/trace?x=/audit", 200), ("/audit", 200), ("/audit?since=999999999", 200),
    ("/audit?since=bad", 200), ("/steptrace", 200), ("/steptrace?since=999999999", 200),
    ("/decisions", 200), ("/decisions?since=999999999", 200),
    ("/resources", 200), ("/memory", 200), ("/host/telemetry", 200), ("/nope", 404),
    ("/boom", 500)])
def test_server_routes(server, path, status):
    got, body, headers = _get(server.port, path)
    assert got == status
    if status != 200:
        return
    assert float(headers[CLOCK_HEADER]) > 0 and float(headers[WALL_HEADER]) > 0
    route = path.split("?")[0].rstrip("/") or "/metrics"
    if route == "/metrics":
        assert "kungfu_t_total 2\n" in body and "kungfu_process_rss_bytes" in body
        assert headers["Content-Type"].startswith("text/plain")
    elif route == "/trace":
        assert "srv.span" in [e["name"] for e in json.loads(body)["traceEvents"]]
    elif route == "/decisions":
        doc = json.loads(body)
        assert {"peer", "perf_now_us", "next_since", "decisions"} <= set(doc)
        assert doc["decisions"] == [] or not path.endswith("since=999999999")
    elif route == "/steptrace":
        doc = json.loads(body)
        assert {"peer", "perf_now_us", "next_since", "keep", "stats", "timelines"} <= set(doc)
        assert doc["timelines"] == []
    elif route == "/host/telemetry":
        assert json.loads(body) == {"enabled": False}
    elif route in ("/resources", "/memory"):
        doc = json.loads(body)
        assert {"peer", "perf_now_us", "wall_time_s", "supported", "buckets"} <= set(doc)
    else:
        recs = json.loads(body)
        assert [r["kind"] for r in recs] == ([] if path.endswith("since=999999999") else ["first"])


def test_a_failing_view_is_a_500_with_its_error(server):
    status, body, _ = _get(server.port, "/boom")
    assert status == 500 and "division by zero" in body
    status, body, _ = _get(server.port, "/echo?a=1&b=x")
    assert status == 200 and json.loads(body) == {"a": "1", "b": "x"}


def test_the_references_promparse_scrapes_the_ports_server(server):
    metrics.histogram("kungfu_h_seconds", "h", ("peer",)).labels('a"b').observe(0.3)
    _, body, _ = _get(server.port, "/metrics")
    theirs, mine = rpromparse.parse_text(body), promparse.parse_text(body)
    assert [tuple(s) for s in theirs] == [tuple(s) for s in mine]
    assert rpromparse.sample_value(theirs, "kungfu_h_seconds_count", peer='a"b') == 1
    assert rpromparse.sample_value(theirs, "kungfu_t_total") == 2


def test_stop_releases_the_port():
    import socket

    srv = TelemetryServer(0, host="127.0.0.1")
    srv.start()
    port = srv.port
    srv.stop()
    srv.stop()  # idempotent
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", port))
    s.close()
    TelemetryServer(0, host="127.0.0.1").stop()  # never started: no hang


def test_serve_starts_a_standalone_endpoint():
    srv = telemetry.serve(0, host="127.0.0.1")
    try:
        assert _get(srv.port, "/metrics")[0] == 200
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# telemetry off, and the documented families
# ---------------------------------------------------------------------------

def test_telemetry_off_registers_no_family_and_serves_nothing():
    from test_torch_port_engine import allreduce_all, make_world, run_all, sessions

    import numpy as np

    world = make_world(["port"] * 3)
    try:
        for strategy in ("RING_SEGMENTED", "BINARY_TREE_STAR"):
            xs = [np.full(70_001, r, np.float32) for r in range(3)]
            outs = allreduce_all(sessions(world, strategy), xs, "SUM", f"off:{strategy}")
            assert all(float(o[0]) == 3.0 for o in outs)
        run_all([lambda p=p: p.current_session().barrier(":off") for p in world])
        assert all(p.metrics_server is None for p in world)
        assert all(p.client._monitor is None and p.client._send_hist is None for p in world)
    finally:
        for p in world:
            p.stop()
    fams = [m for m in metrics.get_registry().collect() if m.startswith("kungfu_")]
    assert fams == []
    assert metrics.render() == "\n"


@pytest.mark.parametrize("features,sample,walks", [("trace", "1.0", 4), ("trace", "0.5", 2),
                                                   ("trace", "0", 0), ("metrics", "1.0", 0)])
def test_ring_steps_are_spans_under_trace(features, sample, walks, monkeypatch):
    """KF_TELEMETRY=trace: each segmented walk's ring steps are spans
    with their wait and send split, on 1 in 1/rate walks; without the
    trace feature, none."""
    import numpy as np

    from test_torch_port_engine import allreduce_all, make_world, sessions

    monkeypatch.setenv("KF_TELEMETRY", features)
    monkeypatch.setenv("KF_TELEMETRY_SPAN_SAMPLE", sample)
    config.refresh(None)
    world = make_world(["port"] * 2)
    try:
        sess = sessions(world, "RING_SEGMENTED")
        for i in range(4):
            allreduce_all(sess, [np.ones(70_001, np.float32)] * 2, "SUM", f"steps{i}")
    finally:
        for p in world:
            p.stop()
    for name in ("host.rs.step", "host.ag.step"):
        steps = [e for e in tracing.full_events() if e.name == name]
        assert len(steps) == 2 * walks, name  # k = 2: one step a phase, on each peer
        assert all(set(e.args) == {"step", "k", "wait_us", "send_us"} for e in steps)


def _port_families():
    """Every `kungfu_*` family name the port's sources can register."""
    names = set()
    for path in (REPO / "kungfu_tpu_torch").rglob("*.py"):
        names.update(re.findall(r'"(kungfu_[a-z0-9_]+)"', path.read_text()))
    # the net monitor's rate gauges are rendered from an f-string
    names.update({"kungfu_egress_rate", "kungfu_ingress_rate"})
    # a name ending in "_" is a prefix the code matches (the flight
    # recorder reads the kungfu_process_* gauges), not a family
    return sorted(n for n in names if not n.startswith(("kungfu_tpu", "kungfu_telemetry_dir"))
                  and not n.endswith("_"))


@pytest.mark.parametrize("family", _port_families())
def test_every_family_is_documented(family):
    doc = (REPO / "docs" / "telemetry.md").read_text()
    rows = [l for l in doc.splitlines() if l.startswith("|")]
    assert any(f"`{family}`" in row for row in rows), family


def test_the_family_list_is_whole():
    fams = _port_families()
    for want in ("kungfu_collective_wire_bytes_total", "kungfu_scheduler_queued_buckets",
                 "kungfu_sharded_update_state_bytes", "kungfu_pair_avg_steps_total",
                 "kungfu_peer_rtt_seconds", "kungfu_shm_alloc_failures_total",
                 "kungfu_telemetry_dropped_series_total", "kungfu_process_rss_bytes"):
        assert want in fams
    assert len(fams) >= 35
