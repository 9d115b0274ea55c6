"""The port's decision ledger (`kungfu_tpu_torch/telemetry/decisions.py`)
against the JAX package's (`kungfu_tpu/telemetry/decisions.py`); mirrors
tests/test_decisions.py.

- Seeded step streams with decisions opened among them, fed to one
  ledger of each package: the same records (timestamps aside), verdicts,
  realized gains, watchdog events, audit trail, metrics, signals and
  `export(since=)` deltas.
- `merge_decisions` and the renderers on seeded documents; a disabled
  ledger (`KF_DECISION_KEEP=0`) allocates nothing.
- `/decisions` served by the port's telemetry server with its `since=`
  cursor; decision sites of the engine: a ZeRO mode flip at a session
  epoch, a precision vote.
In process."""

import json
import random
import urllib.request

import pytest

from kungfu_tpu.telemetry import audit as raudit
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu_torch.telemetry import audit, config, decisions, metrics
from kungfu_tpu_torch.telemetry.http import TelemetryServer
from test_torch_port_telemetry import clean_telemetry  # noqa: F401
from test_torch_port_worlds import make_world, new_epoch, run_all, small_arenas  # noqa: F401
from test_torch_port_zero import close_all, sessions

TIME_KEYS = ("wall_time", "t_us", "closed_wall_time", "t_closed_us")
KINDS = ["topology_replanned", "strategy_switch", "peer_demoted", "zero_mode"]


def _untimed(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in TIME_KEYS}


def _events(seed):
    """A seeded run: step durations that drift, jump and recover, with
    decisions opened among them."""
    rng = random.Random(seed)
    base = rng.choice([0.1, 0.5, 1.0])
    out = []
    for i in range(rng.randint(30, 90)):
        if rng.random() < 0.08:
            out.append(("open", rng.choice(KINDS), rng.choice([None, 1.0, 1.7, 3.25])))
        if rng.random() < 0.1:
            base *= rng.choice([0.3, 0.5, 0.95, 1.0, 1.05, 1.8, 3.0])
        out.append(("step", rng.choice([0.0, -1.0]) if rng.random() < 0.03
                    else base * (1 + rng.uniform(-0.04, 0.04))))
    return out


def _feed(ledger, events):
    for ev in events:
        if ev[0] == "open":
            ledger.open(ev[1], peer="p:1", epoch=3, trigger="t", predicted_gain=ev[2],
                        signals={"votes": 2}, old="a", new="b")
        else:
            ledger.note_step(ev[1])


@pytest.mark.parametrize("window,settle,patience,ratio", [
    (8, 2, 2, 0.9), (3, 1, 1, 0.9), (2, 0, 3, 0.95), (5, 3, 2, 0.5)])
@pytest.mark.parametrize("seed", range(8))
def test_seeded_runs_give_the_same_ledgers(seed, window, settle, patience, ratio, monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    config.refresh(None)
    from kungfu_tpu.telemetry import config as rconfig

    rconfig.refresh(None)
    kw = dict(keep=16, window=window, settle=settle, regress_ratio=ratio, patience=patience)
    mine, theirs = decisions.DecisionLedger(**kw), rdecisions.DecisionLedger(**kw)
    events = _events(seed)
    cursor = None
    for i in range(0, len(events), 11):
        _feed(mine, events[i:i + 11])
        _feed(theirs, events[i:i + 11])
        assert ([_untimed(r.to_json()) for r in mine.records()]
                == [_untimed(r.to_json()) for r in theirs.records()])
        assert mine.signals() == theirs.signals()
        a, b = mine.export(peer="p:1", since=cursor), theirs.export(peer="p:1", since=cursor)
        assert [_untimed(r) for r in a["decisions"]] == [_untimed(r) for r in b["decisions"]]
        assert ({k: v for k, v in a.items() if k not in ("decisions", "perf_now_us",
                                                         "wall_time_s")}
                == {k: v for k, v in b.items() if k not in ("decisions", "perf_now_us",
                                                           "wall_time_s")})
        cursor = a["next_since"]
    # the audit trail: decision_outcome and adaptation_regressed, alike
    assert ([(r["kind"], r["peer"], r["trigger"], r.get("detail")) for r in audit.to_json()]
            == [(r["kind"], r["peer"], r["trigger"], r.get("detail"))
                for r in raudit.to_json()])
    mine_text = [ln for ln in metrics.render().splitlines() if "kungfu_decision" in ln]
    theirs_text = [ln for ln in rmetrics.render().splitlines() if "kungfu_decision" in ln]
    assert mine_text == theirs_text


def test_a_clear_speedup_is_delivered_and_a_slowdown_regressed():
    led = decisions.DecisionLedger(keep=8, window=3, settle=1, regress_ratio=0.9, patience=1)
    for _ in range(3):
        led.note_step(1.0)
    up = led.open("topology_replanned", predicted_gain=2.0)
    for _ in range(4):
        led.note_step(0.5)
    down = led.open("peer_demoted")
    for _ in range(4):
        led.note_step(2.0)
    assert up.verdict == "delivered" and up.realized_gain == pytest.approx(2.0)
    assert down.verdict == "regressed" and down.regressed
    assert led.signals()["decision/regressed"] == ["peer_demoted"]
    assert [r["kind"] for r in audit.to_json()] == ["decision_outcome", "decision_outcome",
                                                    "adaptation_regressed"]


def test_a_decision_without_a_baseline_stays_open():
    led = decisions.DecisionLedger(keep=4, window=3, settle=0)
    rec = led.open("resize")
    for _ in range(10):
        led.note_step(0.2)
    assert rec.status == "open" and rec.baseline is None


def test_a_disabled_ledger_opens_nothing(monkeypatch):
    monkeypatch.setenv("KF_DECISION_KEEP", "0")
    decisions.reset_ledger()
    rdecisions.reset_ledger()
    assert decisions.open_decision("resize") is None
    assert rdecisions.open_decision("resize") is None
    decisions.note_step(1.0)
    assert decisions.get_ledger().records() == []
    decisions.reset_ledger()


@pytest.mark.parametrize("seed", range(6))
def test_merge_and_render_are_the_references(seed):
    rng = random.Random(seed)
    docs, offsets = {}, {}
    for p in range(rng.randint(1, 4)):
        peer = f"10.0.0.{p}:1"
        offsets[peer] = rng.choice([None, 0.0, 1500.0, -2e6])
        recs = []
        for i in range(rng.randint(0, 5)):
            rec = {"seq": i, "kind": rng.choice(KINDS), "epoch": rng.randint(0, 3),
                   "trigger": rng.choice(["", "replan_vote"]), "wall_time": 1.7e9 + rng.random(),
                   "t_us": rng.random() * 1e9, "status": rng.choice(["open", "closed"]),
                   "predicted_gain": rng.choice([None, 1.5])}
            if rec["status"] == "closed":
                rec.update(verdict=rng.choice(["delivered", "neutral", "regressed"]),
                           realized_gain=rng.choice([0.5, 1.0, 2.25]), t_closed_us=1e9,
                           detail={"new_order": "0,2,1,3"}, regressed=rng.random() < 0.3)
            elif rng.random() < 0.5:
                rec["baseline"] = {"mean_ms": 3.0, "rel_sd": 0.01, "n": 3}
            if rng.random() < 0.5:
                rec["peer"] = peer
            recs.append(rec)
        docs[peer] = {"decisions": recs}
    merged = decisions.merge_decisions(docs, offsets)
    assert merged == rdecisions.merge_decisions(docs, offsets)
    for rec in merged:
        assert decisions.render_record(rec) == rdecisions.render_record(rec)
    for limit in (1, 16):
        doc = {"decisions": merged}
        assert decisions.render_decisions(doc, limit) == rdecisions.render_decisions(doc, limit)


def test_decisions_are_served_with_a_cursor():
    led = decisions.get_ledger()
    for _ in range(3):
        led.note_step(0.3)
    led.open("topology_replanned", peer="x:1", predicted_gain=1.5)
    srv = TelemetryServer(0, host="127.0.0.1")
    srv.start()
    try:
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=10) as r:
                return json.loads(r.read().decode())

        doc = get("/decisions")
        assert [r["kind"] for r in doc["decisions"]] == ["topology_replanned"]
        assert doc["window"] == led.window and doc["next_since"] == 1
        assert get(f"/decisions?since={doc['next_since']}")["decisions"] == []
        for _ in range(led.settle + led.window):
            led.note_step(0.1)
        later = get(f"/decisions?since={doc['next_since']}")["decisions"]
        assert [r["status"] for r in later] == ["closed"]  # the close re-ships it
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the engine's decision sites
# ---------------------------------------------------------------------------

def test_a_zero_mode_flip_at_an_epoch_opens_a_record(monkeypatch):
    world = make_world(["port", "port"])
    try:
        monkeypatch.setenv("KF_CONFIG_ZERO", "on")
        new_epoch(world)
        recs = [r for r in decisions.get_ledger().records() if r.kind == "zero_mode"]
        assert len(recs) == 2
        assert {(r.trigger, r.detail["old"], r.detail["new"]) for r in recs} == {
            ("session_epoch", "off", "on")}
        monkeypatch.delenv("KF_CONFIG_ZERO")
        new_epoch(world)
        assert sum(r.kind == "zero_mode" for r in decisions.get_ledger().records()) == 4
        assert not any(r.kind == "async_mode" for r in decisions.get_ledger().records())
    finally:
        for p in world:
            p.stop()


def test_a_precision_vote_opens_a_record():
    world = make_world(["port", "port"])
    ss = sessions(world)
    try:
        out = {}
        run_all([lambda r=r, s=s: out.__setitem__(r, s.check_precision(
            "bf16", signals={"noise_scale": 9.0})) for r, s in enumerate(ss)])
        assert out == {0: "bf16", 1: "bf16"}
        recs = [r for r in decisions.get_ledger().records() if r.kind == "precision_switch"]
        assert len(recs) == 2
        assert recs[0].signals == {"noise_scale": 9.0, "votes": 2, "size": 2}
        assert (recs[0].detail["old"], recs[0].detail["new"]) == ("off", "bf16")
        assert all(s.active_wire_mode() == "bf16" for s in ss)
    finally:
        close_all(ss)
        for p in world:
            p.stop()
