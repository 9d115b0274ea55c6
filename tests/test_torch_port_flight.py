"""The port's flight recorder and postmortems
(`kungfu_tpu_torch/telemetry/flight.py`) against the JAX package's
(`kungfu_tpu/telemetry/flight.py`); mirrors tests/test_flight.py.

- Seeded record streams give byte-equal journals (the `KFJ1` magic,
  `<II` length + crc32 frames, compact JSON).
- Each package reads the other's journal, clean, torn at the tail (a
  truncated header or payload, a flipped CRC, a bad magic) and rotated
  to `journal.prev.bin` at `KF_FLIGHT_MAX_BYTES`.
- `harvest_postmortem` on the same seeded run dir gives equal dicts apart
  from the harvest's wall time; `render_postmortem`, `describe_exit`,
  `prune_runs`, `harvest_peer_dir`, `harvest_run_dir`, `flight_enabled`
  and the postmortem log agree.
- A port child process's recorder: killed by SIGKILL it leaves a journal
  both packages read; SIGTERM flushes an exit record and the child still
  dies by the signal; SIGUSR2 writes a `dump`.
- A snapshot carries the decision ledger's tail and the step ring, with
  the reference's keys, ``resources`` and ``memory`` among them: the
  resource and memory planes' documents."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

from kungfu_tpu.telemetry import config as rconfig
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu.telemetry import flight as rflight
from kungfu_tpu.telemetry import memory as rmemory
from kungfu_tpu.telemetry import resource as rresource
from kungfu_tpu.telemetry import steptrace as rsteptrace
from kungfu_tpu_torch.telemetry import config, decisions, flight, steptrace

REPO = Path(__file__).resolve().parent.parent
BOTH = (flight, rflight)


def _records(rng, n=None, big=False):
    """A seeded stream of journal records: a meta, then snapshots with
    nested metrics text, spans, unicode and floats."""
    n = int(rng.integers(3, 12)) if n is None else n
    out = [{"kind": "meta", "wall_time": 1.7e9, "peer": "10.0.0.1:12000", "pid": 4242,
            "host": "h", "argv": ["w.py", "--x"], "python": "3.12.0", "interval_s": 0.5}]
    for i in range(n):
        out.append({
            "kind": "snapshot", "wall_time": 1.7e9 + i * 0.5 + float(rng.uniform(0, 0.1)),
            "perf_now": float(rng.uniform(0, 1e4)), "peer": "10.0.0.1:12000",
            "step": float(i), "metrics": f"kungfu_steps_total {i}\nkungfu_process_rss_bytes "
                                         f"{int(rng.integers(1, 1 << 30))}\n",
            "spans": [["sched.walk", float(rng.uniform(0, 9)), float(rng.uniform(0, 9))]],
            "open_spans": {"MainThread": ["step", "ünïcödé"]},
            "audit": [], "log_tail": ["x" * (4000 if big else 10)], "steps": [],
            "decisions": [], "resources": None, "memory": None})
    return out


def _write(mod, path, records, max_bytes=None):
    w = mod.JournalWriter(str(path), max_bytes=max_bytes)
    for rec in records:
        w.append(rec)
    w.close()


@pytest.mark.parametrize("seed", range(4))
def test_journal_bytes_equal_the_references(seed, tmp_path):
    recs = _records(np.random.default_rng(seed))
    for mod, name in ((flight, "mine.bin"), (rflight, "theirs.bin")):
        _write(mod, tmp_path / name, recs)
    mine, theirs = (tmp_path / "mine.bin").read_bytes(), (tmp_path / "theirs.bin").read_bytes()
    assert mine == theirs and mine.startswith(b"KFJ1")
    for mod in BOTH:
        assert mod.read_journal_file(str(tmp_path / "mine.bin")) == (recs, None)


def _damage(path, how):
    data = path.read_bytes()
    if how == "payload":
        data = data[:-7]
    elif how == "header":
        # the last frame's header cut after 3 of its 8 bytes
        last = data.rfind(b'{"kind"')
        data = data[:last - 8 + 3]
    elif how == "crc":
        last = data.rfind(b'{"kind"')
        data = data[:last + 2] + bytes([data[last + 2] ^ 0x55]) + data[last + 3:]
    elif how == "magic":
        data = b"KFJ0" + data[4:]
    path.write_bytes(data)


@pytest.mark.parametrize("how", ["clean", "payload", "header", "crc", "magic"])
@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_reads_the_others_journal(writer, how, tmp_path):
    recs = _records(np.random.default_rng(7))
    wmod = flight if writer == "port" else rflight
    d = tmp_path / "peer"
    d.mkdir()
    _write(wmod, d / "journal.bin", recs)
    if how != "clean":
        _damage(d / "journal.bin", how)
    got = [m.read_journal(str(d)) for m in BOTH]
    assert got[0] == got[1]
    records, errors = got[0]
    if how == "clean":
        assert records == recs and errors == []
    elif how == "magic":
        assert records == [] and "bad journal magic" in errors[0]
    else:
        assert records == recs[:-1] and len(errors) == 1


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_rotated_journal_reads_across_the_boundary(writer, tmp_path):
    recs = _records(np.random.default_rng(11), n=30, big=True)
    wmod = flight if writer == "port" else rflight
    d = tmp_path / "peer"
    d.mkdir()
    _write(wmod, d / "journal.bin", recs, max_bytes=40_000)
    assert (d / "journal.prev.bin").exists()
    got = [m.read_journal(str(d)) for m in BOTH]
    assert got[0] == got[1]
    records, errors = got[0]
    assert errors == [] and records == recs[-len(records):] and len(records) < len(recs)


# ---------------------------------------------------------------------------
# harvesting and rendering
# ---------------------------------------------------------------------------

def _timeline(rnd, flushed=True):
    store = rsteptrace.StepStore(keep=4)
    rec = store.begin_step(2, rnd)
    lane = rec.bucket(0, "ar", "w+3", 4096, 4)
    lane.note_submit(1e6)
    lane.note_launch(1e6 + 10)
    lane.note_walk_span(1e6 + 20, 500.0)
    lane.add_walk("RING_SEGMENTED", 5e-4, 1e-4, 2e-4, "10.0.0.2:12001")
    if flushed:
        rec.finish(0.0002, 0.0006)
    return rec.to_json()


def _run_dir(tmp_path, scenario, rng):
    """A run dir whose dead peer left what `scenario` says."""
    run = tmp_path / "run"
    peer = "10.0.0.1:12000"
    d = run / flight.sanitize_label(peer)
    d.mkdir(parents=True)
    recs = _records(rng)
    if scenario == "respawned":
        recs = recs + [dict(recs[-1], kind="exit", reason="sigterm")] + _records(rng)
    ledger = rdecisions.DecisionLedger(keep=8)
    ledger.open("async_mode", peer=peer, trigger="session_epoch", old="off", new="on")
    recs[-1]["steps"] = [_timeline(3), _timeline(4, flushed=scenario != "killed")]
    recs[-1]["decisions"] = ledger.tail(8)
    recs[-1]["audit"] = [{"kind": "straggler", "wall_time": 1.7e9, "peer": peer,
                          "detail": {"z": 3.1}}]
    recs[-1]["open_spans"] = {"kf-sched-walk": ["sched.walk", "host.segmented"]}
    if scenario == "clean":
        recs.append(dict(recs[-1], kind="exit", reason="peer_stop"))
    if scenario != "empty":
        _write(rflight, d / "journal.bin", recs)
        (d / "faulthandler.log").write_text('Fatal Python error: Segmentation fault\n'
                                            'Thread 0x1 (most recent call first):\n  File "w.py"')
    return str(run), peer


def _pm_equal(a, b):
    skip = ("wall_time", "last_record_age_s")
    return {k: v for k, v in a.items() if k not in skip} == \
        {k: v for k, v in b.items() if k not in skip}


SCENARIOS = ["killed", "clean", "respawned", "empty"]


@pytest.mark.parametrize("code", [-9, -15, 3, None])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_harvest_and_render_equal_the_references(scenario, code, tmp_path):
    run, peer = _run_dir(tmp_path, scenario, np.random.default_rng(SCENARIOS.index(scenario)))
    tail = [f"[ ] line {i}" for i in range(60)]
    mine, theirs = (m.harvest_postmortem(run, peer, exit_code=code, output_tail=tail)
                    for m in BOTH)
    assert _pm_equal(mine, theirs)
    assert mine["death"] == flight.describe_exit(code)
    # a respawned peer's older incarnation's exit record does not count
    assert mine["clean_exit"] is (scenario == "clean")
    assert mine["oom_suspected"] is False and mine["last_memory"] is None
    assert len(mine["output_tail"]) == 40
    if scenario == "killed":
        assert mine["last_step_timeline"]["t_end_us"] is None
        assert mine["last_decisions"][0]["kind"] == "async_mode"
    # the same dict renders to the same text in both packages
    mine["wall_time"] = theirs["wall_time"]
    mine["last_record_age_s"] = theirs["last_record_age_s"]
    text = flight.render_postmortem(mine)
    assert text == rflight.render_postmortem(theirs)
    assert f"== postmortem: {peer} ==" in text and mine["death"] in text
    # the durable log: appended by one package, read by both
    for m in BOTH:
        assert m.append_postmortem(run, mine)
    assert flight.read_postmortems(run) == rflight.read_postmortems(run)
    assert len(flight.read_postmortems(run)) == 2


def test_harvest_without_a_run_dir_or_from_a_copied_dir(tmp_path):
    run, peer = _run_dir(tmp_path, "killed", np.random.default_rng(5))
    for kw in ({}, {"journal_dir": os.path.join(run, flight.sanitize_label(peer))}):
        mine, theirs = (m.harvest_postmortem("", peer, exit_code=-9, **kw) for m in BOTH)
        assert _pm_equal(mine, theirs)
    moved = tmp_path / "copied"
    os.rename(os.path.join(run, flight.sanitize_label(peer)), moved)
    mine, theirs = (m.harvest_peer_dir(str(moved)) for m in BOTH)
    assert _pm_equal(mine, theirs) and mine["peer"] == peer
    assert flight.harvest_peer_dir(str(tmp_path)) is rflight.harvest_peer_dir(str(tmp_path))


@pytest.mark.parametrize("with_jsonl", [False, True])
def test_harvest_run_dir_equals_the_references(with_jsonl, tmp_path):
    run, peer = _run_dir(tmp_path, "killed", np.random.default_rng(9))
    other = Path(run) / "10.0.0.2_12001"
    other.mkdir()
    _write(rflight, other / "journal.bin", _records(np.random.default_rng(1)) + [
        {"kind": "exit", "wall_time": 1.8e9, "reason": "atexit"}])
    if with_jsonl:
        rflight.append_postmortem(run, rflight.harvest_postmortem(run, "10.0.0.9:1", -9))
    mine, theirs = (m.harvest_run_dir(run) for m in BOTH)
    # no jsonl: every journaled peer; with one, the uncovered peer that
    # died (the other exited cleanly)
    assert len(mine) == len(theirs) == 2
    for a, b in zip(mine, theirs):
        assert _pm_equal(a, b)


@pytest.mark.parametrize("code", [None, 0, 7, -9, -15, -11, -200])
def test_describe_exit_matches(code):
    assert flight.describe_exit(code) == rflight.describe_exit(code)


@pytest.mark.parametrize("keep", [0, 2, 5])
def test_prune_runs_drops_the_same_oldest_dirs(keep, tmp_path):
    left = []
    for mod in BOTH:
        base = tmp_path / mod.__name__
        for i in range(4):
            (base / f"run{i}").mkdir(parents=True)
            os.utime(base / f"run{i}", (1e9 + i, 1e9 + i))
        (base / "a-file").write_text("x")
        assert mod.prune_runs(str(base), keep=keep) == max(0, 4 - keep)
        left.append(sorted(os.listdir(base)))
    assert left[0] == left[1]
    assert flight.prune_runs(str(tmp_path / "missing")) == 0


def test_labels_and_default_run_dirs_match():
    for label in ("10.0.0.1:38000", "a/b c", "", "ünï:1"):
        assert flight.sanitize_label(label) == rflight.sanitize_label(label)
        assert flight.peer_dir("/r", label) == rflight.peer_dir("/r", label)
    d = flight.default_run_dir()
    assert os.path.dirname(d) == flight.DEFAULT_BASE
    assert os.path.basename(d).endswith(f"-{os.getpid()}")


@pytest.mark.parametrize("env", [
    {}, {"KF_FLIGHT": "1"}, {"KF_FLIGHT": "0", "KF_TELEMETRY_DIR": "/x"},
    {"KF_TELEMETRY_DIR": "/x"}, {"KF_TELEMETRY": "metrics"}, {"KF_FLIGHT": " ",
                                                              "KF_TELEMETRY": "audit"},
    {"KF_FLIGHT": "off", "KF_TELEMETRY": "all"}, {"KF_FLIGHT": "yes"}])
def test_flight_enabled_matches(env, monkeypatch):
    for name in ("KF_FLIGHT", "KF_TELEMETRY_DIR", "KF_TELEMETRY", "KF_CONFIG_ENABLE_MONITORING"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config.refresh(None)
    rconfig.refresh(None)
    try:
        assert flight.flight_enabled() == rflight.flight_enabled()
    finally:
        monkeypatch.undo()
        config.refresh(None)
        rconfig.refresh(None)


# ---------------------------------------------------------------------------
# the recorder in process and in a child process
# ---------------------------------------------------------------------------

def test_a_snapshot_carries_the_ledger_tail_and_the_step_ring(tmp_path, monkeypatch):
    monkeypatch.setenv("KF_FLIGHT_INTERVAL", "60")
    decisions.reset_ledger()
    steptrace.reset_store()
    try:
        for i in range(10):
            decisions.open_decision("topology_replanned", peer="me", trigger="t", seq=i)
        rec = steptrace.get_store().begin_step(1, 1)
        rec.bucket(0, "ar", "g", 8, 1).note_launch(1.0)
        rec.finish(0.0, 0.001)
        recs = {}
        for mod, name in ((flight, "mine"), (rflight, "theirs")):
            fr = mod.FlightRecorder(str(tmp_path / name), peer="me", enable_faulthandler=False,
                                    install_signal_handlers=False)
            fr.dump(reason="test")
            fr.close(reason="done")
            got, errors = mod.read_journal(str(tmp_path / name))
            assert errors == []
            recs[name] = got
        mine = recs["mine"]
        assert [r["kind"] for r in mine] == ["meta", "dump", "exit"]
        assert set(mine[1]) == set(recs["theirs"][1])
        assert mine[1]["reason"] == "test" and mine[2]["reason"] == "done"
        # the resource and memory planes' documents, with the reference's keys
        for key, rmod in (("resources", rresource), ("memory", rmemory)):
            doc = mine[1][key]
            assert doc is not None and set(doc) == set(recs["theirs"][1][key]), key
            assert set(doc) == set(rmod.get_plane().export()), key
        assert mine[1]["memory"]["rss_bytes"] > 0 and mine[1]["resources"]["supported"]
        assert len(mine[1]["decisions"]) == flight.DECISION_TAIL == 8
        assert [d["detail"]["seq"] for d in mine[1]["decisions"]] == list(range(2, 10))
        assert mine[1]["steps"] == steptrace.get_store().timelines()
        assert json.loads((tmp_path / "mine" / "meta.json").read_text())["peer"] == "me"
        pm = rflight.harvest_postmortem("", "me", exit_code=0,
                                        journal_dir=str(tmp_path / "mine"))
        assert pm["clean_exit"] and pm["last_step_timeline"]["round"] == 1
    finally:
        decisions.reset_ledger()
        steptrace.reset_store()


CHILD = textwrap.dedent("""\
    import os, sys, time
    from kungfu_tpu_torch.telemetry import flight, steptrace
    rec = steptrace.get_store().begin_step(0, 7)
    rec.bucket(0, "ar", "grad", 64, 1).note_launch(1.0)
    fr = flight.start_recorder(peer="child:1", directory=sys.argv[1])
    assert fr is not None and flight.get_recorder() is fr
    print("READY", flush=True)
    for _ in range(600):
        time.sleep(0.1)
    """)


def _child(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("KF_")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["KF_FLIGHT_INTERVAL"] = "0.1"
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    d = tmp_path / "journal"
    p = subprocess.Popen([sys.executable, str(script), str(d)], env=env, cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = p.stdout.readline()
    assert line.strip() == "READY", line + p.stderr.read()
    return p, d


def _wait_for(d, kind, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        recs, _ = flight.read_journal(str(d))
        if any(r.get("kind") == kind for r in recs):
            return recs
        time.sleep(0.05)
    raise AssertionError(f"no {kind} record in {d}")


def test_a_sigkilled_child_leaves_a_journal_both_packages_read(tmp_path):
    p, d = _child(tmp_path)
    _wait_for(d, "snapshot")
    p.kill()
    assert p.wait(30) == -signal.SIGKILL
    mine, theirs = flight.read_journal(str(d)), rflight.read_journal(str(d))
    assert mine == theirs
    kinds = [r["kind"] for r in mine[0]]
    assert kinds[:2] == ["meta", "start"] and "exit" not in kinds
    pm = rflight.harvest_postmortem(str(tmp_path), "journal", exit_code=-9)
    assert pm["death"] == "signal SIGKILL (-9)" and not pm["clean_exit"]
    assert pm["last_step_timeline"]["round"] == 7
    assert "(UNFLUSHED" in flight.render_postmortem(pm)


def test_sigterm_flushes_and_the_child_still_dies_by_it(tmp_path):
    p, d = _child(tmp_path)
    _wait_for(d, "start")
    p.send_signal(signal.SIGTERM)
    assert p.wait(30) == -signal.SIGTERM  # never swallowed
    recs, errors = rflight.read_journal(str(d))
    assert errors == [] and recs[-1]["kind"] == "exit" and recs[-1]["reason"] == "sigterm"
    assert flight.read_journal(str(d)) == (recs, errors)
    assert flight.harvest_postmortem(str(tmp_path), "journal", exit_code=-15)["clean_exit"]


def test_sigusr2_writes_a_dump_and_the_child_lives_on(tmp_path):
    p, d = _child(tmp_path)
    _wait_for(d, "start")
    p.send_signal(signal.SIGUSR2)
    recs = _wait_for(d, "dump")
    assert [r for r in recs if r["kind"] == "dump"][0]["reason"] == "sigusr2"
    assert p.poll() is None
    p.send_signal(signal.SIGTERM)
    assert p.wait(30) == -signal.SIGTERM
    assert rflight.read_journal(str(d))[0][-1]["reason"] == "sigterm"
