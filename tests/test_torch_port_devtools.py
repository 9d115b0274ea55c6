"""The port's debug instrumentation (`kungfu_tpu_torch/devtools/`) against
the JAX package's; mirrors tests/test_lockwatch.py and
tests/test_protowatch.py.

- lockwatch: each of the reference's scripted cases (an ABBA order
  inversion, before a hang and under real contention, a three-lock
  cycle, a consistent order, a held-too-long lock reported once a site,
  fast holds, Condition/Event/RLock semantics, a condition wait, try
  and timed acquires, the gauge, a cross-thread release) runs against
  each package's detector, with the reference's verdicts. With
  `KF_DEBUG_LOCKS` unset, `kungfu_tpu_torch` imports without lockwatch
  and `threading.Lock` stays the raw factory.
- protowatch: in-process worlds of 2-3 host-plane peers of each package
  under `KF_DEBUG_PROTOCOL`: matching orders agree (sync checks and the
  scheduler's flushes); a diverging order (an extra collective, a
  different shape, a missing one) names the same first divergent entry
  and call site as the reference's sentinel does on its own world; an
  extra tensor in the scheduler's registration round raises the engine's
  error on every peer and is named. With the knob unset nothing is
  imported and the session's methods are the class functions.

In-process worlds bind port 0 outside 38000-38999."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kungfu_tpu.base.ops import ReduceOp as RReduceOp
from kungfu_tpu.base.workspace import Workspace as RWorkspace
from kungfu_tpu.devtools import lockwatch as rlockwatch
from kungfu_tpu.devtools import protowatch as rprotowatch
from kungfu_tpu.telemetry import audit as raudit
from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.base.ops import ReduceOp
from kungfu_tpu_torch.base.workspace import Workspace
from kungfu_tpu_torch.devtools import lockwatch, protowatch
from kungfu_tpu_torch.telemetry import audit, metrics
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    make_world, new_epoch, ref_native, run_all, small_arenas)

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"port": (lockwatch, audit, metrics), "ref": (rlockwatch, raudit, rmetrics)}


# ---------------------------------------------------------------------------
# lockwatch
# ---------------------------------------------------------------------------

@pytest.fixture(params=["port", "ref"])
def watched(request, monkeypatch):
    """One package's detector installed (hold threshold 40 ms), its audit
    log clear; uninstalled after."""
    lw, aud, met = PACKAGES[request.param]
    monkeypatch.setenv("KF_DEBUG_LOCKS_HELD_MS", "40")
    aud.clear()
    lw.install()
    try:
        yield lw, aud, met
    finally:
        lw.uninstall()
        aud.clear()


def _findings(w, kind):
    lw, aud, _ = w
    assert lw.flush(10), "reporter queue failed to drain"
    return [r for r in aud.records() if r.kind == kind]


def _violations(w):
    return _findings(w, "lock_order_violation")


def _long_held(w):
    return _findings(w, "lock_long_held")


def _run(fn, *args):
    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive()


def test_the_knob_unset_leaves_threading_untouched():
    env = {k: v for k, v in os.environ.items() if k != "KF_DEBUG_LOCKS"}
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, threading; real = threading.Lock\n"
         "import kungfu_tpu_torch.api\n"
         "assert threading.Lock is real, 'Lock replaced without the knob'\n"
         "assert not any('lockwatch' in m for m in sys.modules), 'lockwatch imported'\n"
         "print('clean')"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout


def test_the_knob_set_installs_the_detector_first():
    r = subprocess.run(
        [sys.executable, "-c",
         "import threading\n"
         "import kungfu_tpu_torch.api\n"
         "from kungfu_tpu_torch.devtools import lockwatch\n"
         "from kungfu_tpu_torch.telemetry import metrics\n"
         "assert lockwatch.installed()\n"
         "assert type(threading.Lock()).__name__ == '_DebugLock'\n"
         "assert type(metrics.REGISTRY._lock).__name__ in ('_DebugLock', '_DebugRLock')\n"
         "print('watched')"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, KF_DEBUG_LOCKS="1"))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "watched" in r.stdout


def test_install_wraps_and_uninstall_restores(watched):
    lw = watched[0]
    lk = threading.Lock()
    assert type(lk).__name__ == "_DebugLock"
    assert type(threading.RLock()).__name__ == "_DebugRLock"
    lw.uninstall()
    assert type(threading.Lock()).__module__ == "_thread"
    with lk:  # a lock made while installed keeps working after
        assert lk.locked()


def test_abba_cycle_detected_before_hang(watched):
    A, B = threading.Lock(), threading.Lock()
    order = []

    def t1():
        with A:
            with B:
                order.append("t1")

    def t2():
        with B:
            with A:
                order.append("t2")

    _run(t1)
    assert not _violations(watched), "A->B alone is not a cycle"
    _run(t2)
    assert order == ["t1", "t2"]
    v = _violations(watched)
    assert len(v) == 1, [r.detail for r in v]
    d = v[0].detail
    assert "->" in d["cycle"] and d["holding"] and d["wants"]
    assert "test_torch_port_devtools" in d["cycle"]
    c = watched[2].REGISTRY.counter("kungfu_debug_lock_order_violations_total",
                                    "Findings of the KF_DEBUG_LOCKS runtime lock detector")
    assert c.value >= 1


def test_abba_under_real_contention_reports_without_deadlock(watched):
    A, B = threading.Lock(), threading.Lock()
    t1_has_a, t2_has_b = threading.Event(), threading.Event()

    def t1():
        with A:
            t1_has_a.set()
            t2_has_b.wait(5)
            B.acquire(timeout=0.5) and B.release()

    def t2():
        with B:
            t2_has_b.set()
            t1_has_a.wait(5)
            A.acquire(timeout=0.5) and A.release()

    ts = [threading.Thread(target=f, daemon=True) for f in (t1, t2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(15)
        assert not t.is_alive(), "bounded acquires cannot hang"
    assert len(_violations(watched)) == 1


def test_three_lock_cycle_detected(watched):
    A, B, C = threading.Lock(), threading.Lock(), threading.Lock()

    def nest(outer, inner):
        with outer:
            with inner:
                pass

    for pair in ((A, B), (B, C), (C, A)):
        _run(nest, *pair)
    v = _violations(watched)
    assert len(v) == 1
    assert v[0].detail["cycle"].count("->") >= 3


def test_consistent_ordering_is_clean(watched):
    A, B = threading.Lock(), threading.Lock()

    def worker():
        for _ in range(50):
            with A:
                with B:
                    pass

    ts = [threading.Thread(target=worker, daemon=True) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(20)
    assert not _violations(watched)
    assert watched[0].edge_count() >= 1


def test_long_held_lock_reported_once_per_site(watched):
    L = threading.Lock()
    for _ in range(3):
        with L:
            time.sleep(0.06)
    held = _long_held(watched)
    assert len(held) == 1, [r.detail for r in held]
    assert held[0].detail["held_ms"] >= 40
    assert "test_torch_port_devtools" in held[0].detail["lock"]


def test_fast_holds_not_reported(watched):
    L = threading.Lock()
    for _ in range(100):
        with L:
            pass
    assert not _long_held(watched)


def test_condition_event_rlock_semantics_survive(watched):
    c = threading.Condition()
    got = []

    def waiter():
        with c:
            got.append(c.wait(5))

    w = threading.Thread(target=waiter, daemon=True)
    w.start()
    time.sleep(0.05)
    with c:
        c.notify()
    w.join(10)
    assert got == [True]
    e = threading.Event()
    threading.Thread(target=lambda: (time.sleep(0.02), e.set()), daemon=True).start()
    assert e.wait(5)
    rl = threading.RLock()
    with rl:
        with rl:
            with rl:
                pass
    assert not _violations(watched)


def test_condition_wait_does_not_count_as_long_held(watched):
    c = threading.Condition()

    def waiter():
        with c:
            c.wait(0.2)

    _run(waiter)
    assert not _long_held(watched)


def test_nonblocking_and_timeout_acquires(watched):
    L = threading.Lock()
    assert L.acquire(False)
    assert not L.acquire(False)
    L.release()
    assert L.acquire(timeout=0.1)
    L.release()
    assert not _violations(watched)


def test_gauge_publish(watched):
    A, B = threading.Lock(), threading.Lock()
    with A:
        with B:
            pass
    watched[0].publish_gauges()
    g = watched[2].REGISTRY.gauge("kungfu_debug_lock_sites",
                                  "Lock creation sites in the lockwatch acquisition graph")
    assert g.value >= 1


def test_cross_thread_release_clears_holder_entry(watched):
    lw = watched[0]
    H, X = threading.Lock(), threading.Lock()
    H.acquire()
    _run(H.release)
    assert not H.locked()
    before = lw.edge_count()
    with X:
        pass
    assert lw.edge_count() == before
    assert not lw._stacks.get(threading.get_ident())
    assert not _violations(watched)


def test_the_port_engine_runs_under_the_detector(watched, monkeypatch):
    """A host-plane world of 2 port peers walks under the detector with no
    order violation (the reference's np=4 bench under lockwatch)."""
    world = make_world(["port", "port"], strategy="RING_SEGMENTED")
    try:
        xs = [torch.full((1000,), float(r + 1)) for r in range(2)]
        outs = [torch.empty(1000) for _ in range(2)]
        run_all([lambda r=r: world[r].current_session().all_reduce(Workspace(
            send=xs[r], recv=outs[r], op=ReduceOp.SUM, name="lw")) for r in range(2)])
        assert all(torch.equal(o, torch.full((1000,), 3.0)) for o in outs)
    finally:
        for p in world:
            p.stop()
    assert not _violations(watched)


# ---------------------------------------------------------------------------
# protowatch
# ---------------------------------------------------------------------------

@pytest.fixture
def protocol_on(monkeypatch, ref_native):
    monkeypatch.setenv("KF_DEBUG_PROTOCOL", "1")
    for aud in (audit, raudit):
        aud.clear()
    yield
    for aud in (audit, raudit):
        aud.clear()


def _world(kind, k, monkeypatch):
    """A world of k peers of `kind`, moved to a new epoch so every session
    starts under the environment set now."""
    world = make_world([kind] * k, strategy="RING_SEGMENTED")
    new_epoch(world)
    return world


def _reduce(sess, kind, name, n, dtype=np.float32):
    """One all-reduce of `n` values of `dtype` under `name`, by either
    package's session; every call site of the cases is this line."""
    x = np.ones(n, dtype)
    out = np.empty_like(x)
    if kind == "port":
        w = Workspace(send=torch.from_numpy(x), recv=torch.from_numpy(out), op=ReduceOp.SUM,
                      name=name)
    else:
        w = RWorkspace(send=x, recv=out, op=RReduceOp.SUM, name=name)
    sess.all_reduce(w)
    return out


def _divergences(kind):
    aud = audit if kind == "port" else raudit
    return [{k: v for k, v in r.detail.items()} for r in aud.records()
            if r.kind == "protocol_divergence"]


# (what each rank runs before the boundary check): lists of (name, n, dtype)
SCRIPTS = {
    "matching": [[("a", 8, np.float32), ("b", 16, np.float32)]] * 2,
    "extra": [[("a", 8, np.float32), ("b", 16, np.float32)], [("a", 8, np.float32)]],
    "shape": [[("a", 8, np.float32), ("b", 16, np.float32)],
              [("a", 8, np.float32), ("b", 32, np.float32)]],
    "dtype": [[("a", 8, np.float32)], [("a", 8, np.float64)]],
    "name": [[("grad0", 8, np.float32)], [("grad1", 8, np.float32)]],
}


def _script_run(kind, script, monkeypatch):
    """Each rank's script, then a boundary check on every rank. A
    diverging script runs its collectives only where the ranks agree
    (names and sizes alike) — a real mismatched walk would hang — and
    records the rest straight into the window, where the wrapped entry
    point records it."""
    world = _world(kind, 2, monkeypatch)
    pw = protowatch if kind == "port" else rprotowatch
    try:
        sessions = [p.current_session() for p in world]
        common = [e for e in script[0] if all(e in s for s in script)]
        agreed = {}

        def rank(r):
            sess = sessions[r]
            # round 0 holds the new epoch's barrier, whose call site is
            # each package's own peer.py: close it before the script
            assert pw.check(sess)
            for name, n, dtype in script[r]:
                if (name, n, dtype) in common:
                    _reduce(sess, kind, name, n, dtype)
                else:
                    x = np.ones(n, dtype)
                    sess._protowatch.record("all_reduce", name, x.dtype.str, x.nbytes)
            agreed[r] = pw.check(sess)

        run_all([lambda r=r: rank(r) for r in range(2)])
        stats = [pw.stats(s) for s in sessions]
        return agreed, stats, _divergences(kind)
    finally:
        for p in world:
            p.stop()


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_the_sentinel_names_the_references_first_divergence(case, protocol_on, monkeypatch):
    mine = _script_run("port", SCRIPTS[case], monkeypatch)
    theirs = _script_run("ref", SCRIPTS[case], monkeypatch)
    agreed, stats, events = mine
    assert agreed == theirs[0] == {0: case == "matching", 1: case == "matching"}
    assert [dict(s, window=0) for s in stats] == [dict(s, window=0) for s in theirs[1]]
    assert all(s["round"] == 2 and s["window"] == 0 for s in stats)

    def named(evs):  # the ranks' peer ids differ between the two worlds
        return sorted((e["other_peer"], e.get("divergent_index"), e.get("mine"),
                       e.get("theirs"), e["round"], e["window"]) for e in evs)

    assert named(events) == named(theirs[2])
    assert len(events) == (0 if case == "matching" else 2)
    if case == "extra":
        assert any("'b'" in (e.get("mine") or "") and "test_torch_port_devtools.py" in e["mine"]
                   for e in events)
        assert any("ran fewer collectives" in (e.get("theirs") or "") for e in events)


def test_a_matching_async_protocol_is_clean_at_every_flush(protocol_on, monkeypatch):
    """The scheduler's flush runs the boundary check: rounds of submits in
    different arrival orders agree (the window is a multiset)."""
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    world = _world("port", 3, monkeypatch)
    try:
        sessions = [p.current_session() for p in world]

        def rank(r):
            sched = sessions[r].scheduler()
            for rnd in range(3):
                xs = [torch.full((64 * (i + 1),), float(r)) for i in range(3)]
                outs = [torch.empty_like(x) for x in xs]
                # the first round negotiates the launch order: the same on
                # every rank; later rounds arrive in any order
                order = range(3) if r % 2 == 0 or rnd == 0 else reversed(range(3))
                for i in order:
                    sched.submit(Workspace(send=xs[i], recv=outs[i], op=ReduceOp.SUM,
                                           name=f"t{i}"))
                sched.flush()
                assert all(torch.equal(o, torch.full_like(o, 3.0)) for o in outs)

        run_all([lambda r=r: rank(r) for r in range(3)])
        stats = [protowatch.stats(s) for s in sessions]
        assert all(s["checks"] == 3 and s["divergences"] == 0 for s in stats), stats
    finally:
        for p in world:
            p.stop()
    assert _divergences("port") == []


def test_an_extra_tensor_is_named_on_every_peer_before_a_hang(protocol_on, monkeypatch):
    """Rank 0 submits an extra tensor into the registration round: every
    peer raises the engine's named error instead of hanging, and every
    peer's sentinel names the extra tensor and its call site."""
    monkeypatch.setenv("KF_CONFIG_ASYNC", "on")
    world = _world("port", 2, monkeypatch)
    raised = {}
    try:
        sessions = [p.current_session() for p in world]

        def rank(r):
            sched = sessions[r].scheduler()
            names = ["t0", "t1"] + (["pw-extra-tensor"] if r == 0 else [])
            outs = []
            for name in names:
                x = torch.ones(32)
                outs.append(torch.empty_like(x))
                sched.submit(Workspace(send=x, recv=outs[-1], op=ReduceOp.SUM, name=name))
            try:
                sched.flush()
            except RuntimeError as e:
                raised[r] = str(e)

        t0 = time.monotonic()
        run_all([lambda r=r: rank(r) for r in range(2)])
        assert time.monotonic() - t0 < 60
    finally:
        for p in world:
            p.stop()
    assert sorted(raised) == [0, 1], raised
    events = _divergences("port")
    assert len(events) == 2 and all("pw-extra-tensor" in e["mine"] + e["theirs"]
                                    for e in events)
    assert all("test_torch_port_devtools.py" in e["mine"] + e["theirs"] for e in events)


def test_a_session_of_one_records_and_checks_locally(protocol_on, monkeypatch):
    world = _world("port", 1, monkeypatch)
    try:
        sess = world[0].current_session()
        _reduce(sess, "port", "solo", 8)
        assert protowatch.stats(sess)["window"] >= 1
        assert protowatch.check(sess)
        st = protowatch.stats(sess)
        assert st["window"] == 0 and st["round"] == 1 and st["divergences"] == 0
    finally:
        world[0].stop()


def test_the_knob_unset_imports_nothing_and_wraps_nothing():
    env = {k: v for k, v in os.environ.items() if k != "KF_DEBUG_PROTOCOL"}
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch\n"
         "from kungfu_tpu_torch import api\n"
         "from kungfu_tpu_torch.peer import get_default_peer\n"
         "api.all_reduce_array(torch.ones(4))\n"
         "sess = get_default_peer().current_session()\n"
         "assert sess._protowatch is None\n"
         "assert 'all_reduce' not in vars(sess), 'entry point wrapped'\n"
         "assert not any('protowatch' in m for m in sys.modules), 'protowatch imported'\n"
         "print('clean')"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout


@pytest.mark.parametrize("dtype,want", [(torch.float32, "<f4"), (torch.float16, "<f2"),
                                        (torch.bfloat16, "<V2"), (torch.int64, "<i8"),
                                        (torch.uint8, "|u1"), (torch.float64, "<f8")])
def test_entries_spell_dtypes_as_the_reference(dtype, want):
    assert protowatch._dtype_str(torch.zeros(1, dtype=dtype)) == want


def test_the_window_folds_past_its_cap_as_the_reference(monkeypatch):
    monkeypatch.setenv("KF_DEBUG_PROTOCOL_WINDOW", "3")
    assert knobs.get("KF_DEBUG_PROTOCOL_WINDOW") == 3

    class Sess:
        size, rank = 1, 0

        def active_candidate_name(self):
            return "RING_SEGMENTED"

    digests = []
    for pw in (protowatch, rprotowatch):
        w = pw._Watch(Sess(), 8)  # attach() floors the cap at 8
        for i in range(11):
            w.record("all_reduce", f"t{i}", "<f4", 4 * i)
        assert len(w.window) == 8 and w.folded_n == 3
        digests.append(pw._Watch._digest(w.window, w.folded, w.folded_n))
    assert digests[0] == digests[1]
