"""The port's `knobs`, `telemetry/log` and `utils/` (handoff, pool, state,
stall) against the JAX package's: every knob the port declares reads the
same environment the same way, and the utilities behave as
`tests/test_handoff.py` and `tests/test_native_and_aux.py` hold the
reference's. In process."""

import io
import threading
import time

import pytest
import torch

from kungfu_tpu import knobs as rknobs
from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import log
from kungfu_tpu_torch.utils import log as ulog
from kungfu_tpu_torch.utils.handoff import HandoffQueue, parallel_run
from kungfu_tpu_torch.utils.pool import BufferPool, CachedThreadPool, get_buffer_pool, get_pool
from kungfu_tpu_torch.utils.state import Counter, ExponentialMovingAverage
from kungfu_tpu_torch.utils.stall import stall_detect

# strings each knob is read from: empty, blank, plausible, malformed
SAMPLES = ["", "  ", "1", "0", "yes", "OFF", "127.0.0.1:38000", " a:1,b:2 ", "0,1,,3",
           "DEBUG", "warn", "7", "x1", "3.5"]


# ---------------------------------------------------------------------------
# knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", knobs.names())
def test_each_knob_reads_the_environment_as_the_reference(name, monkeypatch):
    mine, theirs = knobs.declared()[name], rknobs.declared()[name]
    for field in ("default", "doc", "section", "kind", "default_doc", "strict", "consensus"):
        assert getattr(mine, field) == getattr(theirs, field), field
    monkeypatch.delenv(name, raising=False)
    assert knobs.get(name) == rknobs.get(name) and knobs.raw(name) == rknobs.raw(name)
    assert knobs.is_set(name) is rknobs.is_set(name) is False
    for s in SAMPLES:
        monkeypatch.setenv(name, s)
        assert knobs.raw(name) == rknobs.raw(name), s
        if mine.strict:  # a malformed value raises, as the reference's does
            try:
                want = rknobs.get(name)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    knobs.get(name)
                assert str(got.value) == str(e), s
                continue
            assert knobs.get(name) == want, s
        assert knobs.get(name) == rknobs.get(name), s
        assert knobs.is_set(name)
        # a mapping passed in reads as the environment does
        assert knobs.get(name, {name: s}) == knobs.get(name)


@pytest.mark.parametrize("parser", ["_bool", "_int", "_float", "_int_bytes", "_str",
                                    "_stripped", "_csv", "_opt_int"])
def test_parsers_match_the_reference(parser):
    for s in SAMPLES + ["8e6", " 12 ", "-4"]:
        try:
            want = getattr(rknobs, parser)(s)
        except ValueError:
            with pytest.raises(ValueError):
                getattr(knobs, parser)(s)
            continue
        assert getattr(knobs, parser)(s) == want, s


def test_choice_parser_matches_the_reference():
    for empty_as in (None, "off"):
        mine = knobs._choice("KF_X", ("off", "on", ""), empty_as=empty_as)
        theirs = rknobs._choice("KF_X", ("off", "on", ""), empty_as=empty_as)
        for s in ("ON", " off ", ""):
            assert mine(s) == theirs(s)
        with pytest.raises(ValueError, match=r"KF_X must be one of \['off', 'on'\], got 'x'"):
            mine("x")


def test_registry_and_doc():
    assert set(knobs.names()) == {
        "KF_SELF_SPEC", "KF_INIT_PEERS", "KF_DEVICE_SLOTS", "KF_LOG_PREFIX",
        "KF_CONFIG_ENABLE_STALL_DETECTION", "KF_LOG_LEVEL", "KF_CONFIG_LOG_LEVEL",
        # the worker contract of runner/env.py, and the transport's and engine's
        "KF_INIT_RUNNERS", "KF_PARENT_ID", "KF_INIT_CLUSTER_VERSION", "KF_INIT_PROGRESS",
        "KF_ALLREDUCE_STRATEGY", "KF_SPAWN_TS", "KF_CONFIG_SERVER", "KF_ELASTIC_MODE",
        "KF_CONFIG_ALGO", "KF_CONFIG_WIRE", "KF_CONFIG_WIRE_MIN_BYTES", "KF_WIRE_BLOCK",
        "KF_CONFIG_CHUNK_BYTES", "KF_CONFIG_SEGMENT_MIN_BYTES", "KF_CONFIG_GROUP_WINDOW",
        "KF_CONFIG_GROUP_FUSE_MIN", "KF_CONFIG_GROUP_BUCKET_BYTES", "KF_CONFIG_ASYNC",
        "KF_CONFIG_ZERO", "KF_CONFIG_REPLAN", "KF_REPLAN_DEMOTE_PATIENCE", "KF_CONFIG_SHM",
        "KF_CONFIG_SHM_CAPACITY", "KF_CONFIG_SHM_MIN_BYTES", "KF_DEBUG_PROTOCOL",
        # the async scheduler's
        "KF_CONFIG_ASYNC_QUEUE",
        # the runners' (kfrun, monitored, standby)
        "KF_RUNNER_PID", "KF_RECOVER_EPOCH", "KF_MONITOR_ADDR", "KF_STANDBY_FIFO",
        "KF_STANDBY_PRELOAD", "KF_ACTIVATED_TS",
        # the telemetry plane's
        "KF_TELEMETRY", "KF_TELEMETRY_MAX_SERIES", "KF_TELEMETRY_SPAN_SAMPLE",
        "KF_TRACE_BUFFER", "KF_CONFIG_ENABLE_MONITORING"}
    assert len(knobs.names()) == 44
    doc = knobs.render_doc()
    theirs = set(rknobs.render_doc().splitlines())
    rows = [line for line in doc.splitlines() if line.startswith("| `KF_")]
    assert len(rows) == len(knobs.names())
    assert all(row in theirs for row in rows)  # each row as the reference renders it
    with pytest.raises(KeyError):
        knobs.get("KF_NOT_DECLARED")
    with pytest.raises(ValueError, match="declared twice"):
        knobs._knob("KF_SELF_SPEC", "", knobs._str, "", section="x", kind="str")


def test_a_malformed_value_warns_and_keeps_the_default(monkeypatch):
    knobs._knob("KF_TEST_PORT_INT", "5", knobs._int, "test", section="Test", kind="int")
    knobs._knob("KF_TEST_PORT_STRICT", "a", knobs._choice("KF_TEST_PORT_STRICT", ("a", "b")),
                "test", section="Test", kind="choice", strict=True)
    out = io.StringIO()
    try:
        log.set_output(out)
        monkeypatch.setenv("KF_TEST_PORT_INT", "x1")
        assert knobs.get("KF_TEST_PORT_INT") == 5
        assert "KF_TEST_PORT_INT: malformed value 'x1'" in out.getvalue()
        monkeypatch.setenv("KF_TEST_PORT_STRICT", "c")
        with pytest.raises(ValueError, match="KF_TEST_PORT_STRICT must be one of"):
            knobs.get("KF_TEST_PORT_STRICT")
    finally:
        log.set_output(None)
        del knobs._REGISTRY["KF_TEST_PORT_INT"], knobs._REGISTRY["KF_TEST_PORT_STRICT"]
        knobs._SECTIONS.remove("Test")


# ---------------------------------------------------------------------------
# the logger
# ---------------------------------------------------------------------------

def test_log_level_and_prefix_come_from_the_knobs(monkeypatch):
    out = io.StringIO()
    monkeypatch.setenv("KF_LOG_LEVEL", "WARN")
    monkeypatch.setenv("KF_LOG_PREFIX", "1/4")
    try:
        log.reset()
        log.set_output(out)
        ulog.info("hidden")
        ulog.warn("resize landed %d", 3, old=4, new=3)
        log.error("bad")
        lines = out.getvalue().splitlines()
        assert len(lines) == 2
        assert lines[0].endswith("[W] kungfu[1/4] resize landed 3 old=4 new=3")
        assert log.tail(1)[0].endswith("[E] bad")
        monkeypatch.delenv("KF_LOG_LEVEL")
        monkeypatch.setenv("KF_CONFIG_LOG_LEVEL", "debug")
        log.reset()
        log.debug("shown")
        assert out.getvalue().splitlines()[-1].endswith("shown")
    finally:
        log.set_output(None)
        log.reset()


# ---------------------------------------------------------------------------
# handoff (as tests/test_handoff.py holds the reference's)
# ---------------------------------------------------------------------------

def test_handoff_queue_roundtrip_bound_and_abort():
    q = HandoffQueue(maxsize=2)
    assert q.put(1) and q.put(2) and len(q) == 2
    result = {}

    def producer():
        result["ok"] = q.put(3)  # full, nobody consumes

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.1)
    assert t.is_alive()
    q.close()
    t.join(5)
    assert not t.is_alive() and result["ok"] is False
    assert q.get() == 1 and q.get() == 2 and q.get() is None  # drains, then the sentinel


def test_handoff_shared_abort_and_try_get():
    abort = threading.Event()
    q1, q2 = HandoffQueue(abort=abort), HandoffQueue(abort=abort)
    t0 = time.monotonic()
    assert q2.try_get(0.3) is None
    assert 0.2 <= time.monotonic() - t0 < 2.0
    q2.put("x")
    assert q2.try_get(1.0) == "x"
    q1.close()
    assert q2.get() is None


def test_parallel_run_runs_all_reraises_and_times_out():
    hits = []
    lock = threading.Lock()

    def mk(i):
        def fn():
            with lock:
                hits.append(i)
        return fn

    parallel_run([mk(i) for i in range(8)], timeout=10)
    assert sorted(hits) == list(range(8))
    parallel_run([], timeout=0.001)
    tid = {}
    parallel_run([lambda: tid.setdefault("t", threading.get_ident())], 10)
    assert tid["t"] == threading.get_ident()

    def boom():
        raise ValueError("real error")

    with pytest.raises(ValueError, match="real error"):
        parallel_run([boom, lambda: None], timeout=10)
    cancel, release = threading.Event(), threading.Event()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        parallel_run([lambda: release.wait(10)] * 4, timeout=0.3, cancel=cancel)
    assert cancel.is_set() and time.monotonic() - t0 < 2.0  # one deadline for all
    release.set()


# ---------------------------------------------------------------------------
# pool, state, stall
# ---------------------------------------------------------------------------

def test_cached_thread_pool_reuses_parked_workers():
    pool = CachedThreadPool(idle_ttl=5.0)
    names, done = [], threading.Event()
    for i in range(3):
        ev = threading.Event()
        pool.submit(lambda ev=ev: (names.append(threading.current_thread().name), ev.set()))
        assert ev.wait(5)
        time.sleep(0.05)  # the worker parks before the next submit
    pool.submit(done.set)
    assert done.wait(5)
    assert len(set(names)) == 1 and names[0].startswith("kf-pool-")
    assert get_pool() is get_pool()


def test_buffer_pool_reuses_exact_sizes():
    pool = BufferPool(max_per_size=1)
    a = pool.get(64)
    assert a.dtype == torch.uint8 and a.shape == (64,) and not pool.pin_memory
    pool.put(a)
    assert pool.cached_bytes() == 64
    assert pool.get(64).data_ptr() == a.data_ptr()
    assert pool.get(64).data_ptr() != a.data_ptr()  # bin empty: a fresh buffer
    pool.put(a)
    pool.put(torch.empty(64, dtype=torch.uint8))  # over max_per_size: dropped
    assert pool.cached_bytes() == 64
    with pytest.raises(ValueError, match="byte buffers"):
        pool.put(torch.empty(16, dtype=torch.float32))
    assert get_buffer_pool() is get_buffer_pool() and not get_buffer_pool().pin_memory


def test_pinned_buffer_pool_needs_a_card():
    if torch.cuda.is_available():
        buf = BufferPool(pin_memory=True).get(128)
        assert buf.is_pinned()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        BufferPool(pin_memory=True)


def test_counter_and_ema():
    c = Counter()
    assert [c(), c(), c()] == [0, 1, 2] and c.value == 3
    ema = ExponentialMovingAverage(0.5)
    assert ema.value == 0.0
    assert ema.update(4.0) == 4.0 and ema.update(2.0) == 3.0 and ema.value == 3.0
    with pytest.raises(ValueError):
        ExponentialMovingAverage(0.0)
    counts = Counter(10)

    def bump():
        for _ in range(1000):
            counts()

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads) and counts.value == 8010


def test_stall_detector(monkeypatch):
    out = io.StringIO()
    try:
        log.set_output(out)
        with stall_detect("test-op", period=0.1, force=True):
            time.sleep(0.35)
        assert "test-op stalled" in out.getvalue()
        monkeypatch.delenv("KF_CONFIG_ENABLE_STALL_DETECTION", raising=False)
        with stall_detect("quiet-op", period=0.1):  # disabled by default
            time.sleep(0.15)
        assert "quiet-op" not in out.getvalue()
        monkeypatch.setenv("KF_CONFIG_ENABLE_STALL_DETECTION", "yes")
        with stall_detect("loud-op", period=0.1):
            time.sleep(0.25)
        assert "loud-op stalled" in out.getvalue()
    finally:
        log.set_output(None)
