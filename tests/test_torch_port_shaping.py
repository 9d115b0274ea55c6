"""The port's shaped-link harness (`kungfu_tpu_torch/transport/shaping.py`)
and its hook in the client, against the JAX package's
(`kungfu_tpu/transport/shaping.py`); mirrors tests/test_shaping.py.

- The `KF_SHAPE_LINKS` grammar on a table of specs: the same shapes,
  uplinks, rates and errors in both packages, and the same bucket file.
- Seeded message streams under one fake clock: the same delay sequences
  (pacing, latency, the deterministic jitter, the shared uplink).
- `from_env` with the deprecated `KF_TEST_SLOW_EDGE` alias.
- A reference process and a port process drain one `SharedBucket` file
  together.
- The client sleeps the delay inside its timed send window, so the link
  table sees the shaped rate; a ping's round trip carries the latency.
In process, apart from the two bucket processes."""

import json
import os
import random
import struct
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from kungfu_tpu.transport import shaping as rshaping
from kungfu_tpu_torch.telemetry import config, link
from kungfu_tpu_torch.transport import shaping
from kungfu_tpu_torch.transport.message import ConnType
from test_torch_port_worlds import make_world, small_arenas  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _shapes(d):
    return {k: (v.lat_s, v.bw_bps, v.jitter_s) for k, v in d.items()}


def _both(fn, *args, **kw):
    """fn's result in each package, or the exception's type and text."""
    out = []
    for mod in (shaping, rshaping):
        try:
            out.append(("ok", getattr(mod, fn)(*args, **kw)))
        except ValueError as e:
            out.append(("err", str(e)))
    return out


# ---------------------------------------------------------------------------
# grammar
# ---------------------------------------------------------------------------

SPECS = [
    "a:1>b:2=lat:30;b:2=bw:8MiB,jitter:2;*=lat:1",
    "a:1>b:2=lat:30;c:3>b:2=lat:50",
    "*>b:2=lat:10",
    "b:2=lat:0,bw:0",
    "b:2=lat:1; b:2=lat:7",
    " ; b:2 = bw:1.5GiBps , lat:0.25 ;",
    "uplink:hostA=bw:16MiB;a:1>b:2=lat:3;uplink:c:3|c:4=bw:8MiB",
    "a:1>*=jitter:4,bw:123456",
    "b:2",
    "=lat:30",
    "b:2=lat",
    "b:2=speed:9",
    "b:2=lat:-3",
    "b:2=bw:fast",
    "uplink:=bw:8MiB",
    "uplink:hostA",
    "uplink:hostA=lat:3",
    "uplink:hostA=bw:0",
    "uplink:hostA=bw:fast",
]
SENDERS = ["a:1", "c:3", "c:4", "hostA:9000", "zz:9"]


@pytest.mark.parametrize("spec", SPECS)
def test_specs_parse_alike(spec):
    for me in SENDERS:
        mine, theirs = _both("parse_spec", spec, me)
        assert mine[0] == theirs[0], (me, mine, theirs)
        if mine[0] == "ok":
            assert _shapes(mine[1]) == _shapes(theirs[1])
        else:
            assert mine[1] == theirs[1]
        mine, theirs = _both("parse_uplinks", spec, me, make_bucket=False)
        assert mine[0] == theirs[0]
        if mine[0] == "ok":
            assert ([(u.token, u.bw_bps, u.canonical(), u.hostname, u.members)
                     for u in mine[1]]
                    == [(u.token, u.bw_bps, u.canonical(), u.hostname, u.members)
                        for u in theirs[1]])
        else:
            assert mine[1] == theirs[1]


@pytest.mark.parametrize("rate", ["20MiB", "20mibps", "5kb", "1.5GiB", "123456", "7M/s",
                                  "3g", "2KiBps", "0.5mb", "fast", "", "1e3"])
def test_rates_parse_alike(rate):
    mine, theirs = _both("_parse_rate", rate)
    assert mine == theirs


@pytest.mark.parametrize("raw", ["a:1>b:2=40", "b:2=40", "hostB=40", "nonsense", "b:2=x", "=5"])
def test_slow_edge_translates_alike(raw):
    assert _both("_slow_edge_as_spec", raw)[0] == _both("_slow_edge_as_spec", raw)[1]


@pytest.mark.parametrize("legacy,spec", [
    ("a:1>b:2=40", ""), ("nonsense", ""), ("b:2=40", "c:3=lat:5"), ("b:2=40", "b:2=lat:9"),
    ("", "b:2=speed:9"), ("", "uplink:hostA=lat:3"), ("", ""), ("hostB=40", "")])
def test_from_env_alike(legacy, spec, monkeypatch, tmp_path):
    monkeypatch.setenv("KF_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.setenv("KF_TEST_SLOW_EDGE", legacy)
    monkeypatch.setenv("KF_SHAPE_LINKS", spec)
    for me in ("a:1", "zz:9"):
        mine, theirs = shaping.from_env(me), rshaping.from_env(me)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert _shapes(mine._shapes) == _shapes(theirs._shapes)
            mine.close()


def test_bucket_files_are_the_references(tmp_path, monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY_DIR", str(tmp_path))
    spec = "uplink:c:4|c:3=bw:8MiB;uplink:hostA=bw:1.5GiB"
    for me in ("c:3", "hostA:1"):
        (up,) = shaping.parse_uplinks(spec, me)
        (rup,) = rshaping.parse_uplinks(spec, me)
        try:
            assert up.bucket.path == rup.bucket.path
            assert Path(up.bucket.path).parent == tmp_path
            assert shaping.SharedBucket._FMT == rshaping.SharedBucket._FMT
        finally:
            up.bucket.close()
            rup.bucket.close()


# ---------------------------------------------------------------------------
# delay sequences under one fake clock
# ---------------------------------------------------------------------------

def _stream(seed):
    rng = random.Random(seed)
    dsts = ["b:2", "c:3", "d:4"]
    return [(rng.choice(dsts), rng.choice([64, 4096, 65536, 1 << 20, 3 << 20]),
             rng.choice([0.0, 0.0005, 0.01, 0.2]), rng.random() < 0.2)
            for _ in range(120)]


SHAPE_SETS = {
    "pace": {"b:2": (0.0, 1 << 20, 0.0), "c:3": (0.0, 8 << 20, 0.0)},
    "lat_jitter": {"b:2": (0.010, 0.0, 0.004), "*": (0.001, 0.0, 0.002)},
    "all": {"b:2": (0.002, 4 << 20, 0.003), "*": (0.0005, 16 << 20, 0.0)},
}


@pytest.mark.parametrize("shapes", list(SHAPE_SETS))
@pytest.mark.parametrize("seed", range(4))
def test_delay_sequences_agree_under_one_clock(seed, shapes):
    now = [5.0]
    clock = lambda: now[0]  # noqa: E731
    mine = shaping.LinkShaper({k: shaping.EdgeShape(*v) for k, v in SHAPE_SETS[shapes].items()},
                              clock=clock)
    theirs = rshaping.LinkShaper({k: rshaping.EdgeShape(*v)
                                  for k, v in SHAPE_SETS[shapes].items()}, clock=clock)
    for dst, n, dt, ping in _stream(seed):
        now[0] += dt
        if ping:
            assert mine.latency(dst) == theirs.latency(dst)
        else:
            d = mine.delay(dst, n)
            assert d == theirs.delay(dst, n)
            now[0] += d


@pytest.mark.parametrize("seed", range(3))
def test_uplink_delay_sequences_agree_under_one_clock(seed, tmp_path):
    now = [1.0]
    clock = lambda: now[0]  # noqa: E731
    mine = shaping.LinkShaper({"c:3": shaping.EdgeShape(bw_bps=8 << 20)}, clock=clock,
                              uplinks=(shaping.Uplink("a:1|b:2", 2 << 20, shaping.SharedBucket(
                                  str(tmp_path / "p.bucket"), 2 << 20, clock=clock)),))
    theirs = rshaping.LinkShaper({"c:3": rshaping.EdgeShape(bw_bps=8 << 20)}, clock=clock,
                                 uplinks=(rshaping.Uplink("a:1|b:2", 2 << 20,
                                                          rshaping.SharedBucket(
                                     str(tmp_path / "r.bucket"), 2 << 20, clock=clock)),))
    try:
        for dst, n, dt, _ in _stream(100 + seed):
            now[0] += dt
            d = mine.delay(dst, n)
            assert d == theirs.delay(dst, n), dst
            now[0] += d
    finally:
        mine.close()
        theirs._uplinks[0].bucket.close()


def test_pacing_converges_to_the_shaped_rate():
    now = [0.0]
    shaper = shaping.LinkShaper({"d": shaping.EdgeShape(bw_bps=1 << 20)}, clock=lambda: now[0])
    sent = 0
    for _ in range(50):
        now[0] += shaper.delay("d", 256 << 10) + 0.001
        sent += 256 << 10
    assert sent / now[0] == pytest.approx(1 << 20, rel=0.15)


# ---------------------------------------------------------------------------
# one bucket file, two processes (a reference one and a port one)
# ---------------------------------------------------------------------------

DRAIN = """
import sys
pkg, path, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
if pkg == "ref":
    from kungfu_tpu.transport.shaping import SharedBucket
else:
    from kungfu_tpu_torch.transport.shaping import SharedBucket
b = SharedBucket(path, 1 << 20, clock=lambda: 7.0)
print(sum(b.delay(4096) > 0 for _ in range(n)))
b.close()
"""


def test_a_reference_and_a_port_process_drain_one_bucket(tmp_path):
    path = str(tmp_path / "kf-uplink-shared.bucket")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", DRAIN, pkg, path, "200"], env=env,
                              stdout=subprocess.PIPE, text=True, cwd=str(tmp_path))
             for pkg in ("ref", "port")]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    tokens, stamp = struct.unpack("<dd", Path(path).read_bytes()[:16])
    burst = max(shaping.BURST_MIN_BYTES, (1 << 20) * shaping.BURST_SECONDS)
    # a frozen clock never refills: the two processes drained one pool
    assert tokens == burst - 400 * 4096 and stamp == 7.0
    # past the shared burst, both saw debt
    assert sum(int(o) for o in outs) == 400 - int(burst // 4096)


# ---------------------------------------------------------------------------
# the client's hook
# ---------------------------------------------------------------------------

@pytest.fixture
def shaped_pair(monkeypatch, tmp_path):
    """Two port peers with metrics on; rank 0's sends to rank 1 shaped
    to 4 MiB/s with 20 ms of latency (sockets only)."""
    from test_torch_port_worlds import free_ports

    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    monkeypatch.setenv("KF_CONFIG_SHM", "0")
    config.refresh(None)
    ports = free_ports(2)
    monkeypatch.setenv("KF_SHAPE_LINKS", f"127.0.0.1:{ports[0]}>127.0.0.1:{ports[1]}="
                                         "bw:4MiB,lat:20")
    monkeypatch.setattr("test_torch_port_worlds.free_ports", lambda n: ports)
    link.get_table().clear()
    world = make_world(["port", "port"])
    yield world
    for p in world:
        p.stop()
    link.get_table().clear()
    monkeypatch.undo()
    config.refresh(None)


def test_the_client_sleeps_the_shape_inside_its_timed_send(shaped_pair):
    a, b = shaped_pair
    payload = torch.zeros(256 << 10, dtype=torch.uint8)
    got = []

    def recv():
        for i in range(12):
            msg = b.collective.recv(a.self_id, f"shp:{i}", 60.0)
            if msg.release is not None:
                msg.release()
            got.append(i)

    t = threading.Thread(target=recv)
    t.start()
    for i in range(12):
        a.client.send(b.self_id, f"shp:{i}", payload, ConnType.COLLECTIVE)
    t.join(60)
    assert got == list(range(12))
    bw = link.get_table().bandwidth(b.self_id)
    # the first send dialed (no sample); the rest converge on the shape
    assert bw is not None and bw < 4.5 * (1 << 20)
    assert a.client._shaper.shape_for(str(b.self_id)).lat_s == pytest.approx(0.020)
    assert b.client._shaper is None or b.client._shaper.shape_for(str(a.self_id)) is None
    assert a.client.ping(b.self_id)
    assert link.get_table().latency(b.self_id) >= 0.020
    row = link.get_table().row()[str(b.self_id)]
    assert row["tx_messages"] >= 12 and row["bw_samples"] >= 10
    assert json.dumps(row)
