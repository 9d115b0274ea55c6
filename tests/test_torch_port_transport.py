"""The port's transport (`kungfu_tpu_torch/transport/`, `store/`) against
the JAX package's, in process: the framing's bytes on the wire, the socket
pump and its build, the shared-memory arena's bytes, the rendezvous
endpoints and the blob stores. Nothing here starts a peer's server: the
framing runs over `socket.socketpair`, the arenas over files in /dev/shm."""

import itertools
import os
import socket
import threading
import uuid

import numpy as np
import pytest
import torch

from kungfu_tpu.plan.peer import PeerID as RPeerID
from kungfu_tpu.store import versioned as rversioned
from kungfu_tpu.transport import handlers as rhandlers
from kungfu_tpu.transport import message as rmsg
from kungfu_tpu.transport import shm as rshm
from kungfu_tpu.transport import server as rserver
from kungfu_tpu_torch.base import _native
from kungfu_tpu_torch.ops import _build
from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.store import versioned
from kungfu_tpu_torch.transport import handlers, shm
from kungfu_tpu_torch.transport import message as msg
from kungfu_tpu_torch.transport import server

SIZES = [0, 1, 65537, 1 << 20]
NAMES = ["", "kungfu::user::x", "w[3/8]:rs2", "ünïcode"]


def _payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def _wire_bytes(send, *args) -> bytes:
    """The bytes `send(sock, *args)` puts on a socket (read on a thread, so
    a frame larger than the socket buffer does not block the sender)."""
    a, b = socket.socketpair()
    got = []
    with a, b:
        t = threading.Thread(target=lambda: got.append(_drain(b)))
        t.start()
        send(a, *args)
        a.shutdown(socket.SHUT_WR)
        t.join(30)
    return got[0]


def _drain(sock: socket.socket) -> bytes:
    out = bytearray()
    while True:
        chunk = sock.recv(1 << 20)
        if not chunk:
            return bytes(out)
        out += chunk


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("conn_type", list(msg.ConnType))
@pytest.mark.parametrize("host", ["127.0.0.1", "node-7.cluster"])
def test_connection_header_bytes_and_parse_match_the_reference(conn_type, host):
    mine = _wire_bytes(msg.send_header, conn_type, host, 38123, 7)
    theirs = _wire_bytes(rmsg.send_header, rmsg.ConnType(int(conn_type)), host, 38123, 7)
    assert mine == theirs
    for send, recv in ((msg.send_header, rmsg.recv_header), (rmsg.send_header, msg.recv_header)):
        a, b = socket.socketpair()
        with a, b:
            send(a, conn_type, host, 38123, 7)
            ct, h, port, token = recv(b)
        assert (int(ct), h, port, token) == (int(conn_type), host, 38123, 7)
    a, b = socket.socketpair()
    with a, b:
        msg.send_ack(a, 0xDEADBEEF)
        assert rmsg.recv_ack(b) == 0xDEADBEEF
        rmsg.send_ack(b, 12)
        assert msg.recv_ack(a) == 12


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("flags", [msg.Flags.NONE, msg.Flags.WAIT_RECV_BUF,
                                   msg.Flags.IS_RESPONSE | msg.Flags.REQUEST_FAILED])
def test_message_frame_bytes_match_the_reference(size, flags):
    data = _payload(size, size)
    for i, name in enumerate(NAMES):
        mine = _wire_bytes(msg.send_message, msg.Message(name, data, flags))
        theirs = _wire_bytes(rmsg.send_message,
                             rmsg.Message(name, data, rmsg.Flags(int(flags))))
        assert mine == theirs, name
        # a tensor payload frames as its bytes, sent by its data pointer
        t = torch.frombuffer(bytearray(data), dtype=torch.uint8) if size else torch.empty(0)
        assert _wire_bytes(msg.send_message, msg.Message(name, t, flags)) == theirs


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_each_side_parses_the_others_frames(size, direction):
    data = _payload(size, 100 + size)
    send, recv, M = ((msg.send_message, rmsg.recv_message, msg.Message)
                     if direction == "port_to_reference"
                     else (rmsg.send_message, msg.recv_message, rmsg.Message))
    a, b = socket.socketpair()
    got = []
    with a, b:
        t = threading.Thread(target=lambda: got.extend(recv(b) for _ in NAMES))
        t.start()
        for name in NAMES:
            send(a, M(name, data, rmsg.Flags.IS_RESPONSE))
        t.join(30)
    assert [m.name for m in got] == NAMES
    for m in got:
        assert bytes(m.data) == data and int(m.flags) == int(rmsg.Flags.IS_RESPONSE)


def test_a_sink_receives_a_frame_payload_into_a_tensor():
    data = _payload(4096, 3)
    a, b = socket.socketpair()
    with a, b:
        rmsg.send_message(a, rmsg.Message("x", data))
        name, flags, n = msg.recv_frame_header(b)
        sink = torch.empty(n, dtype=torch.uint8)
        msg._recv_exact_into(b, sink)
    assert (name, n) == ("x", 4096) and sink.numpy().tobytes() == data


def test_the_pump_has_no_fallback_and_a_failed_build_raises(tmp_path, monkeypatch):
    """With CXX a compiler that fails and a fresh build directory, the
    first framed send raises RuntimeError naming the compiler: the port
    has no Python loop to fall back to."""
    fake = tmp_path / "failing-cxx"
    fake.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_lib", None)
    a, b = socket.socketpair()
    with a, b:
        with pytest.raises(RuntimeError, match=r"failing-cxx failed building the host library"):
            msg.send_message(a, msg.Message("x", b"abc"))
        with pytest.raises(RuntimeError, match="failing-cxx"):
            msg.recv_message(b)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_pump_is_built_from_the_ports_source():
    src = _build.HOST_CSRC / "io_pump.cpp"
    assert src.is_file()
    assert "kf_send2" in src.read_text() and "kf_recv_exact" in src.read_text()
    before = dict(_native.CALLS)
    a, b = socket.socketpair()
    with a, b:
        msg.send_message(a, msg.Message("x", b"abcd"))
        assert bytes(msg.recv_message(b).data) == b"abcd"
    assert _native.CALLS["send2"] > before["send2"]
    assert _native.CALLS["recv_exact"] > before["recv_exact"]


@pytest.mark.parametrize("what", ["eof", "timeout"])
def test_pump_errors_map_to_pythons(what):
    a, b = socket.socketpair()
    with a, b:
        if what == "eof":
            a.close()
            with pytest.raises(ConnectionError):
                msg.recv_message(b)
        else:
            b.settimeout(0.05)
            with pytest.raises(socket.timeout):
                msg.recv_message(b)


def test_unix_socket_path_is_the_references():
    assert server.unix_sock_path(PeerID("127.0.0.2", 40001)) == \
        rserver.unix_sock_path(RPeerID("127.0.0.2", 40001))


# ---------------------------------------------------------------------------
# shared-memory arena
# ---------------------------------------------------------------------------

needs_shm = pytest.mark.skipif(not os.path.isdir("/dev/shm"), reason="no /dev/shm")

CAP = 1 << 16
# write sizes, then an order to release the regions in (indices)
SEQUENCES = {
    "fill": ([4096] * 16, list(range(16))),
    "wrap": ([20000, 20000, 20000, 9000], [0, 1, 2, 3]),
    "out_of_order": ([3000, 5000, 7000, 11000, 13000], [2, 0, 4, 1, 3]),
    "full_then_drain": ([30000, 30000, 30000], [1, 0, 2]),
    "odd_sizes": ([1, 7, 4095, 4097, 57000, 60000], [4, 3, 2, 1, 0, 5]),
    "refill_after_release": ([40000, 30000, 20000, 30000], [0, 1, 2, 3]),
}


def _arena_paths():
    tag = uuid.uuid4().hex[:8]
    return f"/dev/shm/kfshm-test-port-{tag}", f"/dev/shm/kfshm-test-ref-{tag}"


@needs_shm
@pytest.mark.parametrize("seq", list(SEQUENCES))
def test_arena_bytes_match_the_reference(seq):
    """The same writes and releases leave byte-equal arenas (header page,
    wrap padding, payload) and equal descriptors; a write that finds no
    space is refused by both; the receivers read every region of either
    arena."""
    sizes, order = SEQUENCES[seq]
    pport, pref = _arena_paths()
    mine, theirs = shm.SenderArena(pport, CAP), rshm.SenderArena(pref, CAP)
    try:
        rx_mine, rx_theirs = shm.ReceiverArena(pref), rshm.ReceiverArena(pport)
        regions = []
        pending = list(order)
        for i, n in enumerate(sizes):
            data = _payload(n, i)
            tensor = torch.frombuffer(bytearray(data), dtype=torch.uint8)
            d1, d2 = mine.try_write(tensor, n), theirs.try_write(data, n)
            if d1 is None:
                # the ring is full: release in the given order until it fits
                assert d2 is None
                while d1 is None and pending:
                    j = pending.pop(0)
                    if j < len(regions):
                        regions[j][1]()
                        regions[j][3]()
                    d1, d2 = mine.try_write(tensor, n), theirs.try_write(data, n)
            assert d1 == d2 and d1 is not None
            off, length, adv = shm.DESC.unpack(d1)
            # the port's receiver maps the reference's ring, and the other way
            v1, rel1 = rx_mine.region(off, length, adv)
            v2, rel2 = rx_theirs.region(off, length, adv)
            assert bytes(v1) == data and bytes(v2) == data
            regions.append((v1, rel1, v2, rel2))
            with open(pport, "rb") as f1, open(pref, "rb") as f2:
                assert f1.read() == f2.read()
        for j in pending:
            if j < len(regions):
                regions[j][1]()
                regions[j][3]()
        with open(pport, "rb") as f1, open(pref, "rb") as f2:
            h1, h2 = f1.read(shm.HEADER), f2.read(shm.HEADER)
        assert h1 == h2
        magic, cap, alloc, consumed = shm._HDR.unpack(h1[:32])
        assert (magic, cap) == (shm.MAGIC, CAP) and consumed == alloc
        del v1, v2, regions
        rx_mine.close()
        rx_theirs.close()
    finally:
        mine.close()
        theirs.close()
    assert not os.path.exists(pport) and not os.path.exists(pref)


@pytest.mark.parametrize("args", [("127.0.0.1", 40001, "127.0.0.1", 40002, 2),
                                  ("h", 1, "g", 2, 4)])
def test_arena_path_and_layout_constants_are_the_references(args):
    assert shm.arena_path(*args) == rshm.arena_path(*args)
    assert (shm.MAGIC, shm.HEADER, shm.DESC.format, shm._HDR.format) == \
        (rshm.MAGIC, rshm.HEADER, rshm.DESC.format, rshm._HDR.format)
    assert (shm.DEFAULT_CAPACITY, shm.SHM_MIN_BYTES) == \
        (rshm.DEFAULT_CAPACITY, rshm.SHM_MIN_BYTES)
    assert issubclass(shm.ArenaSpaceError, OSError)


@needs_shm
def test_a_payload_larger_than_the_ring_is_refused():
    p, _ = _arena_paths()
    a = shm.SenderArena(p, 4096)
    try:
        assert a.try_write(b"x" * 4097, 4097) is None
        assert a.try_write(b"x" * 4096, 4096) is not None
    finally:
        a.close()


# ---------------------------------------------------------------------------
# rendezvous endpoints and stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_msgs", [1, 3])
@pytest.mark.parametrize("interleave", [False, True])
def test_rendezvous_fifo_per_source_and_name(n_msgs, interleave):
    """put/get per (src, name) in FIFO order, one box per key, boxes
    collected once drained — as the reference's."""
    results = []
    for mod, ep, P in ((msg, handlers.QueueEndpoint(), PeerID),
                       (rmsg, rhandlers.QueueEndpoint(), RPeerID)):
        srcs = [P("127.0.0.1", 1), P("127.0.0.1", 2)]
        keys = list(itertools.product(srcs, ["a", "b"]))
        if interleave:
            keys = keys[::-1]
        for i in range(n_msgs):
            for src, name in keys:
                ep.handle(src, mod.Message(name, f"{src.port}{name}{i}".encode()))
        got = [bytes(ep.get(src, name, 1.0)) for i in range(n_msgs) for src, name in keys]
        results.append((got, len(ep._rdv._boxes)))
    assert results[0] == results[1]
    assert results[0][1] == 0


@pytest.mark.parametrize("case", ["sink_first", "message_first", "size_mismatch", "timeout"])
def test_collective_endpoint_sink_protocol(case):
    """recv_into: a sink parked first is filled in place (filled=True); a
    message that arrived first, or of another size, comes back buffered;
    a receive nobody answers times out. Each as the reference's."""
    outs = []
    for mod, ep, P in ((msg, handlers.CollectiveEndpoint(), PeerID),
                       (rmsg, rhandlers.CollectiveEndpoint(), RPeerID)):
        src = P("127.0.0.1", 5)
        buf = bytearray(8)
        view = memoryview(buf)
        res = {}

        def recv():
            try:
                m, filled = ep.recv_into(src, "x", view, 0.2 if case == "timeout" else 5.0)
                res["out"] = (bytes(m.data) if m is not None else None, filled)
            except TimeoutError:
                res["out"] = "timeout"

        if case == "message_first":
            ep.handle(src, mod.Message("x", b"12345678"))
        t = threading.Thread(target=recv)
        t.start()
        if case in ("sink_first", "size_mismatch"):
            for _ in range(200):
                sink = ep.take_sink(src, "x", 8 if case == "sink_first" else 4)
                if sink is not None or case == "size_mismatch":
                    break
                threading.Event().wait(0.005)
            if case == "sink_first":
                sink.view[:] = b"abcdefgh"
                ep.finish_sink(src, "x", sink, mod.Flags.NONE, ok=True)
            else:
                assert sink is None
                ep.handle(src, mod.Message("x", b"wxyz"))
        t.join(10)
        outs.append((res["out"], bytes(buf)))
    assert outs[0] == outs[1]


def test_p2p_lookup_and_store_match_the_reference():
    results = []
    for store_mod, ep_cls, P in ((versioned, handlers.P2PEndpoint, PeerID),
                                 (rversioned, rhandlers.P2PEndpoint, RPeerID)):
        ep = ep_cls(store_mod.BlobStore(), None, P("127.0.0.1", 1))
        ep.save("w", b"flat")
        for v in range(5):
            ep.save_version(v, "w", f"v{v}".encode())
        results.append([ep._lookup(n) for n in
                        ("w", "w@#latest", "w@#4", "w@#1", "w@#x", "missing", "w@#99")])
    assert results[0] == results[1]
    assert results[0][:4] == [b"flat", b"v4", b"v4", None]


@pytest.mark.parametrize("window", [1, 2, 3])
def test_versioned_store_matches_the_reference(window):
    mine, theirs = versioned.VersionedStore(window), rversioned.VersionedStore(window)
    ops = [(0, "a"), (1, "a"), (1, "b"), (2, "a"), (3, "b"), (3, "c"), (5, "a")]
    for v, n in ops:
        for s in (mine, theirs):
            s.put(v, n, f"{v}{n}".encode())
        for name in "abc":
            assert mine.latest_version(name) == theirs.latest_version(name)
            assert mine.get_latest(name) == theirs.get_latest(name)
            for q in range(6):
                assert mine.get(q, name) == theirs.get(q, name)
    bs, rbs = versioned.BlobStore(), rversioned.BlobStore()
    for s in (bs, rbs):
        s.put("x", bytearray(b"1"))
        s.put("y", b"2")
        s.put("x", b"3")
    assert (bs.get("x"), bs.get("y"), bs.names()) == (rbs.get("x"), rbs.get("y"), rbs.names())
