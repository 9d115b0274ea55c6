"""Endpoint handlers: collective rendezvous, p2p store, queues, control.

Port of `kungfu_tpu/transport/handlers.py`. Capability parity: srcs/go/rchannel/handler/{collective,p2p,queue}.go —
- CollectiveEndpoint: named rendezvous queues; Recv blocks until a message
  with that name arrives (graph-walk collectives pair send/recv by name).
- PeerToPeerEndpoint: request/response over a versioned blob store (the
  PairAveraging model exchange).
- QueueHandler: named FIFO queues between peers.
- ControlHandler: delivers cluster Stage updates to a callback.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Optional, Tuple

from kungfu_tpu_torch.plan.peer import PeerID
from kungfu_tpu_torch.transport.message import ConnType, Flags, Message


class _Sink:
    """A receiver-registered destination buffer (a writable memoryview, or
    a contiguous CPU tensor taken as its bytes). The transport thread
    delivers a matching payload straight off the socket into `view`
    (zero-copy receive, parity: WAIT_RECV_BUF / handler/collective.go
    RecvInto)."""

    __slots__ = ("view", "state", "flags")
    WAITING, TAKEN, DONE, FAILED, CANCELLED = range(5)

    def __init__(self, view):
        self.view = view
        self.state = _Sink.WAITING
        self.flags = Flags.NONE


class _Box:
    """Per-(src, name) mailbox with its own condition — a put wakes only
    this key's waiters (one shared condition would thundering-herd every
    in-flight chunk walk on every message)."""

    __slots__ = ("cond", "msgs", "sinks", "waiters", "dead")

    def __init__(self):
        self.cond = threading.Condition()
        self.msgs: deque = deque()
        self.sinks: deque = deque()
        self.waiters = 0
        self.dead = False

    def idle(self) -> bool:
        return not self.msgs and not self.sinks and self.waiters == 0


class _Rendezvous:
    """Blocking mailboxes per (src, name), with optional registered sinks.

    GC protocol: a box leaves the dict only after being marked ``dead``
    under its own condition (``_gc_locked``), and every writer/waiter
    re-fetches the box when it observes ``dead`` — otherwise a put() that
    grabbed a box reference just before GC would append to an orphan no
    future get() can see, stranding a collective until its timeout."""

    def __init__(self):
        self._lock = threading.Lock()  # guards the box dict only
        self._boxes: Dict[Tuple[PeerID, str], _Box] = {}

    def _box(self, key) -> _Box:
        with self._lock:
            b = self._boxes.get(key)
            if b is None:
                b = self._boxes[key] = _Box()
            return b

    def _gc_locked(self, key, box: _Box) -> None:
        """Drop a drained mailbox (long elastic runs must not accumulate
        dead version/chunk-tagged keys). box.cond MUST be held; the dict
        lock nests inside it (nothing acquires box.cond while holding the
        dict lock, so the order cannot invert)."""
        if box.idle() and not box.dead:
            with self._lock:
                if self._boxes.get(key) is box:
                    box.dead = True
                    del self._boxes[key]

    def put(self, src: PeerID, msg: Message) -> None:
        key = (src, msg.name)
        while True:
            box = self._box(key)
            with box.cond:
                if box.dead:
                    continue  # lost the race with _gc_locked: re-fetch
                box.msgs.append(msg)
                # notify_all: waiters include get() consumers AND
                # get_into() sink-parkers whose predicates differ; per-key
                # wakeups are 1-2 threads, so this is cheap
                box.cond.notify_all()
                return

    def get(self, src: PeerID, name: str, timeout: Optional[float] = None) -> Message:
        key = (src, name)
        while True:
            box = self._box(key)
            with box.cond:
                if box.dead:
                    continue
                box.waiters += 1
                try:
                    ok = box.cond.wait_for(lambda: len(box.msgs) > 0, timeout)
                    if not ok:
                        raise TimeoutError(f"recv timeout: {name} from {src}")
                    return box.msgs.popleft()
                finally:
                    box.waiters -= 1
                    self._gc_locked(key, box)

    # -- zero-copy receive ------------------------------------------------

    def take_sink(self, src: PeerID, name: str, nbytes: int) -> Optional[_Sink]:
        """Transport side: claim a waiting sink of exactly `nbytes`, or None
        (fall back to a buffered Message)."""
        key = (src, name)
        with self._lock:
            box = self._boxes.get(key)
        if box is None:
            return None
        with box.cond:
            # a dead box has no sinks by construction; the loop is empty
            for s in box.sinks:
                if s.state == _Sink.WAITING and s.view.nbytes == nbytes:
                    s.state = _Sink.TAKEN
                    return s
            return None

    def finish_sink(self, src: PeerID, name: str, sink: _Sink, flags: Flags, ok: bool) -> None:
        key = (src, name)
        while True:
            box = self._box(key)
            with box.cond:
                if box.dead:
                    continue
                sink.flags = flags
                sink.state = _Sink.DONE if ok else _Sink.FAILED
                box.cond.notify_all()
                # pathological path: the receiver gave up mid-fill and its
                # box was GC'd; don't let a re-created box linger
                self._gc_locked(key, box)
                return

    def get_into(
        self, src: PeerID, name: str, view, timeout: Optional[float]
    ) -> Tuple[Optional[Message], bool]:
        """Receive (src, name), preferring direct delivery into `view`.

        Returns (msg, filled): filled=True means the payload is in `view`
        and msg is None; otherwise msg is a buffered Message (sender raced
        registration, or size mismatch). On timeout with the sink mid-fill
        (TAKEN), the buffer must NOT be reused — the caller leaks it."""
        key = (src, name)
        sink = _Sink(view)
        while True:
            box = self._box(key)
            with box.cond:
                if box.dead:
                    continue  # lost the race with _gc_locked: re-fetch
                box.waiters += 1
                try:
                    if box.msgs:
                        return box.msgs.popleft(), False
                    box.sinks.append(sink)

                    def ready():
                        return sink.state in (_Sink.DONE, _Sink.FAILED) or box.msgs

                    ok = box.cond.wait_for(ready, timeout)
                    if sink.state == _Sink.TAKEN:
                        # transport thread is writing into view RIGHT NOW;
                        # wait for it to finish rather than handing a live
                        # buffer back
                        box.cond.wait_for(
                            lambda: sink.state in (_Sink.DONE, _Sink.FAILED), 30.0
                        )
                    if sink.state == _Sink.DONE:
                        box.sinks.remove(sink)
                        return None, True
                    if sink.state == _Sink.FAILED:
                        box.sinks.remove(sink)
                        raise ConnectionError(
                            f"recv failed mid-frame: {name} from {src}"
                        )
                    if sink.state == _Sink.TAKEN:
                        box.sinks.remove(sink)
                        raise TimeoutError(f"recv stuck mid-frame: {name} from {src}")
                    # WAITING: nothing touched the buffer
                    sink.state = _Sink.CANCELLED
                    box.sinks.remove(sink)
                    if not ok:
                        raise TimeoutError(f"recv timeout: {name} from {src}")
                    return box.msgs.popleft(), False
                finally:
                    box.waiters -= 1
                    self._gc_locked(key, box)


class CollectiveEndpoint:
    """Named rendezvous for graph-walk collectives, with zero-copy sink
    delivery when the receiver is already waiting."""

    def __init__(self):
        self._rdv = _Rendezvous()

    def handle(self, src: PeerID, msg: Message) -> None:
        self._rdv.put(src, msg)

    def recv(self, src: PeerID, name: str, timeout: Optional[float] = None) -> Message:
        return self._rdv.get(src, name, timeout)

    def recv_into(
        self, src: PeerID, name: str, view, timeout: Optional[float] = None
    ) -> Tuple[Optional[Message], bool]:
        """(msg, filled) — see _Rendezvous.get_into."""
        return self._rdv.get_into(src, name, view, timeout)

    # transport-side hooks (Server streaming path)
    def take_sink(self, src: PeerID, name: str, nbytes: int):
        return self._rdv.take_sink(src, name, nbytes)

    def finish_sink(self, src: PeerID, name: str, sink, flags: Flags, ok: bool) -> None:
        self._rdv.finish_sink(src, name, sink, flags, ok)


class QueueEndpoint:
    """Named FIFO queues (parity: handler/queue.go)."""

    def __init__(self):
        self._rdv = _Rendezvous()

    def handle(self, src: PeerID, msg: Message) -> None:
        self._rdv.put(src, msg)

    def get(self, src: PeerID, name: str, timeout: Optional[float] = None) -> bytes:
        return self._rdv.get(src, name, timeout).data


class ControlEndpoint:
    """Control messages (cluster updates / exit); parity:
    srcs/go/kungfu/runner/handler.go. The callback runs on the transport
    thread — keep it short."""

    def __init__(self, callback: Callable[[PeerID, Message], None]):
        self._callback = callback

    def handle(self, src: PeerID, msg: Message) -> None:
        self._callback(src, msg)


class P2PEndpoint:
    """Request/response over the blob stores (flat + versioned).

    Parity: srcs/go/rchannel/handler/p2p.go:13-121. A request names a blob,
    optionally with a version selector (``name@#<version>`` or
    ``name@#latest`` on the wire); versioned requests are served from a
    VersionedStore with a bounded GC window, so a reader always gets a
    CONSISTENT published snapshot while the writer publishes the next
    version — the reference's actual consistency contract for
    PairAveraging. Responses come back flagged IS_RESPONSE
    (REQUEST_FAILED when absent).
    """

    VSEP = "@#"  # version selector separator in wire names

    def __init__(self, store, client, self_id: PeerID, vstore=None):
        from kungfu_tpu_torch.store.versioned import VersionedStore

        self.store = store
        self.vstore = vstore if vstore is not None else VersionedStore(window=3)
        self.client = client
        self.self_id = self_id
        self._rdv = _Rendezvous()

    def _lookup(self, wire_name: str) -> Optional[bytes]:
        name, sep, selector = wire_name.partition(self.VSEP)
        if not sep:
            return self.store.get(wire_name)
        if selector == "latest":
            return self.vstore.get_latest(name)
        try:
            return self.vstore.get(int(selector), name)
        except ValueError:
            return None

    def handle(self, src: PeerID, msg: Message) -> None:
        if msg.flags & Flags.IS_RESPONSE:
            self._rdv.put(src, msg)
            return
        # Incoming request: respond OFF the transport read thread. A
        # blocking sendall of a large blob here stops this connection's
        # reads; two peers requesting each other's model simultaneously
        # then deadlock once TCP buffers fill (each side mid-send, nobody
        # reading). Parity: the reference answers requests from worker
        # goroutines while connection readers keep draining.
        from kungfu_tpu_torch.utils.pool import get_pool

        name = msg.name
        get_pool().submit(lambda: self._respond(src, name))

    def _respond(self, src: PeerID, name: str) -> None:
        data = self._lookup(name)
        try:
            if data is None:
                self.client.send(
                    src, name, b"", ConnType.PEER_TO_PEER,
                    Flags.IS_RESPONSE | Flags.REQUEST_FAILED,
                )
            else:
                self.client.send(
                    src, name, data, ConnType.PEER_TO_PEER, Flags.IS_RESPONSE
                )
        except (ConnectionError, OSError):
            # requester vanished (elastic shrink): their retry/timeout
            # handles it; the serving peer must not crash
            pass

    def request(
        self,
        peer: PeerID,
        name: str,
        timeout: float = 30.0,
        version: "Optional[int | str]" = None,
    ) -> Optional[bytes]:
        """Fetch `name` from peer's store; None if the peer doesn't have
        it. version=None targets the flat store; an int (or "latest")
        targets the peer's versioned store."""
        wire = name if version is None else f"{name}{self.VSEP}{version}"
        self.client.send(peer, wire, b"", ConnType.PEER_TO_PEER, Flags.NONE)
        msg = self._rdv.get(peer, wire, timeout)
        if msg.flags & Flags.REQUEST_FAILED:
            return None
        return msg.data

    def save(self, name: str, data: bytes) -> None:
        self.store.put(name, data)

    def save_version(self, version: int, name: str, data: bytes) -> None:
        """Publish an immutable (version, blob); versions beyond the GC
        window (3, parity p2p.go:11) are dropped."""
        self.vstore.put(version, name, data)
