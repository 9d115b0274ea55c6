"""Device-plane bootstrap: one `torch.distributed` world across workers.

Port of `kungfu_tpu/parallel/distributed.py`. Under kfrun a worker learns
its place from the environment the runner sets (`KF_SELF_SPEC`,
`KF_INIT_PEERS`, `KF_DEVICE_SLOTS`, read through the port's `knobs` and
parsed by `plan.peer`, as `kungfu_tpu/runner/env.py` does). Rank is this
worker's index in the peer list and size the list's length. Every worker
meets at rank 0's host on a port derived from rank 0's peer spec
(20000-29999), which rank 0 checks is free before it opens the store
there. NCCL on the card, gloo on the CPU,
unless the caller names the backend: gloo is the only way two ranks may
share one card, as they must where a host has fewer cards than ranks.
Before NCCL is set up, the ranks trade their card indices through the
rendezvous store, and two ranks of one host on one card raise at once
(NCCL itself would fail only at the first collective). Without kfrun a
process is a world of one and no process group is formed.

When this process runs a host-plane `Peer` (kfrun's workers call
`peer.get_default_peer()`), the world forms over the peer's session
instead, as the reference bootstraps its device plane: rank 0 picks a
free port, the address travels by `broadcast_bytes` under
`kungfu::devplane:v<cluster version>`, and every worker joins with its
host-plane rank. A new cluster version forms a new world
(`reinitialize_device_plane`), which the derived port could not: two
versions of one peer list would meet on the same port.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket
import threading
import time
import zlib
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from kungfu_tpu_torch import knobs, resolve_device
from kungfu_tpu_torch.plan.peer import PeerID, PeerList

# 20000-29999: below Linux's default ephemeral range (32768-60999), where
# the kernel hands out ports to outgoing connections, and below kfrun's
# default peer ports (38000-38999)
RENDEZVOUS_PORT_BASE = 20000
RENDEZVOUS_PORT_SPAN = 10000
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)

_state = {"initialized": False, "version": -1}
_lock = threading.RLock()


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """This worker's peer spec, the world's in rank order (`host:port`
    strings), and the cards it may open."""

    self_spec: str
    peers: Tuple[str, ...]
    device_slots: Tuple[int, ...] = ()

    @property
    def self_id(self) -> PeerID:
        return PeerID.parse(self.self_spec)

    @property
    def peer_list(self) -> PeerList:
        return PeerList.from_json(self.peers)

    @property
    def rank(self) -> int:
        return self.peers.index(self.self_spec)

    @property
    def size(self) -> int:
        return len(self.peers)

    @property
    def local_rank(self) -> int:
        return self.peer_list.local_rank(self.self_id)


def parse_worker_env(environ: Optional[Mapping[str, str]] = None) -> WorkerSpec:
    """This worker's spec from the runner's environment (`os.environ`
    unless `environ` is given); without `KF_SELF_SPEC`, a single-process
    world."""
    me = knobs.get("KF_SELF_SPEC", environ)
    if not me:
        return WorkerSpec("127.0.0.1:10000", ("127.0.0.1:10000",))
    self_id = PeerID.parse(me)
    peers = PeerList.parse(knobs.get("KF_INIT_PEERS", environ) or me)
    if not peers.contains(self_id):
        raise ValueError(f"KF_SELF_SPEC={me!r} is not in KF_INIT_PEERS={peers.to_json()!r}")
    slots = tuple(int(s) for s in knobs.get("KF_DEVICE_SLOTS", environ))
    return WorkerSpec(str(self_id), tuple(peers.to_json()), slots)


def rendezvous_address(spec: WorkerSpec) -> Tuple[str, int]:
    """(host, port) of the store every worker meets at: rank 0's host, a
    port fixed by rank 0's peer spec."""
    host = PeerID.parse(spec.peers[0]).host
    return host, RENDEZVOUS_PORT_BASE + zlib.crc32(spec.peers[0].encode()) % RENDEZVOUS_PORT_SPAN


def check_port_free(host: str, port: int) -> None:
    """Raise RuntimeError naming `port` if it cannot be bound on `host`
    (another process holds it); rank 0 calls this before it opens the
    rendezvous store there."""
    with socket.socket() as s:
        # as the store binds: a port left in TIME_WAIT by an earlier world is
        # free, one that another socket listens on is not
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
        except OSError as e:
            raise RuntimeError(
                f"the device plane's rendezvous port {port} on {host} is taken "
                f"({e.strerror}); it is derived from rank 0's peer spec: give rank 0 "
                "another port") from None


def _pick_device(device, spec: WorkerSpec) -> torch.device:
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    if device.index is None or spec.size > 1:
        if spec.device_slots:
            device = torch.device("cuda", spec.device_slots[0])
        elif spec.size > 1:
            device = torch.device("cuda", spec.local_rank % torch.cuda.device_count())
        else:
            device = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(device)
    return device


def check_card_sharing(backend: str, ranks: Sequence[int], cards: Sequence[int]) -> None:
    """Raise ValueError if NCCL would put two of `ranks` (the ranks of one
    host) on one card; `cards[i]` is the card index of `ranks[i]`."""
    if backend != "nccl":
        return
    first = {}
    for rank, card in zip(ranks, cards):
        if card in first:
            raise ValueError(
                f"ranks {first[card]} and {rank} are both on card cuda:{card} of one "
                "host; NCCL needs a card per rank: give each rank its own card "
                "(KF_DEVICE_SLOTS) or pass backend='gloo'")
        first[card] = rank


def _free_port(host: str) -> int:
    """A port the kernel calls free on `host`, reserved by binding 0, and
    not one of kfrun's worker ports (38000-38999), which a joiner may be
    given later."""
    socks = []
    try:
        while True:
            s = socket.socket()
            socks.append(s)
            s.bind(("127.0.0.1" if host == "localhost" else host, 0))
            port = s.getsockname()[1]
            if not 38000 <= port < 39000:
                return port
    finally:
        for s in socks:
            s.close()


def _join(spec: WorkerSpec, device: torch.device, backend: Optional[str], host: str,
          port: int) -> None:
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    store = dist.TCPStore(host, port, spec.size, spec.rank == 0, RENDEZVOUS_TIMEOUT)
    if backend == "nccl":
        store.set(f"kf_card/{spec.rank}", str(device.index))
        me = spec.self_id
        ranks = [r for r, p in enumerate(spec.peer_list) if p.colocated_with(me)]
        cards = [int(store.get(f"kf_card/{r}")) for r in ranks]
        # rank 0 serves the store: it waits until every rank has read the
        # cards, or a refused rank 0 could close the store under a rank
        # still reading, which then meets a closed connection, not the
        # refusal
        store.set(f"kf_card_read/{spec.rank}", "1")
        if spec.rank == 0:
            store.wait([f"kf_card_read/{r}" for r in range(spec.size)], RENDEZVOUS_TIMEOUT)
        check_card_sharing(backend, ranks, cards)
    dist.init_process_group(backend, store=store, world_size=spec.size, rank=spec.rank)


def initialize_device_plane(device=None, environ: Optional[Mapping[str, str]] = None,
                            backend: Optional[str] = None, peer=None) -> torch.device:
    """Join this worker's world and return the device it computes on
    (None = its CUDA card). `backend` None means NCCL on the card and gloo
    on the CPU. `peer` is the host-plane Peer whose session carries the
    bootstrap (default: the process's running default peer, if any);
    without one the world meets on the port derived from rank 0's spec.
    Idempotent."""
    if peer is None:
        from kungfu_tpu_torch.peer import running_default_peer

        peer = running_default_peer()
    with _lock:
        if peer is None:
            spec = parse_worker_env(environ)
            device = _pick_device(device, spec)
            if spec.size == 1 or dist.is_initialized():
                _state["initialized"] = True
                return device
            host, port = rendezvous_address(spec)
            if spec.rank == 0:
                check_port_free(host, port)
            _join(spec, device, backend, host, port)
            _state["initialized"] = True
            return device
        sess = peer.current_session()
        spec = WorkerSpec(str(peer.self_id), tuple(sess.peers.to_json()),
                          tuple(peer.config.device_slots))
        device = _pick_device(device, spec)
        if _state["initialized"] or dist.is_initialized():
            return device
        if spec.size == 1:  # a world of one: local devices only
            _state["initialized"] = True
            _state["version"] = peer.cluster_version
            return device
        addr = f"{peer.self_id.host}:{_free_port(peer.self_id.host)}" if sess.rank == 0 else ""
        addr = sess.broadcast_bytes(addr.encode(),
                                    f"kungfu::devplane:v{peer.cluster_version}").decode()
        host, _, port = addr.rpartition(":")
        _join(spec, device, backend, host, int(port))
        _state["initialized"] = True
        _state["version"] = peer.cluster_version
        return device


def device_plane_initialized() -> bool:
    return _state["initialized"]


def current_device_plane_version() -> int:
    """The cluster version the device plane's world was formed at over a
    Peer's session; -1 when it formed without one, or has not."""
    return _state["version"]


def shutdown_device_plane() -> None:
    with _lock:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        _state["initialized"] = False
        _state["version"] = -1


def reinitialize_device_plane(device=None, backend: Optional[str] = None,
                              peer=None) -> torch.device:
    """Delta-mode elastic rebuild: the peer's new session -> a new world
    (parity: NCCL ReInit per new cluster version,
    nccl/controller.hpp:14-44). The caller drops what it holds of the old
    world's groups first."""
    with _lock:
        shutdown_device_plane()
        return initialize_device_plane(device, backend=backend, peer=peer)


def spawn_world(worker, n: int, deadline_s: float, args=()) -> None:
    """Run `worker(rank, peers, *args)` in n spawned processes, `peers`
    the n "127.0.0.1:<free port>" specs a worker hands to
    `initialize_device_plane` as KF_SELF_SPEC and KF_INIT_PEERS. Raises
    if a process fails (its exception) or the world does not finish in
    `deadline_s` (RuntimeError); kills whatever is left either way."""
    import torch.multiprocessing as mp

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    finally:
        for s in socks:
            s.close()
    ctx = mp.start_processes(worker, args=(peers, *args), nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the world of {n} processes did not finish in {deadline_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
