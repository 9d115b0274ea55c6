"""Device-plane bootstrap: one `torch.distributed` world across workers.

Port of `kungfu_tpu/parallel/distributed.py`. Under kfrun a worker learns
its place from the environment the runner sets (`KF_SELF_SPEC`,
`KF_INIT_PEERS`, `KF_DEVICE_SLOTS`; the parsing is a private copy of
`kungfu_tpu/runner/env.py`'s). Rank is this worker's index in the peer
list and size the list's length. Every worker meets at rank 0's host on a
port derived from rank 0's peer spec (20000-29999), which rank 0 checks
is free before it opens the store there. NCCL on the card, gloo on the CPU,
unless the caller names the backend: gloo is the only way two ranks may
share one card, as they must where a host has fewer cards than ranks.
Before NCCL is set up, the ranks trade their card indices through the
rendezvous store, and two ranks of one host on one card raise at once
(NCCL itself would fail only at the first collective). Without kfrun a
process is a world of one and no process group is formed.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
import zlib
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from kungfu_tpu_torch import resolve_device

SELF_SPEC = "KF_SELF_SPEC"
INIT_PEERS = "KF_INIT_PEERS"
DEVICE_SLOTS = "KF_DEVICE_SLOTS"
# 20000-29999: below Linux's default ephemeral range (32768-60999), where
# the kernel hands out ports to outgoing connections, and below kfrun's
# default peer ports (38000-38999)
RENDEZVOUS_PORT_BASE = 20000
RENDEZVOUS_PORT_SPAN = 10000
RENDEZVOUS_TIMEOUT = datetime.timedelta(seconds=300)


def _parse_peer(spec: str) -> Tuple[str, int]:
    host, _, port = spec.strip().rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"invalid peer spec: {spec!r}")
    return host, int(port)


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    self_spec: str
    peers: Tuple[str, ...]
    device_slots: Tuple[int, ...] = ()

    @property
    def rank(self) -> int:
        return self.peers.index(self.self_spec)

    @property
    def size(self) -> int:
        return len(self.peers)

    @property
    def local_rank(self) -> int:
        host = _parse_peer(self.self_spec)[0]
        return [_parse_peer(p)[0] for p in self.peers[:self.rank]].count(host)


def parse_worker_env(environ: Optional[Mapping[str, str]] = None) -> WorkerSpec:
    """This worker's spec from the runner's environment; without
    `KF_SELF_SPEC`, a single-process world."""
    env = os.environ if environ is None else environ
    me = env.get(SELF_SPEC, "")
    if not me:
        return WorkerSpec("127.0.0.1:10000", ("127.0.0.1:10000",))
    _parse_peer(me)
    peers = tuple(p.strip() for p in env.get(INIT_PEERS, me).split(",") if p.strip())
    for p in peers:
        _parse_peer(p)
    if me not in peers:
        raise ValueError(f"{SELF_SPEC}={me!r} is not in {INIT_PEERS}={peers!r}")
    slots = tuple(int(s) for s in env.get(DEVICE_SLOTS, "").split(",") if s.strip())
    return WorkerSpec(me, peers, slots)


def rendezvous_address(spec: WorkerSpec) -> Tuple[str, int]:
    """(host, port) of the store every worker meets at: rank 0's host, a
    port fixed by rank 0's peer spec."""
    host, _ = _parse_peer(spec.peers[0])
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


def initialize_device_plane(device=None, environ: Optional[Mapping[str, str]] = None,
                            backend: Optional[str] = None) -> torch.device:
    """Join this worker's world and return the device it computes on
    (None = its CUDA card). `backend` None means NCCL on the card and gloo
    on the CPU. Idempotent."""
    spec = parse_worker_env(environ)
    device = _pick_device(device, spec)
    if spec.size == 1 or dist.is_initialized():
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    host, port = rendezvous_address(spec)
    if spec.rank == 0:
        check_port_free(host, port)
    store = dist.TCPStore(host, port, spec.size, spec.rank == 0, RENDEZVOUS_TIMEOUT)
    if backend == "nccl":
        store.set(f"kf_card/{spec.rank}", str(device.index))
        me = _parse_peer(spec.self_spec)[0]
        ranks = [r for r, p in enumerate(spec.peers) if _parse_peer(p)[0] == me]
        check_card_sharing(backend, ranks, [int(store.get(f"kf_card/{r}")) for r in ranks])
    dist.init_process_group(backend, store=store, world_size=spec.size, rank=spec.rank)
    return device


def shutdown_device_plane() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


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
