"""Embedded runner API: launch a single-machine multi-process cluster
from Python, plus the failure-monitor signal helpers.

Port of `kungfu_tpu/cmd.py`. Capability parity:
srcs/python/kungfu/cmd/__init__.py —
``launch_multiprocess(f, np)`` (cmd/__init__.py:45-49) and the
``monitor_batch_begin/end`` / ``monitor_epoch_end`` / ``monitor_train_end``
signal functions (:18-31) that feed the -auto-recover heartbeat monitor.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, List

from kungfu_tpu_torch.runner.monitored import send_heartbeat


def _reserve_ports(n: int) -> List[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _run_worker(f: Callable[[int], None], rank: int, env: dict) -> None:
    os.environ.update(env)
    f(rank)
    # deterministic teardown before the process exits (atexit also covers
    # it, but multiprocessing's exit path is less forgiving)
    from kungfu_tpu_torch.peer import finalize_default_peer

    finalize_default_peer()


def launch_multiprocess(f: Callable[[int], None], np_: int) -> None:
    """Run ``f(rank)`` in ``np_`` local worker processes wired into one
    host-plane cluster (parity: launch_multiprocess). Inside ``f`` the
    normal API works: ``kungfu_tpu_torch.api.current_rank()``, collectives,
    optimizers. Raises RuntimeError if any worker exits nonzero."""
    import multiprocessing as mp

    from kungfu_tpu_torch.plan.peer import PeerID, PeerList
    from kungfu_tpu_torch.runner import env as kfenv

    peers = PeerList(
        [PeerID("127.0.0.1", p) for p in _reserve_ports(np_)]
    )
    envs = [
        kfenv.worker_env(
            self_id=peers[r],
            peers=peers,
            runners=PeerList(),
            parent=None,
        )
        for r in range(np_)
    ]
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_run_worker, args=(f, r, envs[r]), daemon=False)
        for r in range(np_)
    ]
    for p in procs:
        p.start()
    for p in procs:
        # the workers are the foreground job: the launcher blocks for
        # their whole training run, and Ctrl-C interrupts the join
        p.join()
    bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"launch_multiprocess: workers failed: {bad}")


def monitor_batch_begin(rank: int = -1) -> None:
    """Heartbeat: a batch started (parity: monitor_batch_begin)."""
    send_heartbeat("begin", _rank(rank))


def monitor_batch_end(rank: int = -1) -> None:
    send_heartbeat("end", _rank(rank))


def monitor_epoch_end(rank: int = -1) -> None:
    send_heartbeat("epoch", _rank(rank))


def monitor_train_end(rank: int = -1) -> None:
    send_heartbeat("trainend", _rank(rank))


def _rank(rank: int) -> int:
    if rank >= 0:
        return rank
    try:
        from kungfu_tpu_torch import api

        return api.current_rank()
    # heartbeats are best-effort: outside a cluster api.current_rank()
    # has no peer and rank 0 is the contract
    except Exception:  # noqa: BLE001
        return 0
