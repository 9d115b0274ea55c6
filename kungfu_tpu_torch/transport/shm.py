"""Shared-memory data plane for colocated peers.

Port of `kungfu_tpu/transport/shm.py`: the arena's file names, header
page, descriptor and ring protocol are the reference's, so a port peer
and a reference peer can share a ring.

A kfrun localhost cluster is N processes on one box, and every socket
byte costs two kernel copies plus backpressure coupling: a large send
blocks the SENDER until the busy receiver drains a ~208 KiB pipe. Large
payloads therefore ride a per-(sender->receiver, conn_type) shared-memory
ring: the sender copies into the arena and completes at once; the tiny
descriptor frame {offset, length, advance} travels over the framed socket
(so ordering, epochs and demux are unchanged); the receiver copies out
(sink path) or hands the mapped region to the collective walk (borrow
path) and releases it after the reduce.

Ring protocol (SPSC by construction: client.send holds the per-connection
lock; one transport thread serves each connection):
  header page: magic u64 | capacity u64 | alloc_seq u64 | consumed_seq u64
  alloc_seq   monotonically counts bytes allocated (incl. wrap padding);
              written only by the sender.
  consumed_seq counts bytes released; written only by the receiver.
  A region never wraps: if the tail can't fit it, the sender pads to the
  boundary and the descriptor's `advance` covers pad + length.
Releases can complete out of order (the n-ary reduce borrows several
regions at once), so the receiver tracks released intervals and advances
consumed_seq only over a contiguous prefix.

Failure posture: a borrow whose consumer never materializes leaves a hole
the releaser cannot advance past; the ring then reports no space and every
later large send degrades to the SOCKET frame — slower, still correct —
until the next reconnect resets both ends.
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
from typing import Dict, Optional

import numpy as np
import torch

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import memory as tmemory

MAGIC = 0x4B46534D454D31  # "KFSMEM1"
HEADER = 4096
_HDR = struct.Struct("<QQQQ")  # magic, capacity, alloc_seq, consumed_seq

DEFAULT_CAPACITY = int(knobs.get("KF_CONFIG_SHM_CAPACITY"))
# payloads below this stay on the socket (descriptor overhead + mmap
# bookkeeping beat the copy savings for small frames)
SHM_MIN_BYTES = int(knobs.get("KF_CONFIG_SHM_MIN_BYTES"))

DESC = struct.Struct("<QQQ")  # offset, length, advance


def enabled() -> bool:
    return knobs.get("KF_CONFIG_SHM") and os.path.isdir("/dev/shm")


class ArenaSpaceError(OSError):
    """tmpfs can't back the arena (ENOSPC at creation). ftruncate alone
    only reserves address space — without an upfront allocation the
    first write into an unbacked page on a full /dev/shm is a SIGBUS
    that kills the worker mid-collective. Raised at creation so the
    sender can degrade to the socket path instead."""


def count_alloc_failure() -> None:
    """Count an arena-allocation failure (its own series, NOT
    kungfu_shm_fallback_total: that counter means "the receiver is
    behind", and a full /dev/shm must not show up in it)."""
    from kungfu_tpu_torch.telemetry import config as _tcfg

    if _tcfg.metrics_enabled():
        from kungfu_tpu_torch.telemetry import metrics as _tm

        _tm.counter(
            "kungfu_shm_alloc_failures_total",
            "Arena allocations refused (tmpfs full); connection degraded "
            "to socket frames",
        ).inc()


def arena_path(
    recv_host: str, recv_port: int, send_host: str, send_port: int, conn_type: int
) -> str:
    return (
        f"/dev/shm/kfshm-{recv_host}-{recv_port}" f"-{send_host}-{send_port}-{conn_type}"
    )


def copy_bytes(dst: memoryview, src) -> None:
    """dst[:] = src's bytes: a tensor by torch's copy, any other buffer by
    numpy's (both release the interpreter lock for large copies)."""
    n = dst.nbytes
    if n == 0:
        return
    if isinstance(src, torch.Tensor):
        torch.frombuffer(dst, dtype=torch.uint8, count=n).copy_(src.reshape(-1).view(torch.uint8))
    else:
        np.copyto(np.frombuffer(dst, np.uint8, n), np.frombuffer(src, np.uint8, n))


class SenderArena:
    """Sender side: creates/resets the file, allocates regions, copies
    payloads in. One instance per (peer connection); serialized by the
    client's per-connection send lock."""

    def __init__(self, path: str, capacity: int = DEFAULT_CAPACITY):
        self.path = path
        self.capacity = capacity
        # ring-vs-socket accounting: a rising fallback share means the
        # receiver is chronically behind; gated once per arena
        self._m_writes = self._m_fallback = None
        from kungfu_tpu_torch.telemetry import config as _tcfg

        if _tcfg.metrics_enabled():
            from kungfu_tpu_torch.telemetry import metrics as _tm

            self._m_writes = _tm.counter(
                "kungfu_shm_writes_total",
                "Payloads delivered via the shared-memory ring",
            )
            self._m_fallback = _tm.counter(
                "kungfu_shm_fallback_total",
                "Ring-full fallbacks to the socket frame path",
            )
        # O_EXCL after unlink: the path is predictable, so opening an
        # existing file could map another local user's pre-planted file
        # (mode 0o600 only applies at creation) — never reuse one
        try:
            os.unlink(path)
        except OSError:
            pass
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, HEADER + capacity)
            # back every page NOW: on a full tmpfs the first store into an
            # unbacked page is a SIGBUS; posix_fallocate turns "tmpfs is
            # full" into an ENOSPC here, which the client degrades to the
            # socket path
            if hasattr(os, "posix_fallocate"):
                try:
                    os.posix_fallocate(fd, 0, HEADER + capacity)
                except OSError as e:
                    raise ArenaSpaceError(
                        e.errno or 0,
                        f"cannot back shm arena {path} "
                        f"({(HEADER + capacity) >> 20} MiB): {e.strerror}",
                    ) from e
            self._mm = mmap.mmap(fd, HEADER + capacity)
        except ArenaSpaceError:
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        finally:
            os.close(fd)
        self._seq = np.frombuffer(self._mm, np.uint64, 2, offset=16)
        # reset for a fresh epoch: receiver maps lazily after connect, so
        # nobody holds live borrows here
        self._mm[0:16] = struct.pack("<QQ", MAGIC, capacity)
        self._seq[0] = 0
        self._seq[1] = 0
        self._data = memoryview(self._mm)[HEADER:]
        self._alloc = 0  # mirrors _seq[0]; plain int avoids u64 churn

        # memory plane: only the bytes written are resident (tmpfs pages are
        # allocated on first touch): the writes' high-water up to the
        # capacity, never the whole mapping
        self._mem_acct = tmemory.register_owner(
            f"shm:{os.path.basename(path)}", "arena", self,
            lambda a: HEADER + min(a._alloc, a.capacity))

    def try_write(self, payload, nbytes: int) -> Optional[bytes]:
        """Copy `payload` into the ring; returns the packed descriptor, or
        None when the ring lacks space RIGHT NOW. Never blocks: spinning
        for ring space on a shared core starves the consumer that would
        free it — a full ring means the receiver is behind, and the socket
        path's kernel flow control is the right way to wait for it."""
        cap = self.capacity
        if nbytes > cap:
            # deliberate routing (the payload can never fit), not
            # backpressure: not a fallback
            return None
        off = self._alloc % cap
        pad = cap - off if off + nbytes > cap else 0
        advance = pad + nbytes
        if self._alloc + advance - int(self._seq[1]) > cap:
            if self._m_fallback is not None:
                self._m_fallback.inc()
            return None
        start = 0 if pad else off
        copy_bytes(self._data[start:start + nbytes], payload)
        self._alloc += advance
        self._seq[0] = self._alloc
        if self._m_writes is not None:
            self._m_writes.inc()
        return DESC.pack(start, nbytes, advance)

    def close(self) -> None:
        if self._mem_acct is not None:
            self._mem_acct.close()
            self._mem_acct = None
        try:
            self._seq = None
            self._data.release()
            self._mm.close()
        except (BufferError, ValueError, OSError):
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class _OrderedReleaser:
    """Advance consumed_seq over the contiguous prefix of released
    [start, start+advance) intervals (borrows finish out of order)."""

    def __init__(self, seq: np.ndarray):
        self._seq = seq  # consumed_seq lives at index 1
        self._lock = threading.Lock()
        self._next = 0  # next expected start_seq to retire
        self._pending: Dict[int, int] = {}  # start_seq -> advance

    def release(self, start_seq: int, advance: int) -> None:
        with self._lock:
            self._pending[start_seq] = advance
            while self._next in self._pending:
                adv = self._pending.pop(self._next)
                self._next += adv
            self._seq[1] = self._next


class ReceiverArena:
    """Receiver side: maps the sender's file, exposes regions, retires
    them in allocation order."""

    def __init__(self, path: str):
        fd = os.open(path, os.O_RDWR)
        try:
            st = os.fstat(fd)
            if st.st_uid != os.getuid():
                raise ValueError(f"shm arena not owned by us: {path}")
            size = st.st_size
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        magic, cap = struct.unpack("<QQ", self._mm[0:16])
        if magic != MAGIC or HEADER + cap != size:
            raise ValueError(f"bad shm arena: {path}")
        self.capacity = cap
        self._seq = np.frombuffer(self._mm, np.uint64, 2, offset=16)
        self._data = memoryview(self._mm)
        self._releaser = _OrderedReleaser(self._seq)
        self._recv_seq = 0  # bytes of (pad+len) seen, in frame order

        # memory plane: as the sender's, only the frames seen are resident
        self._mem_acct = tmemory.register_owner(
            f"shm:{os.path.basename(path)}", "arena", self,
            lambda a: HEADER + min(a._recv_seq, a.capacity))

    def region(self, offset: int, length: int, advance: int):
        """(memoryview of the payload, release() callable). Frames arrive
        in allocation order on the single connection, so _recv_seq
        reconstructs each region's start_seq."""
        start_seq = self._recv_seq  # pad (if any) leads the interval
        self._recv_seq += advance
        view = self._data[HEADER + offset : HEADER + offset + length]
        rel = self._releaser

        def release(_done=[False]) -> None:
            if not _done[0]:
                _done[0] = True
                rel.release(start_seq, advance)

        return view, release

    def close(self) -> None:
        if self._mem_acct is not None:
            self._mem_acct.close()
            self._mem_acct = None
        try:
            self._seq = None
            self._data.release()
            self._mm.close()
        except (BufferError, ValueError, OSError):
            pass
