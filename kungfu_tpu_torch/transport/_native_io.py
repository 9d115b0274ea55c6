"""The socket pump (`csrc/host/io_pump.cpp`) bound through the port's host
library.

Port of `kungfu_tpu/transport/_native_io.py`. The pump runs a whole
framed send (writev of header+payload) or an exact n-byte receive in ONE
call that releases the interpreter lock (parity target: the reference's
goroutine byte loops, srcs/go/rchannel/connection/connection.go:90-146).
The reference loads the pump if it can and otherwise falls back to
Python loops over `recv_into` and `sendall`; the port has no such loop.
The pump is built with the host library at first use
(`base/_native.lib()`), and a library that cannot be built raises
RuntimeError at the first send or receive.

Payloads are torch tensors (passed by `data_ptr()` and `nbytes`, never
copied) or any other contiguous buffer (passed through ctypes'
`from_buffer`, which copies only a read-only non-bytes buffer).
"""

from __future__ import annotations

import ctypes
import errno
import os
import socket

import torch

from kungfu_tpu_torch.base import _native


def _timeout_ms(sock: socket.socket) -> int:
    t = sock.gettimeout()
    if t is None:
        return -1  # blocking: the pump polls without deadline
    if t == 0:
        # non-blocking socket: the pump attempts the syscall once and its
        # poll() deadline expires at once on EAGAIN; _check maps that to
        # BlockingIOError, as a non-blocking Python socket would raise
        return 0
    return max(1, int(t * 1000))


def _as_arg(data):
    """(ctypes-passable pointer or buffer object, nbytes) of a payload,
    without copying. The returned object is a foreign-call argument,
    which keeps it (and the memory it references) alive for the call."""
    if isinstance(data, torch.Tensor):
        if data.device.type != "cpu" or not data.is_contiguous():
            raise ValueError("the transport sends contiguous CPU tensors")
        n = data.nbytes
        return (data.data_ptr() if n else None), n
    view = data if isinstance(data, memoryview) else memoryview(data)
    n = view.nbytes
    if n == 0:
        return None, 0
    if not view.readonly:
        return (ctypes.c_char * n).from_buffer(view), n
    # read-only: bytes expose their internal pointer via c_char_p with no
    # copy; any other read-only exporter is copied (rare on these paths)
    obj = view.obj if isinstance(view.obj, bytes) and view.nbytes == len(view.obj) else view.tobytes()
    return ctypes.c_char_p(obj), n


def _check(rc: int, what: str, timeout_ms: int) -> None:
    if rc == 0:
        return
    if rc == -1:
        raise ConnectionError(f"peer closed connection during {what}")
    if rc == -2:
        if timeout_ms == 0:
            # a multi-byte loop on a non-blocking socket: part of a frame
            # may already be on the wire or consumed, so framed callers
            # must treat this like a timeout (fatal for the connection)
            raise BlockingIOError(errno.EAGAIN, f"{what} would block (non-blocking socket)")
        raise socket.timeout(f"timed out during {what}")
    raise OSError(-rc, f"{what}: {os.strerror(-rc)}")


def send2(sock: socket.socket, head: bytes, payload, payload_nbytes: int) -> None:
    """One writev-looped send of [head | payload], lock released."""
    pbuf, pn = _as_arg(payload) if payload_nbytes else (None, 0)
    t_ms = _timeout_ms(sock)
    rc = _native.lib().kf_send2(sock.fileno(), head, len(head), pbuf, pn, t_ms)
    _native._count("send2")
    _check(rc, "send", t_ms)


def recv_exact_into(sock: socket.socket, view) -> None:
    """Receive exactly the buffer's length into the writable `view` (a
    memoryview or a CPU tensor), lock released. On timeout or
    BlockingIOError a PREFIX may already be filled: the stream position
    is lost, so either is fatal for the connection, never retryable."""
    buf, n = _as_arg(view)
    t_ms = _timeout_ms(sock)
    rc = _native.lib().kf_recv_exact(sock.fileno(), buf, n, t_ms)
    _native._count("recv_exact")
    _check(rc, "recv", t_ms)
