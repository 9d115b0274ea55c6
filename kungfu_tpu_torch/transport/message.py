"""Wire protocol: framed named messages over TCP/Unix sockets.

Port of `kungfu_tpu/transport/message.py` (parity:
srcs/go/rchannel/connection/message.go — a connection header {type,
source identity} + token ack; messages are {name}{flags}{payload} frames;
connection types demux to different handlers). The bytes on the wire are
the reference's, so a port peer and a reference peer talk to each other.

Every framed send and exact receive runs through the socket pump
(`_native_io`, `csrc/host/io_pump.cpp`): the port has no Python loop
over `recv_into`/`sendall` to fall back to.
"""

from __future__ import annotations

import dataclasses
import enum
import socket
import struct
from typing import Tuple

import torch

from kungfu_tpu_torch.transport import _native_io as _nio

MAGIC = 0x4B465450  # "KFTP"


class ConnType(enum.IntEnum):
    PING = 0
    CONTROL = 1
    COLLECTIVE = 2
    PEER_TO_PEER = 3
    QUEUE = 4


class Flags(enum.IntFlag):
    NONE = 0
    WAIT_RECV_BUF = 1  # receiver must deliver into a registered buffer
    IS_RESPONSE = 2
    REQUEST_FAILED = 4
    SHM_REF = 8  # payload is a {offset,len,advance} shm-arena descriptor


@dataclasses.dataclass
class Message:
    name: str
    data: "bytes | bytearray | memoryview | torch.Tensor"  # any contiguous buffer
    flags: Flags = Flags.NONE
    # borrow protocol: set when `data` is a mapped shm region owned by the
    # ring — the consumer MUST call it exactly once when done with `data`
    release: "object" = None


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

_HEADER = struct.Struct("<IBHI")  # magic, conn_type, src_port, token
_FRAME = struct.Struct("<III")  # name_len, flags, data_len


def _recv_exact_into(sock: socket.socket, view) -> None:
    _nio.recv_exact_into(sock, view)


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    # bytearray, not bytes: spares the final copy, and torch.frombuffer
    # views it writable
    buf = bytearray(n)
    if n:
        _nio.recv_exact_into(sock, memoryview(buf))
    return buf


def _send_all(sock: socket.socket, data: bytes) -> None:
    _nio.send2(sock, data, None, 0)


def send_header(sock: socket.socket, conn_type: ConnType, src_host: str, src_port: int, token: int) -> None:
    host_b = src_host.encode()
    _send_all(sock, _HEADER.pack(MAGIC, int(conn_type), src_port, token)
              + struct.pack("<H", len(host_b)) + host_b)


def recv_header(sock: socket.socket):
    """Returns (conn_type, src_host, src_port, token)."""
    magic, conn_type, src_port, token = _HEADER.unpack(_recv_exact(sock, _HEADER.size))
    if magic != MAGIC:
        raise ConnectionError(f"bad magic: {magic:#x}")
    (host_len,) = struct.unpack("<H", _recv_exact(sock, 2))
    host = _recv_exact(sock, host_len).decode()
    return ConnType(conn_type), host, src_port, token


def send_ack(sock: socket.socket, token: int) -> None:
    _send_all(sock, struct.pack("<I", token))


def recv_ack(sock: socket.socket) -> int:
    (token,) = struct.unpack("<I", _recv_exact(sock, 4))
    return token


def send_message(sock: socket.socket, msg: Message) -> None:
    """Frame header + name and the payload in one writev loop; the
    payload is never copied (a tensor goes by its data pointer)."""
    name_b = msg.name.encode()
    data_len = nbytes_of(msg.data)
    head = _FRAME.pack(len(name_b), int(msg.flags), data_len) + name_b
    _nio.send2(sock, head, msg.data, data_len)


def nbytes_of(data) -> int:
    """Byte length of any buffer (len() of a typed memoryview counts
    elements, not bytes; a tensor's is its `nbytes`)."""
    if isinstance(data, (memoryview, torch.Tensor)):
        return data.nbytes
    return len(data)


def recv_frame_header(sock: socket.socket) -> Tuple[str, Flags, int]:
    """Read frame header + name, leaving the payload unread on the socket
    so the caller can deliver it straight into a registered buffer."""
    name_len, flags, data_len = _FRAME.unpack(_recv_exact(sock, _FRAME.size))
    name = _recv_exact(sock, name_len).decode()
    return name, Flags(flags), data_len


def recv_message(sock: socket.socket) -> Message:
    name, flags, data_len = recv_frame_header(sock)
    data = _recv_exact(sock, data_len) if data_len else b""
    return Message(name=name, data=data, flags=flags)
