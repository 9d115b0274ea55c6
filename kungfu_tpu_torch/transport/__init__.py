"""The host plane's transport: framed named messages between peers over
TCP/Unix sockets, large same-host payloads through shared-memory rings.
Port of `kungfu_tpu/transport/`."""

from kungfu_tpu_torch.transport.client import Client
from kungfu_tpu_torch.transport.message import ConnType, Flags, Message
from kungfu_tpu_torch.transport.server import Server

__all__ = ["Client", "ConnType", "Flags", "Message", "Server"]
