"""Named blob stores for peer-to-peer model exchange.

Port of `kungfu_tpu/store/versioned.py`. Capability parity: srcs/go/store/{store,versionedstore,blob}.go — an
RW-locked named blob store plus a VersionedStore with a GC window (the
reference keeps 3 versions, handler/p2p.go:11) backing PairAveraging model
requests.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional


class BlobStore:
    """Flat named blobs (latest value wins)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._blobs: Dict[str, bytes] = {}

    def put(self, name: str, data: bytes) -> None:
        with self._lock:
            self._blobs[name] = bytes(data)

    def get(self, name: str) -> Optional[bytes]:
        with self._lock:
            return self._blobs.get(name)

    def names(self):
        with self._lock:
            return list(self._blobs)


class VersionedStore:
    """Versioned blobs with a bounded GC window.

    put(version, name, data); get(version, name); next_version(name) gives
    the newest version holding `name`. Old versions beyond the window are
    dropped (parity: versionedstore.go:8-94).
    """

    def __init__(self, window: int = 3):
        self._lock = threading.RLock()
        self._window = window
        self._versions: "OrderedDict[int, Dict[str, bytes]]" = OrderedDict()

    def put(self, version: int, name: str, data: bytes) -> None:
        with self._lock:
            if version not in self._versions:
                self._versions[version] = {}
                while len(self._versions) > self._window:
                    self._versions.popitem(last=False)
            self._versions[version][name] = bytes(data)

    def get(self, version: int, name: str) -> Optional[bytes]:
        with self._lock:
            return self._versions.get(version, {}).get(name)

    def latest_version(self, name: str) -> Optional[int]:
        with self._lock:
            for v in reversed(self._versions):
                if name in self._versions[v]:
                    return v
            return None

    def get_latest(self, name: str) -> Optional[bytes]:
        with self._lock:
            v = self.latest_version(name)
            return None if v is None else self._versions[v][name]
