"""Peer identity and ordered peer lists.

Port of `kungfu_tpu/plan/peer.py` (parity: srcs/go/plan/id.go and
srcs/go/plan/peerlist.go:11-178, rank/local-rank/host-count/diff/select/
partition-by-host). Hosts are strings (hostnames or IPs). `to_bytes` and
`digest` are byte-equal to the reference's for the same peers.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True, order=True)
class PeerID:
    host: str
    port: int

    def colocated_with(self, other: "PeerID") -> bool:
        return self.host == other.host

    def __str__(self) -> str:
        return f"{self.host}:{self.port}"

    @classmethod
    def parse(cls, s: str) -> "PeerID":
        host, _, port = s.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"invalid peer spec: {s!r}")
        return cls(host, int(port))


class PeerList:
    """Immutable ordered list of PeerIDs; rank == index."""

    def __init__(self, peers: Iterable[PeerID] = ()):
        self._peers: Tuple[PeerID, ...] = tuple(peers)

    def __len__(self) -> int:
        return len(self._peers)

    def __iter__(self) -> Iterator[PeerID]:
        return iter(self._peers)

    def __getitem__(self, i: int) -> PeerID:
        return self._peers[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PeerList) and self._peers == other._peers

    def __hash__(self) -> int:
        return hash(self._peers)

    def __repr__(self) -> str:
        return f"[{len(self)}]{{{','.join(map(str, self))}}}"

    def rank(self, q: PeerID) -> Optional[int]:
        for i, p in enumerate(self._peers):
            if p == q:
                return i
        return None

    def local_rank(self, q: PeerID) -> Optional[int]:
        i = 0
        for p in self._peers:
            if p == q:
                return i
            if p.colocated_with(q):
                i += 1
        return None

    def local_size(self, q: PeerID) -> int:
        return sum(1 for p in self._peers if p.colocated_with(q))

    def host_count(self) -> int:
        return len({p.host for p in self._peers})

    def hosts(self) -> List[str]:
        """Distinct hosts in first-appearance order."""
        seen: Dict[str, None] = {}
        for p in self._peers:
            seen.setdefault(p.host, None)
        return list(seen)

    def select(self, ranks: Sequence[int]) -> "PeerList":
        return PeerList(self._peers[r] for r in ranks)

    def others(self, self_id: PeerID) -> "PeerList":
        return PeerList(p for p in self._peers if p != self_id)

    def on(self, host: str) -> "PeerList":
        return PeerList(p for p in self._peers if p.host == host)

    def contains(self, q: PeerID) -> bool:
        return q in self._peers

    def intersection(self, other: "PeerList") -> "PeerList":
        s = set(other._peers)
        return PeerList(p for p in self._peers if p in s)

    def disjoint(self, other: "PeerList") -> bool:
        return len(self.intersection(other)) == 0

    def diff(self, other: "PeerList") -> Tuple["PeerList", "PeerList"]:
        """Returns (self - other, other - self), order-preserving."""
        a = set(other._peers)
        b = set(self._peers)
        return (
            PeerList(p for p in self._peers if p not in a),
            PeerList(p for p in other._peers if p not in b),
        )

    def partition_by_host(self) -> Tuple[List[int], List[int]]:
        """Group ranks by host; the first rank seen on a host is its master.

        Returns (masters, master_of): masters = ranks of host masters in
        order, master_of[i] = master rank of rank i. master_of is a valid
        forest array (masters are roots).
        """
        masters: List[int] = []
        host_master: Dict[str, int] = {}
        master_of = [0] * len(self._peers)
        for rank, p in enumerate(self._peers):
            if p.host not in host_master:
                host_master[p.host] = rank
                masters.append(rank)
            master_of[rank] = host_master[p.host]
        return masters, master_of

    def to_bytes(self) -> bytes:
        return ";".join(map(str, self._peers)).encode()

    def digest(self) -> bytes:
        return hashlib.blake2b(self.to_bytes(), digest_size=16).digest()

    def to_json(self) -> List[str]:
        return [str(p) for p in self._peers]

    @classmethod
    def from_json(cls, specs: Sequence[str]) -> "PeerList":
        return cls(PeerID.parse(s) for s in specs)

    @classmethod
    def parse(cls, s: str) -> "PeerList":
        s = s.strip()
        if not s:
            return cls()
        return cls(PeerID.parse(part) for part in s.split(","))
