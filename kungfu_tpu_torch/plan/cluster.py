"""Cluster = (runners, workers) membership model with elastic resize.

Port of `kungfu_tpu/plan/cluster.py` (parity: srcs/go/plan/cluster.go —
Validate, Resize, canonical bytes for consensus). The JSON codec matches
the config-server REST contract, and `to_bytes`/`digest` are byte-equal
to the reference's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional

from kungfu_tpu_torch.plan.hostspec import DEFAULT_PORT_RANGE
from kungfu_tpu_torch.plan.peer import PeerID, PeerList


class ClusterError(ValueError):
    pass


@dataclasses.dataclass
class Cluster:
    runners: PeerList
    workers: PeerList

    def validate(self) -> None:
        seen_ports = set()
        runner_hosts = set()
        for r in self.runners:
            if r in seen_ports:
                raise ClusterError(f"duplicated peer: {r}")
            seen_ports.add(r)
            if r.host in runner_hosts:
                raise ClusterError(f"duplicated runner on host: {r.host}")
            runner_hosts.add(r.host)
        for w in self.workers:
            if w in seen_ports:
                raise ClusterError(f"duplicated peer: {w}")
            seen_ports.add(w)
            if w.host not in runner_hosts:
                raise ClusterError(f"worker {w} has no runner on its host")

    def clone(self) -> "Cluster":
        return Cluster(PeerList(self.runners), PeerList(self.workers))

    def _grow_one(self) -> None:
        if len(self.runners) == 0:
            raise ClusterError("no runner in cluster")
        used: Dict[str, int] = {r.host: 0 for r in self.runners}
        for w in self.workers:
            used[w.host] = used.get(w.host, 0) + 1
        host = min((r.host for r in self.runners), key=lambda h: used[h])
        port = 0
        for w in self.workers:
            if w.host == host and port <= w.port:
                port = w.port + 1
        if port == 0:
            port = DEFAULT_PORT_RANGE[0]
        self.workers = PeerList(list(self.workers) + [PeerID(host, port)])

    def resize(self, new_size: int) -> "Cluster":
        d = self.clone()
        if len(d.workers) > new_size:
            d.workers = PeerList(list(d.workers)[:new_size])
        while len(d.workers) < new_size:
            d._grow_one()
        return d

    def to_bytes(self) -> bytes:
        return (self.runners.to_bytes() + b"|" + self.workers.to_bytes())

    def digest(self) -> bytes:
        return hashlib.blake2b(self.to_bytes(), digest_size=16).digest()

    def to_json(self) -> dict:
        return {
            "Runners": self.runners.to_json(),
            "Workers": self.workers.to_json(),
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @classmethod
    def from_json(cls, obj: dict) -> "Cluster":
        return cls(
            runners=PeerList.from_json(obj.get("Runners", [])),
            workers=PeerList.from_json(obj.get("Workers", [])),
        )

    @classmethod
    def loads(cls, s: str) -> "Cluster":
        return cls.from_json(json.loads(s))

    def debug_string(self) -> str:
        return f"[{len(self.workers)}@{len(self.runners)}]{{{self.workers}}}@{{{self.runners}}}"
