"""Host specifications and hostfile parsing.

Port of `kungfu_tpu/plan/hostspec.py` (parity:
srcs/go/plan/hostspec.go:29-55, ``ip:slots[:pub]``, and
srcs/go/plan/hostfile.go). A "slot" is one worker process (one card per
process on a GPU host).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Tuple

from kungfu_tpu_torch.plan.peer import PeerID, PeerList

DEFAULT_PORT_RANGE = (38000, 38999)


@dataclasses.dataclass(frozen=True)
class HostSpec:
    host: str
    slots: int = 1
    public_addr: str = ""

    def __post_init__(self):
        if not self.public_addr:
            object.__setattr__(self, "public_addr", self.host)

    @classmethod
    def parse(cls, s: str) -> "HostSpec":
        parts = s.strip().split(":")
        if not parts or not parts[0]:
            raise ValueError(f"invalid host spec: {s!r}")
        host = parts[0]
        slots = 1
        public = host
        if len(parts) >= 2 and parts[1]:
            if not parts[1].isdigit():
                raise ValueError(f"invalid slot count in host spec: {s!r}")
            slots = int(parts[1])
        if len(parts) >= 3 and parts[2]:
            public = parts[2]
        if len(parts) > 3:
            raise ValueError(f"invalid host spec: {s!r}")
        return cls(host, slots, public)

    def __str__(self) -> str:
        return f"{self.host}:{self.slots}:{self.public_addr or self.host}"


class HostList:
    def __init__(self, specs: Iterable[HostSpec] = ()):
        self._specs: Tuple[HostSpec, ...] = tuple(specs)

    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self) -> Iterator[HostSpec]:
        return iter(self._specs)

    def __getitem__(self, i: int) -> HostSpec:
        return self._specs[i]

    @property
    def total_slots(self) -> int:
        return sum(h.slots for h in self._specs)

    @classmethod
    def parse(cls, s: str) -> "HostList":
        s = s.strip()
        if not s:
            return cls()
        return cls(HostSpec.parse(part) for part in s.split(","))

    def gen_peer_list(self, np: int, port_range: Tuple[int, int] = DEFAULT_PORT_RANGE) -> PeerList:
        """First-fit np workers over hosts in order, ports from port_range.

        Mirrors HostList.GenPeerList (hostspec.go): fill each host up to its
        slot count before moving on.
        """
        if np > self.total_slots:
            raise ValueError(f"requested {np} workers but only {self.total_slots} slots")
        cap = port_range[1] - port_range[0] + 1
        for h in self._specs:
            if h.slots > cap:
                raise ValueError(
                    f"host {h.host} has {h.slots} slots but port range holds {cap}"
                )
        peers: List[PeerID] = []
        for h in self._specs:
            for slot in range(h.slots):
                if len(peers) >= np:
                    return PeerList(peers)
                peers.append(PeerID(h.host, port_range[0] + slot))
        return PeerList(peers)

    def gen_runner_list(self, port: int) -> PeerList:
        """One runner (supervisor) per host on a fixed port."""
        return PeerList(PeerID(h.host, port) for h in self._specs)


def parse_hostfile(text: str) -> HostList:
    """Parse hostfile lines ``host slots=N [public=addr]``; '#' comments."""
    specs = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        fields = line.split()
        host = fields[0]
        slots = 1
        public = ""
        for f in fields[1:]:
            if f.startswith("slots="):
                slots = int(f[len("slots="):])
            elif f.startswith("public="):
                public = f[len("public="):]
            else:
                raise ValueError(f"invalid hostfile field: {f!r}")
        specs.append(HostSpec(host, slots, public or host))
    return HostList(specs)
