"""Shaped-link transport harness.

Port of `kungfu_tpu/transport/shaping.py`. ``KF_SHAPE_LINKS`` is a
per-edge latency/bandwidth/jitter shaper (it generalizes the older
``KF_TEST_SLOW_EDGE`` fault injection), so one box can emulate a
multi-host DCN and the measured-topology re-planner has something
measurable to win against.

Grammar (the reference's, entry for entry)::

    KF_SHAPE_LINKS = entry [';' entry]...
    entry          = ['src' '>'] dst '=' param [',' param]...
    param          = 'lat:'    ms        # one-way latency per message
                   | 'bw:'     rate      # token-bucket pacing; rate is
                                         # bytes/sec, with KiB/MiB/GiB
                                         # (optionally 'ps') suffixes
                   | 'jitter:' ms        # deterministic 0..jitter extra

``dst`` (and the optional ``src``) are ``host:port`` peer specs; ``*``
as dst matches every destination (the most specific entry wins: exact
dst beats ``*``). An entry with a ``src`` applies only on the sender
whose peer id matches — in-process multi-peer harnesses match against
each Client's OWN id, not the process env, so one process can host both
ends of an asymmetric shape.

Shared-uplink mode::

    entry = 'uplink:' host '=' 'bw:' rate

models what per-edge buckets cannot: ONE host NIC that every sender on
the host drains together (the contention a two-level plan wins against
is the SHARED uplink). ``host`` is a bare hostname (every sender whose
peer id lives on it pays for sends leaving it) or a ``|``-joined list of
``host:port`` peer specs (the in-process harness form — all listed
peers share one virtual host). The bucket is a file-locked mmap shared
across PROCESSES: tokens drained by any member are gone for all of
them, which is exactly a saturated NIC. Its directory, file name and
16-byte layout are the reference's, so reference and port senders on
one host drain the same bucket.

The delay is applied INSIDE the transport's timed send window while the
per-connection lock is held (the caller does the sleeping): exactly
like a saturated pipe, the shaped edge serializes, the link table's
passive bandwidth estimate converges to the shaped rate and the walk
profiler books the time as send-blocked. Shaping applies to socket
frames only: a colocated peer's shm frames are not shaped, so a shaped
run sets ``KF_CONFIG_SHM=0``.

Jitter is DETERMINISTIC (an LCG over a per-edge message counter, no
RNG): reruns of a shaped run see identical delay sequences, so paired
A/B ratios stay drift-free.
"""

from __future__ import annotations

import hashlib
import mmap
import os
import struct
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

# token-bucket burst: how many bytes may pass unpaced after an idle
# period (seconds of credit at the shaped rate). Small enough that a
# steady collective stream converges to the shaped bandwidth within one
# segment, large enough that control frames don't pay a pacing stall.
BURST_SECONDS = 0.02
BURST_MIN_BYTES = 64 << 10

_RATE_SUFFIX = {
    "kib": 1 << 10, "mib": 1 << 20, "gib": 1 << 30,
    "kb": 1000, "mb": 1000_000, "gb": 1000_000_000,
    "k": 1 << 10, "m": 1 << 20, "g": 1 << 30,
}


def _parse_rate(s: str) -> float:
    """`20MiB`/`5mb`/`1.5G`[ps] → bytes/sec."""
    raw = s.strip().lower()
    if raw.endswith("ps"):
        raw = raw[:-2]
    raw = raw.rstrip("/s")
    for suffix in sorted(_RATE_SUFFIX, key=len, reverse=True):
        if raw.endswith(suffix):
            return float(raw[: -len(suffix)]) * _RATE_SUFFIX[suffix]
    return float(raw)


class EdgeShape:
    """Shape parameters of one directed edge."""

    __slots__ = ("lat_s", "bw_bps", "jitter_s")

    def __init__(self, lat_s: float = 0.0, bw_bps: float = 0.0,
                 jitter_s: float = 0.0):
        self.lat_s = float(lat_s)
        self.bw_bps = float(bw_bps)
        self.jitter_s = float(jitter_s)

    def __repr__(self) -> str:
        return (f"EdgeShape(lat={self.lat_s * 1e3:g}ms, "
                f"bw={self.bw_bps:g}B/s, jitter={self.jitter_s * 1e3:g}ms)")


def _parse_entry(entry: str) -> Optional[Tuple[str, str, EdgeShape]]:
    """One `[src>]dst=params` entry → (src or '', dst, EdgeShape)."""
    edge, sep, params = entry.partition("=")
    if not sep:
        raise ValueError(f"missing '=' in {entry!r}")
    src, _, dst = edge.strip().rpartition(">")
    src, dst = src.strip(), dst.strip()
    if not dst:
        raise ValueError(f"missing destination in {entry!r}")
    shape = EdgeShape()
    for param in params.split(","):
        param = param.strip()
        if not param:
            continue
        key, sep, val = param.partition(":")
        if not sep:
            raise ValueError(f"malformed param {param!r} (want key:value)")
        key = key.strip().lower()
        if key == "lat":
            shape.lat_s = float(val) / 1e3
        elif key == "bw":
            shape.bw_bps = _parse_rate(val)
        elif key == "jitter":
            shape.jitter_s = float(val) / 1e3
        else:
            raise ValueError(f"unknown shape key {key!r} in {entry!r}")
    if shape.lat_s < 0 or shape.bw_bps < 0 or shape.jitter_s < 0:
        raise ValueError(f"negative shape value in {entry!r}")
    if shape.lat_s == 0 and shape.bw_bps == 0 and shape.jitter_s == 0:
        return None  # an all-zero entry shapes nothing
    return src, dst, shape


def parse_spec(spec: str, self_spec: str) -> Dict[str, EdgeShape]:
    """Parse a KF_SHAPE_LINKS spec into {dst: EdgeShape} for THIS sender
    (entries whose src doesn't match ``self_spec`` are dropped; dst may
    be '*'; ``uplink:`` entries belong to :func:`parse_uplinks` and are
    skipped here). Malformed entries raise ValueError — callers decide
    whether to warn-and-skip (env path) or fail (tests)."""
    shapes: Dict[str, EdgeShape] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if entry.split("=", 1)[0].strip().lower().startswith("uplink:"):
            continue
        parsed = _parse_entry(entry)
        if parsed is None:
            continue
        src, dst, shape = parsed
        if src and src != "*" and src != self_spec:
            continue
        shapes[dst] = shape
    return shapes


# ---------------------------------------------------------------------------
# shared-uplink bucket
# ---------------------------------------------------------------------------

class SharedBucket:
    """ONE token bucket shared across processes: a 16-byte mmap'd file
    (tokens f64, last-refill CLOCK_MONOTONIC f64 — machine-wide on
    Linux) with ``flock`` around each read-modify-write. Every sender
    on the shaped host drains the same token pool, so concurrent
    senders CONTEND — the physics per-edge buckets cannot model.

    The read-modify-write happens under the file lock; the computed
    deficit is slept off by the CALLER after release (the LinkShaper
    discipline: never sleep holding a lock). Negative debt is carried,
    same as the per-edge bucket."""

    _FMT = "<dd"
    _SIZE = struct.calcsize(_FMT)

    def __init__(self, path: str, bw_bps: float, clock=time.monotonic):
        self.path = path
        self.bw_bps = float(bw_bps)
        self._clock = clock
        self._burst = max(BURST_MIN_BYTES, self.bw_bps * BURST_SECONDS)
        import fcntl  # POSIX-only, like the rest of the transport

        self._flock = fcntl.flock
        self._ex, self._un = fcntl.LOCK_EX, fcntl.LOCK_UN
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        self._flock(self._fd, self._ex)
        try:
            if os.fstat(self._fd).st_size < self._SIZE:
                # first member in: size the file and seed a full burst
                os.ftruncate(self._fd, self._SIZE)
                os.pwrite(self._fd, struct.pack(
                    self._FMT, self._burst, self._clock()), 0)
        finally:
            self._flock(self._fd, self._un)
        self._map = mmap.mmap(self._fd, self._SIZE)

    def delay(self, nbytes: int) -> float:
        """Seconds the caller must sleep before ``nbytes`` cross the
        shared uplink (0.0 within burst)."""
        self._flock(self._fd, self._ex)
        try:
            tokens, last = struct.unpack(self._FMT, self._map[:self._SIZE])
            now = self._clock()
            # a peer that seeded the file earlier may carry a stale
            # monotonic stamp from before this boot; clamp refill at
            # one full burst so corruption can't mint infinite credit
            tokens = min(self._burst,
                         tokens + max(0.0, now - last) * self.bw_bps)
            tokens -= nbytes
            self._map[:self._SIZE] = struct.pack(self._FMT, tokens, now)
        finally:
            self._flock(self._fd, self._un)
        return -tokens / self.bw_bps if tokens < 0 else 0.0

    def close(self) -> None:
        try:
            self._map.close()
            os.close(self._fd)
        except OSError:
            pass


class Uplink:
    """One shared-uplink shape: the host group it covers + its bucket."""

    __slots__ = ("token", "hostname", "members", "bw_bps", "bucket")

    def __init__(self, token: str, bw_bps: float,
                 bucket: Optional[SharedBucket] = None):
        self.token = token
        self.bw_bps = float(bw_bps)
        if "|" in token:
            self.members: Optional[frozenset] = frozenset(
                m.strip() for m in token.split("|") if m.strip())
            self.hostname = ""
        else:
            self.members = None
            self.hostname = token
        self.bucket = bucket

    def canonical(self) -> str:
        """Order-independent identity — every member process must map
        the same group to the SAME bucket file."""
        group = ("|".join(sorted(self.members))
                 if self.members is not None else self.hostname)
        return f"uplink:{group}=bw:{self.bw_bps:g}"

    def covers_sender(self, self_spec: str) -> bool:
        if self.members is not None:
            return self_spec in self.members
        return self_spec.rsplit(":", 1)[0] == self.hostname

    def crosses(self, dst: str) -> bool:
        """True when a send to ``dst`` LEAVES the host (intra-host
        traffic never touches the NIC)."""
        if self.members is not None:
            return dst not in self.members
        return dst.rsplit(":", 1)[0] != self.hostname


def _parse_uplink_entry(entry: str) -> Tuple[str, float]:
    """`uplink:host=bw:rate` → (host token, bytes/sec)."""
    edge, sep, params = entry.partition("=")
    token = edge.strip()[len("uplink:"):].strip()
    if not sep or not token:
        raise ValueError(f"malformed uplink entry {entry!r} "
                         "(want uplink:host=bw:rate)")
    bw = 0.0
    for param in params.split(","):
        param = param.strip()
        if not param:
            continue
        key, psep, val = param.partition(":")
        if not psep or key.strip().lower() != "bw":
            raise ValueError(
                f"uplink entries shape bandwidth only (bw:rate), got "
                f"{param!r} in {entry!r}")
        bw = _parse_rate(val)
    if bw <= 0:
        raise ValueError(f"uplink entry {entry!r} needs a positive bw:rate")
    return token, bw


def _bucket_dir() -> str:
    from kungfu_tpu_torch import knobs

    d = knobs.raw("KF_TELEMETRY_DIR").strip()
    return d if d else tempfile.gettempdir()


def parse_uplinks(spec: str, self_spec: str,
                  make_bucket: bool = True) -> List[Uplink]:
    """The ``uplink:`` entries of a KF_SHAPE_LINKS spec that cover THIS
    sender, each backed by its cross-process bucket file (named by a
    digest of the canonical group+rate, under KF_TELEMETRY_DIR or the
    system tempdir — every member lands on the same file). Malformed
    entries raise ValueError, like edge entries."""
    ups: List[Uplink] = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if not entry.split("=", 1)[0].strip().lower().startswith("uplink:"):
            continue
        token, bw = _parse_uplink_entry(entry)
        up = Uplink(token, bw)
        if not up.covers_sender(self_spec):
            continue
        if make_bucket:
            digest = hashlib.blake2s(
                up.canonical().encode(), digest_size=8).hexdigest()
            up.bucket = SharedBucket(
                os.path.join(_bucket_dir(), f"kf-uplink-{digest}.bucket"),
                bw)
        ups.append(up)
    return ups


class LinkShaper:
    """Per-destination token-bucket pacer + latency/jitter injector.

    :meth:`delay` computes (under the shaper's own lock — no sleeping
    inside it) how long the CALLER must sleep before a send of
    ``nbytes`` toward ``dst`` so the edge behaves like the shaped link;
    :meth:`latency` is the message-latency-only variant for pings."""

    def __init__(self, shapes: Dict[str, EdgeShape],
                 clock=time.monotonic, uplinks: Tuple[Uplink, ...] = ()):
        self._shapes = dict(shapes)
        self._clock = clock
        self._lock = threading.Lock()
        # per-dst token-bucket state: (tokens, last_refill_ts)
        self._buckets: Dict[str, Tuple[float, float]] = {}
        # per-dst message counter driving the deterministic jitter LCG
        self._counts: Dict[str, int] = {}
        # shared-uplink buckets this sender drains
        self._uplinks = tuple(uplinks)

    def __bool__(self) -> bool:
        return bool(self._shapes or self._uplinks)

    def shape_for(self, dst: str) -> Optional[EdgeShape]:
        """Most specific match: exact dst, else the '*' wildcard."""
        return self._shapes.get(str(dst)) or self._shapes.get("*")

    def _jitter(self, key: str, shape: EdgeShape) -> float:
        """`key` is the counter stream — sends and pings keep SEPARATE
        streams per dst: pings fire on wall-clock schedules, so sharing
        one counter would make the send-side jitter sequence depend on
        ping timing and break the rerun-determinism the module
        guarantees."""
        if shape.jitter_s <= 0:
            return 0.0
        n = self._counts.get(key, 0)
        self._counts[key] = n + 1
        # deterministic LCG over the per-edge message counter: identical
        # across reruns (no RNG — the span-sampler discipline)
        frac = ((n * 1103515245 + 12345) % (1 << 31)) / float(1 << 31)
        return shape.jitter_s * frac

    def delay(self, dst, nbytes: int) -> float:
        """Seconds the caller should sleep before sending ``nbytes`` to
        ``dst`` (0.0 when the edge is unshaped or within its burst)."""
        key = str(dst)
        d = 0.0
        shape = self.shape_for(key)
        if shape is not None:
            with self._lock:
                d = shape.lat_s + self._jitter(key, shape)
                if shape.bw_bps > 0:
                    now = self._clock()
                    burst = max(BURST_MIN_BYTES,
                                shape.bw_bps * BURST_SECONDS)
                    tokens, last = self._buckets.get(key, (burst, now))
                    tokens = min(burst, tokens + (now - last) * shape.bw_bps)
                    tokens -= nbytes
                    if tokens < 0:
                        # the caller sleeps the deficit off; KEEP the
                        # debt negative — the sleep period's refill
                        # (next call's elapsed-time credit) pays it
                        # back, so clamping to zero here would
                        # double-credit the sleep and pace ~30% above
                        # the shaped rate
                        d += -tokens / shape.bw_bps
                    self._buckets[key] = (tokens, now)
        # shared uplink: sends LEAVING the host also drain
        # the host's one bucket — outside self._lock, the bucket holds
        # its own cross-process file lock
        for up in self._uplinks:
            if up.bucket is not None and up.crosses(key):
                d += up.bucket.delay(nbytes)
        return d

    def close(self) -> None:
        """Release the shared-uplink bucket files' maps and descriptors
        (the port's client re-reads the shape at every cluster epoch)."""
        for up in self._uplinks:
            if up.bucket is not None:
                up.bucket.close()

    def latency(self, dst) -> float:
        """Latency+jitter only (ping-sized traffic never pays pacing)."""
        key = str(dst)
        shape = self.shape_for(key)
        if shape is None:
            return 0.0
        with self._lock:
            return shape.lat_s + self._jitter("ping:" + key, shape)


def _slow_edge_as_spec(raw: str) -> str:
    """Translate the DEPRECATED KF_TEST_SLOW_EDGE `[src>]dst=ms` into a
    KF_SHAPE_LINKS entry `[src>]dst=lat:ms`."""
    edge, sep, ms = raw.rpartition("=")
    if not sep or not edge.strip():
        raise ValueError(raw)
    float(ms)  # malformed delay must raise here, not parse as a shape key
    return f"{edge.strip()}=lat:{ms.strip()}"


def from_env(self_spec: str) -> Optional[LinkShaper]:
    """Build the process shaper from KF_SHAPE_LINKS (+ the deprecated
    KF_TEST_SLOW_EDGE alias, which warns but keeps injecting — a stale
    e2e env must not silently become 'no delay'). None when unshaped.
    Malformed specs warn and shape nothing rather than killing the
    worker — but loudly, so a typo'd harness doesn't surface as an
    unexplained timeout two minutes later."""
    from kungfu_tpu_torch import knobs
    from kungfu_tpu_torch.telemetry import log

    spec = knobs.raw("KF_SHAPE_LINKS").strip()
    legacy = knobs.raw("KF_TEST_SLOW_EDGE").strip()
    if legacy:
        try:
            legacy_entry = _slow_edge_as_spec(legacy)
        except ValueError:
            log.warn(
                "KF_TEST_SLOW_EDGE: malformed value %r (want `[src>]dst"
                "=ms`) — no edge delay injected", legacy,
            )
        else:
            dst = legacy_entry.partition("=")[0].rpartition(">")[2].strip()
            host, _, port = dst.rpartition(":")
            if not host or not port.isdigit():
                # the spec names a HOST, not a host:port peer — a
                # per-edge delay keyed on it will never match a real
                # destination; the whole-host intent is the shared
                # uplink's job
                log.warn(
                    "KF_TEST_SLOW_EDGE: %r names a host, not a "
                    "host:port peer — the delay will match nothing. "
                    "To shape a whole host's uplink use KF_SHAPE_LINKS"
                    "=uplink:%s=bw:<rate>", legacy, dst,
                )
            log.warn(
                "KF_TEST_SLOW_EDGE is deprecated — use KF_SHAPE_LINKS="
                "%r", legacy_entry,
            )
            # legacy entries go FIRST: parse_spec is last-wins per dst,
            # so an explicit KF_SHAPE_LINKS entry for the same
            # destination overrides a stale alias, not the other way
            # around
            spec = f"{legacy_entry};{spec}" if spec else legacy_entry
    if not spec:
        return None
    try:
        shapes = parse_spec(spec, self_spec)
        uplinks = parse_uplinks(spec, self_spec)
    except ValueError as e:
        log.warn(
            "KF_SHAPE_LINKS: malformed spec (%s) — NO link shaping "
            "injected; fix the spec (`[src>]dst=lat:ms,bw:rate,"
            "jitter:ms; uplink:host=bw:rate; ...`)", e,
        )
        return None
    if not shapes and not uplinks:
        return None
    return LinkShaper(shapes, uplinks=tuple(uplinks))
