"""Durable flight recorder + crash forensics.

Port of `kungfu_tpu/telemetry/flight.py`; the file formats (the journal's
frames, ``meta.json``, ``postmortems.jsonl``) are the reference's byte for
byte, so each package reads the other's journals and harvests the other's
run dirs. Every telemetry surface built so far (metrics registry, span ring,
audit log, structured log) lives in process memory and dies with the
worker — at exactly the moment ``recover_from_failure`` needs to know
*why* it died. This module is the black box:

- **Journal**: a crash-safe, append-only on-disk file of length-prefixed
  CRC-framed JSON records under ``KF_TELEMETRY_DIR`` (default
  ``<tempdir>/kungfu-telemetry/<run-id>/<peer>/``). Appends are a single
  buffered write + flush, so a SIGKILL can at worst truncate the final
  record — the reader yields every complete record and stops at the
  first torn/corrupt frame instead of failing.
- **FlightRecorder**: periodically checkpoints the metrics registry,
  recent/open trace spans, audit events and the structured-log tail;
  enables ``faulthandler`` into a dedicated per-worker file; registers
  atexit + SIGTERM flush; dumps on demand on SIGUSR2.
- **Harvesting**: the runner-side :func:`harvest_postmortem` reads a
  dead worker's journal + faulthandler file and synthesizes a
  postmortem dict (exit code/signal, last step, final audit events,
  open spans at death, tracebacks, output tail);
  :func:`render_postmortem` turns it into the human-readable death
  timeline behind the ``info postmortem`` view.

The journal is size-bounded: when it exceeds ``KF_FLIGHT_MAX_BYTES``
it rotates to ``journal.prev.bin`` (one generation), so a long run costs
at most ~2x the cap per worker. Snapshots are bounded staleness by
design — a SIGKILL loses at most the last ``KF_FLIGHT_INTERVAL``
seconds, which is the flight-recorder contract, not a bug.

Every snapshot carries the resource plane's CPU attribution and the
memory plane's RSS decomposition (``resources``, ``memory``); the
postmortem renders both, and :func:`oom_suspected` reads the final
memory document for its verdict.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import socket
import struct
import sys
import tempfile
import threading
import time
import zlib
from typing import List, Optional, Tuple

from kungfu_tpu_torch import knobs
from kungfu_tpu_torch.telemetry import audit, config, decisions, log, metrics, steptrace, tracing
from kungfu_tpu_torch.telemetry.config import env_truthy, truthy

DIR_ENV = "KF_TELEMETRY_DIR"
FLIGHT_ENV = "KF_FLIGHT"  # explicit on/off override
INTERVAL_ENV = "KF_FLIGHT_INTERVAL"
FSYNC_ENV = "KF_FLIGHT_FSYNC"
MAX_BYTES_ENV = "KF_FLIGHT_MAX_BYTES"

DEFAULT_BASE = os.path.join(tempfile.gettempdir(), "kungfu-telemetry")
DEFAULT_INTERVAL = 5.0
DEFAULT_MAX_BYTES = 8 * 1024 * 1024

JOURNAL_NAME = "journal.bin"
JOURNAL_PREV_NAME = "journal.prev.bin"
FAULT_NAME = "faulthandler.log"
META_NAME = "meta.json"
POSTMORTEM_NAME = "postmortems.jsonl"

MAGIC = b"KFJ1"  # journal file header
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)

# journaled snapshot bounds: a record must stay cheap to write every
# few seconds AND cheap to read back in bulk
SPAN_TAIL = 48
AUDIT_TAIL = 32
LOG_TAIL = 60
DECISION_TAIL = 8


def _env_float(name: str, default: float) -> float:
    """Declared float knob, floored at the built-in default when the
    configured value is non-positive (a zero snapshot interval or
    journal bound would mean a busy loop / instant rotation)."""
    v = float(knobs.get(name))
    return v if v > 0 else default


def sanitize_label(label: str) -> str:
    """A peer label ("host:port") as a safe single path component."""
    out = "".join(c if c.isalnum() or c in "._-" else "_" for c in str(label))
    return out or "peer"


def default_run_dir() -> str:
    """A fresh per-run directory under the default base (the runner
    mints one and injects it as KF_TELEMETRY_DIR into every worker)."""
    run_id = f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
    return os.path.join(DEFAULT_BASE, run_id)


def peer_dir(run_dir: str, peer: str) -> str:
    return os.path.join(run_dir, sanitize_label(peer))


def prune_runs(base: str = DEFAULT_BASE, keep: int = 32) -> int:
    """Drop the oldest run dirs under the DEFAULT base so unattended CI
    or dev loops don't grow /tmp forever. Only ever called with the
    default base; an operator-chosen KF_TELEMETRY_DIR is never touched."""
    import shutil

    try:
        runs = sorted(
            (e for e in os.scandir(base) if e.is_dir()),
            key=lambda e: e.stat().st_mtime,
        )
    except OSError:
        return 0
    doomed = runs[: max(0, len(runs) - keep)]
    n = 0
    for e in doomed:
        try:
            shutil.rmtree(e.path)
            n += 1
        except OSError:
            pass
    return n


# ---------------------------------------------------------------------------
# journal format
# ---------------------------------------------------------------------------


class JournalWriter:
    """Append-only CRC-framed record file. Thread-safe; every append is
    one buffered write + flush so a dying process tears at most the
    final frame."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = (
            max_bytes
            if max_bytes is not None
            else int(_env_float(MAX_BYTES_ENV, DEFAULT_MAX_BYTES))
        )
        self.fsync = env_truthy(FSYNC_ENV)
        self._lock = threading.Lock()
        self._f = None
        self._open()

    def _open(self) -> None:
        fresh = not os.path.exists(self.path) or os.path.getsize(self.path) == 0
        self._f = open(self.path, "ab")
        if fresh:
            self._f.write(MAGIC)
            self._f.flush()

    def append(self, record: dict) -> None:
        payload = json.dumps(record, separators=(",", ":")).encode()
        frame = _FRAME.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._f is None:
                return
            if self._f.tell() + len(frame) > self.max_bytes:
                self._rotate()
            self._f.write(frame)
            self._f.flush()
            if self.fsync:
                try:
                    os.fsync(self._f.fileno())
                except OSError:
                    pass

    def _rotate(self) -> None:
        # one prev generation: bounded disk, and the reader still sees
        # a long history across the rotation boundary
        self._f.close()
        try:
            os.replace(self.path, _prev_path(self.path))
        except OSError:
            pass
        self._f = None
        self._open()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    pass
                self._f = None


def _prev_path(path: str) -> str:
    return os.path.join(os.path.dirname(path), JOURNAL_PREV_NAME)


def read_journal_file(path: str) -> Tuple[List[dict], Optional[str]]:
    """All complete records of one journal file, tolerantly: a
    truncated or corrupt tail frame ends the read (returning everything
    before it) instead of raising. Returns (records, error) where error
    describes why reading stopped early, or None for a clean EOF."""
    records: List[dict] = []
    try:
        f = open(path, "rb")
    except OSError as e:
        return records, str(e)
    with f:
        head = f.read(len(MAGIC))
        if head != MAGIC:
            return records, f"bad journal magic {head!r}"
        while True:
            hdr = f.read(_FRAME.size)
            if not hdr:
                return records, None  # clean EOF
            if len(hdr) < _FRAME.size:
                return records, "truncated frame header"
            length, crc = _FRAME.unpack(hdr)
            payload = f.read(length)
            if len(payload) < length:
                return records, "truncated record payload"
            if zlib.crc32(payload) != crc:
                # after a CRC mismatch the length framing itself is
                # untrusted: stop, keep everything complete before it
                return records, "CRC mismatch"
            try:
                records.append(json.loads(payload.decode()))
            except ValueError:
                return records, "undecodable record"


def read_journal(dir_or_file: str) -> Tuple[List[dict], List[str]]:
    """Records of one peer's journal (prev generation first), with a
    list of non-fatal read errors."""
    if os.path.isdir(dir_or_file):
        paths = [
            os.path.join(dir_or_file, JOURNAL_PREV_NAME),
            os.path.join(dir_or_file, JOURNAL_NAME),
        ]
    else:
        paths = [dir_or_file]
    records: List[dict] = []
    errors: List[str] = []
    for p in paths:
        if not os.path.exists(p):
            continue
        recs, err = read_journal_file(p)
        records.extend(recs)
        if err is not None:
            errors.append(f"{os.path.basename(p)}: {err}")
    return records, errors


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """One per worker process: journals periodic telemetry snapshots and
    terminal events into its peer directory."""

    def __init__(
        self,
        directory: str,
        peer: str = "",
        interval: Optional[float] = None,
        enable_faulthandler: bool = True,
        install_signal_handlers: bool = True,
    ):
        self.dir = directory
        self.peer = str(peer)
        self.interval = (
            interval
            if interval is not None
            else _env_float(INTERVAL_ENV, DEFAULT_INTERVAL)
        )
        os.makedirs(self.dir, exist_ok=True)
        self.journal = JournalWriter(os.path.join(self.dir, JOURNAL_NAME))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._lock = threading.Lock()
        self._fault_file = None
        meta = {
            "kind": "meta",
            "wall_time": time.time(),
            "peer": self.peer,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "argv": list(sys.argv),
            "python": sys.version.split()[0],
            "interval_s": self.interval,
        }
        try:
            with open(os.path.join(self.dir, META_NAME), "w") as f:
                json.dump(meta, f, indent=2)
        except OSError:
            pass
        self.journal.append(meta)
        if enable_faulthandler:
            self._enable_faulthandler()
        if install_signal_handlers:
            self._install_signal_handlers()
        atexit.register(self._atexit)

    # -- setup ---------------------------------------------------------
    def _enable_faulthandler(self) -> None:
        import faulthandler

        try:
            self._fault_file = open(os.path.join(self.dir, FAULT_NAME), "w")
            faulthandler.enable(file=self._fault_file, all_threads=True)
        except (OSError, ValueError):
            self._fault_file = None

    def _install_signal_handlers(self) -> None:
        # only possible on the main thread; a recorder started from a
        # helper thread still journals, it just can't hook signals
        try:
            prev_term = signal.getsignal(signal.SIGTERM)
            if prev_term is not None:
                # getsignal() -> None means a handler installed from C
                # that we cannot chain faithfully — leave SIGTERM alone
                # (atexit still covers a clean teardown)

                def on_term(signum, frame):
                    # flush from a fresh thread with a bounded join: the
                    # handler may have interrupted THIS thread mid-append,
                    # and close() re-acquiring those non-reentrant locks
                    # inline would deadlock the shutdown forever. If the
                    # locks are wedged we lose the exit record (the reader
                    # tolerates the torn tail) but the SIGTERM still kills.
                    t = threading.Thread(
                        target=self.close, kwargs={"reason": "sigterm"},
                        name="kf-flight-term", daemon=True,
                    )
                    t.start()
                    t.join(2.0)
                    if prev_term == signal.SIG_IGN:
                        return  # the process chose to survive SIGTERM
                    if callable(prev_term):
                        prev_term(signum, frame)
                    else:  # SIG_DFL
                        signal.signal(signum, signal.SIG_DFL)
                        os.kill(os.getpid(), signum)

                signal.signal(signal.SIGTERM, on_term)
            if hasattr(signal, "SIGUSR2"):

                def on_usr2(signum, frame):
                    # dump from a fresh thread: a handler interrupting
                    # the main thread mid-append must not re-enter the
                    # journal lock it already holds
                    threading.Thread(
                        target=self.dump, kwargs={"reason": "sigusr2"},
                        name="kf-flight-usr2", daemon=True,
                    ).start()

                signal.signal(signal.SIGUSR2, on_usr2)
        except (ValueError, OSError):
            pass

    # -- recording -----------------------------------------------------
    def _snapshot_record(self, kind: str, **extra) -> dict:
        metrics.update_process_health()
        spans = [
            # compact tuples: name, start (perf s), duration (ms)
            [e.name, round(e.start, 6), round(e.duration * 1e3, 3)]
            for e in tracing.full_events()[-SPAN_TAIL:]
        ]
        rec = {
            "kind": kind,
            "wall_time": time.time(),
            "perf_now": time.perf_counter(),
            "peer": self.peer,
            "step": self._current_step(),
            "metrics": metrics.render(),
            "spans": spans,
            "open_spans": tracing.open_spans(),
            "audit": audit.to_json()[-AUDIT_TAIL:],
            "log_tail": log.tail(LOG_TAIL),
            # the step plane's ring: the last
            # KF_STEP_TIMELINE_KEEP per-step timelines, so a postmortem
            # can say WHERE IN THE STEP the worker died (an unflushed
            # final timeline names the bucket that never finished)
            "steps": steptrace.get_store().timelines(),
            # the decision ledger's tail: a postmortem can
            # name the adaptation the cluster was mid-flip on at death
            # (an unclosed decision with no outcome IS that answer)
            "decisions": decisions.get_ledger().tail(DECISION_TAIL),
            # the resource plane's CPU attribution: a worker that died
            # pegged at 100% telemetry CPU is a named finding, not a
            # mystery — the final CPU split rides every snapshot
            "resources": self._resources_doc(),
            # the memory plane's RSS decomposition + headroom trend: an
            # OOM-killed worker's final record names the bucket that ate
            # the budget instead of leaving a bare exit code -9
            "memory": self._memory_doc(),
        }
        rec.update(extra)
        return rec

    @staticmethod
    def _resources_doc() -> Optional[dict]:
        try:
            from kungfu_tpu_torch.telemetry import resource

            return resource.get_plane().export()
        # kfcheck: disable=KF400 — snapshot enrichment is best-effort:
        # a failed /proc sweep must cost the record one None field, not
        # the journal the whole snapshot
        except Exception:  # noqa: BLE001
            return None

    @staticmethod
    def _memory_doc() -> Optional[dict]:
        try:
            from kungfu_tpu_torch.telemetry import memory as tmemory

            plane = tmemory.get_plane()
            plane.maybe_sweep(force=True)
            return plane.export()
        # kfcheck: disable=KF400 — same posture as _resources_doc: the
        # memory tail is enrichment, never the reason a snapshot fails
        except Exception:  # noqa: BLE001
            return None

    @staticmethod
    def _current_step() -> Optional[float]:
        m = metrics.get_registry().get("kungfu_steps_total")
        try:
            return m.value if m is not None else None
        except ValueError:
            return None  # labelled family — no scalar step

    def snapshot(self, kind: str = "snapshot", **extra) -> None:
        with self._lock:
            if self._closed:
                return
            try:
                self.journal.append(self._snapshot_record(kind, **extra))
            except Exception as e:  # noqa: BLE001 - the recorder must never kill training
                log.warn("flight: snapshot failed: %s", e)

    def dump(self, reason: str = "manual") -> None:
        """On-demand full snapshot (SIGUSR2 / debugging)."""
        self.snapshot(kind="dump", reason=reason)

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "FlightRecorder":
        if self._thread is not None:
            return self
        self.snapshot(kind="start")

        def loop():
            while not self._stop.wait(self.interval):
                self.snapshot()

        self._thread = threading.Thread(
            target=loop, name="kf-flight", daemon=True
        )
        self._thread.start()
        return self

    def _atexit(self) -> None:
        self.close(reason="atexit")

    def close(self, reason: str = "exit") -> None:
        """Final flush: one terminal record, then the journal closes.
        Idempotent — the first reason wins (sigterm beats atexit)."""
        with self._lock:
            if self._closed:
                return
            try:
                self.journal.append(
                    self._snapshot_record("exit", reason=reason)
                )
            # kfcheck: disable=KF400 — SIGTERM/atexit teardown: the
            # journal append is best-effort and logging can itself fail
            # mid-death; the journal's absence IS the postmortem signal
            except Exception:  # noqa: BLE001
                pass
            self._closed = True
        self._stop.set()
        try:
            atexit.unregister(self._atexit)
        # kfcheck: disable=KF400 — atexit.unregister during interpreter
        # teardown may race module clearing; nothing to report, nowhere
        # reliable left to report it
        except Exception:  # noqa: BLE001
            pass
        self.journal.close()
        if self._fault_file is not None:
            import faulthandler

            try:
                if faulthandler.is_enabled():
                    faulthandler.disable()
                self._fault_file.close()
            except (OSError, ValueError):
                pass
            self._fault_file = None


# -- process-wide recorder ---------------------------------------------

_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def flight_enabled() -> bool:
    """On when a telemetry dir is set (kfrun injects one) or any
    telemetry feature is enabled; KF_FLIGHT overrides both ways."""
    if knobs.raw(FLIGHT_ENV).strip() != "":  # unset/empty = auto
        return truthy(knobs.raw(FLIGHT_ENV))
    if knobs.raw(DIR_ENV):
        return True
    return bool(config.features())


def start_recorder(
    peer: str = "", directory: Optional[str] = None, **kw
) -> Optional[FlightRecorder]:
    """Start (idempotently) this process's flight recorder in
    ``<KF_TELEMETRY_DIR>/<peer>/``. Returns None when disabled."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            return _recorder
        if directory is None:
            if not flight_enabled():
                return None
            run_dir = knobs.raw(DIR_ENV)
            if not run_dir:
                # self-minted fallback (no runner plumbed a run dir):
                # apply the same retention kfrun does, or every bare
                # run grows the default base forever
                prune_runs()
                run_dir = default_run_dir()
            label = peer or knobs.raw("KF_SELF_SPEC") or str(os.getpid())
            directory = peer_dir(run_dir, label)
        try:
            _recorder = FlightRecorder(directory, peer=peer, **kw).start()
        except OSError as e:
            log.warn("flight: recorder disabled (%s)", e)
            return None
        return _recorder


def get_recorder() -> Optional[FlightRecorder]:
    with _recorder_lock:
        return _recorder


def stop_recorder(reason: str = "stop") -> None:
    global _recorder
    with _recorder_lock:
        rec, _recorder = _recorder, None
    if rec is not None:
        rec.close(reason=reason)


# ---------------------------------------------------------------------------
# runner-side harvesting
# ---------------------------------------------------------------------------


def describe_exit(exit_code: Optional[int]) -> str:
    """'exit code 7' / 'signal SIGKILL (-9)' / 'unknown'."""
    if exit_code is None:
        return "unknown"
    if exit_code < 0:
        try:
            name = signal.Signals(-exit_code).name
        except ValueError:
            return f"signal {-exit_code} ({exit_code})"
        return f"signal {name} ({exit_code})"
    return f"exit code {exit_code}"


def _read_text_tail(path: str, max_bytes: int = 16384) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def harvest_postmortem(
    run_dir: str,
    peer: str,
    exit_code: Optional[int] = None,
    output_tail: Optional[List[str]] = None,
    journal_dir: Optional[str] = None,
) -> dict:
    """Synthesize a dead worker's postmortem from whatever it left
    behind. Never raises on missing/torn artifacts: a worker that died
    before writing anything still yields a postmortem carrying the
    runner-side facts (exit code, output tail). An empty ``run_dir``
    (no KF_TELEMETRY_DIR plumbed) skips disk reads entirely rather
    than probing a structurally wrong location. ``journal_dir``
    overrides the ``<run_dir>/<peer>`` layout for offline forensics on
    a dir that was copied/renamed out of its run."""
    if journal_dir:
        d = journal_dir
        records, errors = read_journal(d)
    elif run_dir:
        d = peer_dir(run_dir, peer)
        records, errors = read_journal(d)
    else:
        d, records, errors = "", [], []
    # scope to the LAST incarnation: a respawned peer appends a fresh
    # meta to the same journal, and the postmortem describes the one
    # that died — an older incarnation's clean exit record must not
    # make this death look flushed
    meta_idx = next(
        (i for i in range(len(records) - 1, -1, -1)
         if records[i].get("kind") == "meta"),
        None,
    )
    meta = records[meta_idx] if meta_idx is not None else None
    incarnation = records[meta_idx:] if meta_idx is not None else records
    snaps = [
        r for r in incarnation
        if r.get("kind") in ("snapshot", "start", "dump", "exit")
    ]
    last = snaps[-1] if snaps else None
    exit_rec = next(
        (r for r in reversed(incarnation) if r.get("kind") == "exit"), None
    )
    now = time.time()
    pm = {
        "kind": "worker_postmortem",
        "peer": str(peer),
        "wall_time": now,
        "exit_code": exit_code,
        "death": describe_exit(exit_code),
        "clean_exit": exit_rec is not None,
        "exit_reason": exit_rec.get("reason") if exit_rec else None,
        "pid": meta.get("pid") if meta else None,
        "started_at": meta.get("wall_time") if meta else None,
        "journal_dir": d if d and (records or os.path.isdir(d)) else None,
        "journal_records": len(records),
        "journal_errors": errors,
        "last_record_at": last.get("wall_time") if last else None,
        "last_record_age_s": (
            round(now - last["wall_time"], 3)
            if last and isinstance(last.get("wall_time"), (int, float))
            else None
        ),
        "last_step": last.get("step") if last else None,
        "last_step_timeline": (
            (last.get("steps") or [None])[-1] if last else None
        ),
        "last_decisions": (last.get("decisions") or []) if last else [],
        "last_resources": last.get("resources") if last else None,
        "last_memory": last.get("memory") if last else None,
        "open_spans": (last.get("open_spans") or {}) if last else {},
        "audit_tail": (last.get("audit") or [])[-10:] if last else [],
        "log_tail": (last.get("log_tail") or [])[-20:] if last else [],
        "process_health": _health_from_metrics(last),
        "faulthandler": (
            _read_text_tail(os.path.join(d, FAULT_NAME)) or None
        ) if d else None,
        "output_tail": list(output_tail or [])[-40:],
    }
    pm["oom_suspected"] = oom_suspected(
        pm.get("last_memory"), exit_code
    )
    return pm


def oom_suspected(last_memory: Optional[dict],
                  exit_code: Optional[int]) -> bool:
    """Did the kernel's OOM killer plausibly end this worker? True when
    the final journalled RSS was within ``KF_MEMORY_OOM_MARGIN`` of the
    measured memory limit, or the death was SIGKILL with the memory
    trend still rising (the OOM killer's exact signature: -9 out of
    nowhere while RSS climbs). A verdict, not a fact — the kernel logs
    the real one in dmesg, which the worker can never report itself."""
    mem = last_memory or {}
    rss = mem.get("rss_bytes")
    limit = mem.get("limit_bytes")
    if rss and limit:
        margin = float(knobs.get("KF_MEMORY_OOM_MARGIN"))
        if rss >= limit * (1.0 - margin):
            return True
    if exit_code == -int(signal.SIGKILL):
        trend = mem.get("trend_bytes_per_s")
        if trend is not None and trend > 0:
            return True
    return False


def _health_from_metrics(snap: Optional[dict]) -> dict:
    """Pull the kungfu_process_* gauges out of a snapshot's exposition
    text — the OOM/fd-leak trend's final point."""
    if not snap or not snap.get("metrics"):
        return {}
    out = {}
    for line in snap["metrics"].splitlines():
        if line.startswith("kungfu_process_") and " " in line:
            name, _, val = line.rpartition(" ")
            try:
                out[name.replace("kungfu_process_", "")] = float(val)
            except ValueError:
                pass
    return out


def append_postmortem(run_dir: str, pm: dict) -> Optional[str]:
    """Durably record a postmortem in <run_dir>/postmortems.jsonl (the
    runner-side black box: it survives the runner exiting too)."""
    try:
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, POSTMORTEM_NAME)
        with open(path, "a") as f:
            f.write(json.dumps(pm, separators=(",", ":")) + "\n")
        return path
    except OSError as e:
        log.warn("flight: postmortem not persisted: %s", e)
        return None


def read_postmortems(run_dir: str) -> List[dict]:
    out: List[dict] = []
    try:
        with open(os.path.join(run_dir, POSTMORTEM_NAME)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn final line: same contract as the journal
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# rendering (the `info postmortem` timeline)
# ---------------------------------------------------------------------------


def _ts(wall: Optional[float]) -> str:
    if not isinstance(wall, (int, float)):
        return "?"
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(wall))


def render_postmortem(pm: dict) -> str:
    """One postmortem as a human-readable death timeline."""
    peer = pm.get("peer", "?")
    lines = [f"== postmortem: {peer} =="]
    death = pm.get("death") or describe_exit(pm.get("exit_code"))
    when = _ts(pm.get("wall_time"))
    lines.append(f"died: {death}  (harvested {when})")
    if pm.get("clean_exit"):
        lines.append(
            f"exit record present (reason: {pm.get('exit_reason') or '?'}) "
            "— the worker flushed its journal on the way down"
        )
    else:
        lines.append(
            "no exit record — the worker was killed before it could flush "
            "(SIGKILL/OOM/SIGBUS class)"
        )
    if pm.get("started_at") is not None:
        lines.append(
            f"started: {_ts(pm['started_at'])}  pid={pm.get('pid', '?')}"
        )
    age = pm.get("last_record_age_s")
    if pm.get("last_record_at") is not None:
        lines.append(
            f"last journal record: {_ts(pm['last_record_at'])}"
            + (f"  ({age:.1f}s before harvest)" if isinstance(age, (int, float)) else "")
        )
    if pm.get("last_step") is not None:
        lines.append(f"last step: {int(pm['last_step'])}")
    health = pm.get("process_health") or {}
    if health:
        parts = []
        if "rss_bytes" in health:
            parts.append(f"rss={health['rss_bytes'] / (1024 * 1024):.1f}MiB")
        if "open_fds" in health:
            parts.append(f"fds={int(health['open_fds'])}")
        if "threads" in health:
            parts.append(f"threads={int(health['threads'])}")
        if "uptime_seconds" in health:
            parts.append(f"uptime={health['uptime_seconds']:.0f}s")
        if parts:
            lines.append("last self-health: " + " ".join(parts))
    open_spans = pm.get("open_spans") or {}
    if open_spans:
        lines.append("open spans at last snapshot:")
        for thread, stack in sorted(open_spans.items()):
            lines.append(f"  {thread}: {' > '.join(stack)}")
    tl = pm.get("last_step_timeline")
    if tl:
        lines.append("final step timeline (where in the step it died):")
        lines.extend(
            " " + l for l in steptrace.render_timeline(tl, peer=str(peer))
        )
    res = pm.get("last_resources")
    if res:
        from kungfu_tpu_torch.telemetry import resource as _tres

        lines.append("final CPU attribution (resource plane):")
        lines.extend(" " + l for l in _tres.render_worker_resources(res))
    mem = pm.get("last_memory")
    if mem:
        from kungfu_tpu_torch.telemetry import memory as _tmem

        lines.append("final memory attribution (memory plane):")
        lines.extend(" " + l for l in _tmem.render_worker_memory(mem))
    if pm.get("oom_suspected"):
        lines.append(
            "⚠ OOM suspected: final RSS was at the memory limit (or the "
            "death was SIGKILL while RSS was still climbing) — check the "
            "buckets above for the consumer, and dmesg on the host for "
            "the kernel's verdict"
        )
    last_dec = pm.get("last_decisions") or []
    if last_dec:
        lines.append("final adaptation decisions (ledger tail):")
        for rec in last_dec[-4:]:
            lines.append("  " + decisions.render_record(rec))
        unclosed = [r for r in last_dec if r.get("status") != "closed"]
        if unclosed:
            lines.append(
                "  ⚠ unclosed decision(s) above: the cluster was "
                "mid-flip on "
                + ", ".join(str(r.get("kind")) for r in unclosed)
                + " at death — the adaptation never got its outcome "
                "measured"
            )
    audit_tail = pm.get("audit_tail") or []
    if audit_tail:
        lines.append("final audit events:")
        for rec in audit_tail:
            wall = rec.get("wall_time")
            kind = rec.get("kind", "?")
            detail = {
                k: v for k, v in rec.items()
                if k not in ("kind", "wall_time")
            }
            lines.append(f"  {_ts(wall)}  {kind}  {json.dumps(detail, default=str)}")
    log_tail = pm.get("log_tail") or []
    if log_tail:
        lines.append("log tail:")
        lines.extend(f"  {l}" for l in log_tail)
    fh = pm.get("faulthandler")
    if fh and fh.strip():
        lines.append("faulthandler:")
        lines.extend(f"  {l}" for l in fh.strip().splitlines())
    out_tail = pm.get("output_tail") or []
    if out_tail:
        lines.append("output tail (runner-captured stdout/stderr):")
        lines.extend(f"  {l}" for l in out_tail)
    errs = pm.get("journal_errors") or []
    if errs:
        lines.append(
            "journal read notes: " + "; ".join(errs)
            + " (complete records up to the tear were recovered)"
        )
    if not pm.get("journal_records"):
        lines.append(
            "journal: empty or missing — timeline built from "
            "runner-side capture only"
        )
    return "\n".join(lines)


def harvest_peer_dir(path: str) -> Optional[dict]:
    """Harvest one peer journal dir directly (exit code unknown —
    offline forensics, not a live runner). None when the dir holds no
    journal."""
    path = os.path.normpath(path)
    if not (
        os.path.exists(os.path.join(path, JOURNAL_NAME))
        or os.path.exists(os.path.join(path, JOURNAL_PREV_NAME))
    ):
        return None
    records, _ = read_journal(path)
    meta = next((r for r in records if r.get("kind") == "meta"), None)
    label = (meta or {}).get("peer") or os.path.basename(path)
    # harvest against THIS dir, not a re-derivation from the label: a
    # dir copied/renamed for offline forensics must still harvest
    return harvest_postmortem("", label, journal_dir=path)


def harvest_run_dir(run_dir: str) -> List[dict]:
    """Postmortems for an entire run dir: the runner's durable
    postmortems.jsonl entries, MERGED with fresh harvests of peer
    journals the runner never got to (e.g. the runner itself was
    killed mid-recovery). With no jsonl at all, every journaled peer
    is harvested (exit codes unknown); with one, uncovered peers are
    added only when their journal lacks a clean exit record — a
    normally-completed worker is not a death."""
    pms = list(read_postmortems(run_dir))
    covered = {sanitize_label(pm.get("peer", "")) for pm in pms}
    try:
        entries = sorted(os.scandir(run_dir), key=lambda e: e.name)
    except OSError:
        return pms
    for e in entries:
        if not e.is_dir() or e.name in covered:
            continue
        pm = harvest_peer_dir(e.path)
        if pm is None:
            continue
        if covered and pm.get("clean_exit"):
            continue
        pms.append(pm)
    return pms
