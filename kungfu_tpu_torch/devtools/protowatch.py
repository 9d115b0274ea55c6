"""Runtime collective-order sentinel (``KF_DEBUG_PROTOCOL=1``).

Port of `kungfu_tpu/devtools/protowatch.py`. Static lints see the
protocol a call site *spells*; this layer sees the collective sequence
each peer actually *runs*. The engine's
worst failure mode is a cross-peer protocol divergence — peers whose
collective sequences, wire names or payload shapes differ hang in a
rendezvous nobody else will enter, and the postmortem shows only "walk
timed out". When attached (from ``HostSession.__init__`` under the
knob), protowatch wraps the session's public collective entry points
and the async scheduler's ``submit``/``flush`` to keep, per peer, a
rolling **round window** of entries::

    (kind, name, dtype, nbytes, strategy)  +  call site file.py:lineno

At every scheduler ``flush()`` boundary (and on demand via
:func:`check`) the window is cross-checked on the **knob-independent
star walk** (the ``check_knob_consensus`` machinery — fixed graphs,
fixed names, so the check itself cannot deadlock on the very divergence
it hunts):

1. a 2-round byte consensus over the window digest — agreement clears
   the window and the round is done;
2. on mismatch, a fixed-shape entry exchange (MAX of lengths, then a
   SUM-allreduce where each rank fills its own row) hands every peer
   every peer's entries, and each peer reports the **first divergent
   entry per peer** — its own call site, the other peer's entry, the
   round index — as ``protocol_divergence`` audit events (journaled by
   the flight recorder, so postmortems carry the protocol tail), a
   ``log.warn`` line and ``kungfu_debug_protocol_divergences_total``.

This reports *before the hang*: a divergent round is named at the
boundary that follows it, while the cluster can still exchange bytes on
the star walk — not after the next mismatched rendezvous has eaten the
full walk timeout. The async scheduler's registration consensus already
*detects* a divergent first round; protowatch names the exact tensor
and the submitting call site on every peer.

Recording is order-insensitive inside a window (entries are sorted
before digesting): the scheduler's overlap means submit-side and
walk-side entries interleave differently per peer even when the
protocol is identical. Divergence therefore means a *set* difference —
an extra, missing or differently-shaped collective — which is exactly
the class that deadlocks.

Known blind spots, stated:

- collectives driven below the public surface (raw ``_run_graphs``
  calls) are invisible — every engine path in the tree enters through a
  wrapped method;
- windows past ``KF_DEBUG_PROTOCOL_WINDOW`` entries fold their prefix
  into the rolling digest: divergence is still *detected*, but the
  per-entry diff covers only the tail;
- the boundary check requires every peer to reach a boundary; a peer
  already hung inside a divergent walk is named by the surviving peers'
  next postmortem, not by a live check (the check itself would have to
  rendezvous with the hung peer).

``KF_DEBUG_PROTOCOL`` unset means this module is never imported and the
session is never wrapped — zero overhead, as with lockwatch.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys
import threading
from typing import List, Optional, Tuple

_DIVERGENCES = "kungfu_debug_protocol_divergences_total"
_CHECKS = "kungfu_debug_protocol_checks_total"

# one protowatch consensus lane per check, stamped by the state's own
# counter (a rendezvous name a peer derives from its own history only:
# the sentinel must not break the rule it polices)
_CHECK_TAG = ":protowatch:{n}"


def _dtype_str(t) -> str:
    """A tensor's dtype as numpy spells it (``dtype.str``), the entry
    spelling of the JAX package's sentinel, so windows of both packages
    digest alike; bfloat16 is ``<V2``, as ml_dtypes' bfloat16."""
    import torch

    if t.dtype == torch.bfloat16:
        return "<V2"
    return torch.empty(0, dtype=t.dtype).numpy().dtype.str


def _caller_site() -> str:
    """file.py:lineno of the nearest frame outside this module and the
    wrapped session/scheduler modules — the project call site that
    called the collective."""
    skip = (__name__, "kungfu_tpu_torch.collective.host_session")
    f = sys._getframe(2)
    while f is not None and f.f_globals.get("__name__") in skip:
        f = f.f_back
    if f is None:
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


class _Watch:
    """Per-session sentinel state: the round window, its rolling digest,
    and the check counter. All mutation under one lock — entries arrive
    from the caller's thread AND (on the sync sharded path) scheduler
    hand-off threads."""

    def __init__(self, sess, window_cap: int):
        self.sess = sess
        self.window_cap = window_cap
        self.lock = threading.Lock()
        # (entry tuple, call site) in arrival order; compared as a
        # sorted multiset (arrival order is timing-dependent under the
        # scheduler's overlap even when the protocol agrees)
        self.window: List[Tuple[tuple, str]] = []
        self.folded = hashlib.sha256()  # overflow prefix, digest-only
        self.folded_n = 0
        self.round = 0
        self.checks = 0
        self.divergences = 0

    # -- recording ----------------------------------------------------

    def record(self, kind: str, name: str, dtype: str, nbytes: int) -> None:
        # walk-side collectives run FROM the scheduler's registered
        # stage threads are excluded: their timing relative to the flush
        # boundary is peer-local (a slow gather stage records round r's
        # zag entry after the boundary on one peer, before it on
        # another), while the submit-side entries already carry the
        # async protocol deterministically. The scheduler's thread names
        # (kf-sched-*) are what make this exclusion reliable.
        if threading.current_thread().name.startswith("kf-sched-"):
            return
        try:
            strategy = self.sess.active_candidate_name()
        # observe-only layer: a session mid-teardown may lack adaptive
        # state; '?' in the entry IS the record of that, and raising
        # would kill the caller's collective
        except Exception:
            strategy = "?"
        entry = (kind, str(name), str(dtype), int(nbytes), strategy)
        site = _caller_site()
        with self.lock:
            self.window.append((entry, site))
            if len(self.window) > self.window_cap:
                spill = self.window.pop(0)
                self.folded.update(repr(spill[0]).encode())
                self.folded_n += 1

    def record_workspace(self, kind: str, w) -> None:
        self.record(kind, w.name, _dtype_str(w.send), int(w.recv.nbytes))

    # -- the boundary check -------------------------------------------

    @staticmethod
    def _digest(entries: List[Tuple[tuple, str]], folded,
                folded_n: int) -> bytes:
        # entries only — call SITES legitimately differ across peers
        # (different frontends can drive the identical protocol)
        h = folded.copy()
        for entry, _ in sorted(entries):
            h.update(repr(entry).encode())
        return f"{folded_n + len(entries)}:".encode() + h.digest()

    def check(self) -> bool:
        """Cross-check this round's window against every peer on the
        knob-independent star walk; True when the cluster agrees. On
        divergence, report per-peer first-divergent entries (audit +
        log + metric) and return False. The window is snapshotted and
        reset up front, so entries recorded concurrently (overlapped
        next-round work) land in the next round's window. An EMPTY
        window still joins the walk — "this peer ran zero collectives
        while the others ran some" is precisely a divergence, and a peer
        that skipped the exchange would report clean while the rest
        stall in it; the flip side is the documented
        boundary contract: every peer must reach every boundary."""
        sess = self.sess
        with self.lock:
            entries = self.window
            folded, folded_n = self.folded, self.folded_n
            rnd = self.round
            self.window = []
            self.folded = hashlib.sha256()
            self.folded_n = 0
            self.round += 1
            n = self.checks
            self.checks += 1
        if sess.size < 2:
            return True
        digest = self._digest(entries, folded, folded_n)
        agreed = sess._bytes_agree(
            digest, _CHECK_TAG.format(n=n), sess._fixed_allreduce
        )
        self._count(_CHECKS, "Boundary digest cross-checks run by the "
                    "KF_DEBUG_PROTOCOL collective-order sentinel")
        if agreed:
            return True
        with self.lock:
            self.divergences += 1
        mine = json.dumps(
            [[list(e), site] for e, site in sorted(entries)]
        ).encode()
        theirs = self._exchange(mine, n)
        self._report(rnd, entries, theirs)
        return False

    def _exchange(self, mine: bytes, n: int) -> List[Optional[list]]:
        """Every peer's serialized window, via two fixed-shape star
        walks: MAX of lengths, then a SUM-allreduce of a (k, maxlen)
        byte matrix where each rank fills only its own row."""
        import torch

        from kungfu_tpu_torch.base.ops import ReduceOp
        from kungfu_tpu_torch.base.workspace import Workspace

        sess = self.sess
        k = sess.size
        lens = torch.zeros(k, dtype=torch.int64)
        lens[sess.rank] = len(mine)
        lens_out = torch.zeros(k, dtype=torch.int64)
        sess._fixed_allreduce(Workspace(
            lens, lens_out, ReduceOp.MAX,
            _CHECK_TAG.format(n=n) + ":len",
        ))
        maxlen = int(lens_out.max())
        rows = torch.zeros(k * maxlen, dtype=torch.uint8)
        if maxlen and mine:
            rows[sess.rank * maxlen:sess.rank * maxlen + len(mine)] = (
                torch.frombuffer(bytearray(mine), dtype=torch.uint8)
            )
        rows_out = torch.zeros(k * maxlen, dtype=torch.uint8)
        sess._fixed_allreduce(Workspace(
            rows, rows_out, ReduceOp.SUM,
            _CHECK_TAG.format(n=n) + ":entries",
        ))
        out: List[Optional[list]] = []
        for r in range(k):
            blob = rows_out[r * maxlen:r * maxlen + int(lens_out[r])].numpy().tobytes()
            try:
                out.append(json.loads(blob.decode()) if blob else [])
            except ValueError:
                out.append(None)  # peer overflowed / garbled: shape-only
        return out

    def _report(self, rnd: int, entries, all_peers: List[Optional[list]]) -> None:
        from kungfu_tpu_torch.telemetry import audit, log

        sess = self.sess
        mine_sorted = sorted(entries)
        for r, theirs in enumerate(all_peers):
            if r == sess.rank:
                continue
            if theirs is None:
                detail = {"peer_entries": "unavailable"}
            else:
                their_sorted = [(tuple(e), site) for e, site in theirs]
                idx, mine_at, theirs_at = _first_divergence(
                    mine_sorted, their_sorted
                )
                if idx is None:
                    continue  # this pair agrees; a third peer diverged
                detail = {
                    "divergent_index": idx,
                    "mine": _fmt(mine_at),
                    "theirs": _fmt(theirs_at),
                }
            detail.update({
                "round": rnd,
                "other_peer": f"rank{r}",
                "window": len(mine_sorted),
            })
            log.warn(
                "protowatch protocol_divergence round=%s vs rank%s: "
                "mine=%s theirs=%s",
                rnd, r, detail.get("mine"), detail.get("theirs"),
            )
            audit.record_event(
                "protocol_divergence", peer=str(sess.self_id), **detail
            )
            self._count(
                _DIVERGENCES,
                "Cross-peer collective-sequence divergences found by the "
                "KF_DEBUG_PROTOCOL sentinel (each pairs with a "
                "protocol_divergence audit event naming both call sites)",
            )

    def _count(self, name: str, help_: str) -> None:
        try:
            from kungfu_tpu_torch.telemetry import metrics

            metrics.counter(name, help_).inc()
        except Exception as e:  # noqa: BLE001 - the sentinel must never kill training
            sys.stderr.write(f"protowatch: metric update failed: {e}\n")


def _fmt(item: Optional[tuple]) -> str:
    if item is None:
        return "(no entry — this side ran fewer collectives)"
    entry, site = item
    kind, name, dtype, nbytes, strategy = entry
    return f"{kind}({name!r}, {dtype}, {nbytes}B, {strategy}) at {site}"


def _first_divergence(mine: list, theirs: list):
    """Index + both sides' items at the first position where the sorted
    windows' ENTRIES differ ((None, None, None) when identical — sites
    are reporting payload, not identity)."""
    for i in range(max(len(mine), len(theirs))):
        a = mine[i] if i < len(mine) else None
        b = theirs[i] if i < len(theirs) else None
        if (a[0] if a else None) != (b[0] if b else None):
            return i, a, b
    return None, None, None


# ---------------------------------------------------------------------
# attachment (instance-level wrapping: the hot path of unwatched
# sessions is untouched, and uninstalling is just "don't attach")
# ---------------------------------------------------------------------

# (method name, kind label, workspace-arg position) for entry points
# whose first argument is a Workspace
_WS_METHODS = (
    ("all_reduce", "all_reduce"),
    ("monitored_all_reduce", "monitored_all_reduce"),
    ("all_gather", "all_gather"),
)


def attach(sess) -> "_Watch":
    """Wrap one HostSession's public collective entry points (and, via
    :func:`attach_scheduler`, its scheduler) with recording shims.
    Called from HostSession.__init__ under the knob; idempotent."""
    existing = getattr(sess, "_protowatch", None)
    if existing is not None:
        return existing
    from kungfu_tpu_torch import knobs

    watch = _Watch(sess, max(8, int(knobs.get("KF_DEBUG_PROTOCOL_WINDOW"))))
    sess._protowatch = watch

    def wrap_ws(name: str, kind: str) -> None:
        orig = getattr(sess, name)

        @functools.wraps(orig)
        def shim(w, *a, **kw):
            watch.record_workspace(kind, w)
            return orig(w, *a, **kw)

        setattr(sess, name, shim)

    for name, kind in _WS_METHODS:
        wrap_ws(name, kind)

    orig_rs = sess.reduce_scatter

    @functools.wraps(orig_rs)
    def shim_rs(w, *a, **kw):
        watch.record_workspace("reduce_scatter", w)
        return orig_rs(w, *a, **kw)

    sess.reduce_scatter = shim_rs

    orig_ag = sess.all_gather_shards

    @functools.wraps(orig_ag)
    def shim_ag(full, name, *a, **kw):
        watch.record("all_gather_shards", name, _dtype_str(full),
                     int(full.nbytes))
        return orig_ag(full, name, *a, **kw)

    sess.all_gather_shards = shim_ag

    orig_group = sess.group_all_reduce

    @functools.wraps(orig_group)
    def shim_group(ws, *a, **kw):
        for w in ws:
            watch.record_workspace("group_all_reduce", w)
        return orig_group(ws, *a, **kw)

    sess.group_all_reduce = shim_group

    # the bytes-taking entry points record a LENGTH-FREE identity: their
    # payload legitimately differs per rank (a non-root passes b"" to
    # broadcast_bytes; bytes_consensus exists to compare bytes that may
    # disagree) — the rendezvous name is the protocol, the bytes are data
    orig_bc = sess.bytes_consensus

    @functools.wraps(orig_bc)
    def shim_bc(bs, name, *a, **kw):
        watch.record("bytes_consensus", name, "bytes", 0)
        return orig_bc(bs, name, *a, **kw)

    sess.bytes_consensus = shim_bc

    orig_bb = sess.broadcast_bytes

    @functools.wraps(orig_bb)
    def shim_bb(bs, name, *a, **kw):
        watch.record("broadcast_bytes", name, "bytes", 0)
        return orig_bb(bs, name, *a, **kw)

    sess.broadcast_bytes = shim_bb

    return watch


def attach_scheduler(sched) -> None:
    """Wrap a session's CollectiveScheduler: submissions record their
    registered identity + call site, every successful flush runs the
    boundary check. Called from HostSession.scheduler() when the session
    is watched."""
    watch = getattr(sched.sess, "_protowatch", None)
    if watch is None or getattr(sched, "_protowatch_attached", False):
        return
    sched._protowatch_attached = True
    orig_submit = sched.submit

    @functools.wraps(orig_submit)
    def shim_submit(w, *a, **kw):
        if not w.is_empty:
            kind = "submit" if kw.get("handler") is None else "submit:zero"
            watch.record(kind, w.name, _dtype_str(w.send), int(w.recv.nbytes))
        return orig_submit(w, *a, **kw)

    sched.submit = shim_submit
    orig_flush = sched.flush

    def _guarded_check() -> None:
        # the sentinel must never change error semantics: a check that
        # cannot complete (a peer is gone or already hung) times out on
        # the star walk and is logged, not raised
        try:
            watch.check()
        except Exception as e:  # noqa: BLE001 - observe-only layer
            from kungfu_tpu_torch.telemetry import log

            log.warn("protowatch boundary check failed: %s", e)

    @functools.wraps(orig_flush)
    def shim_flush(*a, **kw):
        from kungfu_tpu_torch.collective.scheduler import SchedulerClosed

        try:
            orig_flush(*a, **kw)
        except SchedulerClosed:
            raise  # epoch over: peers are swapping sessions, no walk
        except (RuntimeError, ValueError):
            # registration divergence / missing-or-duplicate submission:
            # every live peer raises or checks symmetrically, and this
            # is exactly the moment the window names WHO diverged —
            # check first, then let the engine's error propagate
            _guarded_check()
            raise
        _guarded_check()

    sched.flush = shim_flush


def check(sess) -> bool:
    """Explicit boundary check for the synchronous path (benches, the
    protowatch e2e): call at a step/round boundary on EVERY peer. True
    when the cluster's windows agree."""
    watch = getattr(sess, "_protowatch", None)
    if watch is None:
        return True
    return watch.check()


def stats(sess) -> dict:
    watch = getattr(sess, "_protowatch", None)
    if watch is None:
        return {}
    with watch.lock:
        return {
            "window": len(watch.window),
            "round": watch.round,
            "checks": watch.checks,
            "divergences": watch.divergences,
        }
