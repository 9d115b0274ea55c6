"""The port's registry of the `KF_*` environment knobs it reads.

Port of `kungfu_tpu/knobs.py`. Each knob is declared once with its name,
default, parser and doc string, and every read in the port goes through
:func:`get`/:func:`raw`. Names, defaults and parsers are the reference's,
so one kfrun environment drives both packages alike; the port declares
only what its modules read, and each later slice declares its own. It
never registers into `kungfu_tpu/knobs.py`.

Semantics, shared by every knob: an UNSET or empty-string variable
resolves to the declared default; a set value is parsed by the knob's
parser. A malformed value falls back to the default with a logged
warning, except for ``strict`` knobs, which raise ``ValueError``.

The accessors read `os.environ`, or the mapping a caller passes as
`environ` (the device plane's bootstrap takes one, as tests do).

This module imports nothing of the port at module level: the logger
itself reads knobs from here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Mapping, Optional

__all__ = [
    "Knob", "declared", "names", "get", "raw", "is_set", "render_doc",
]


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: str  # env-level default (the string an unset var resolves to)
    parse: Callable[[str], object]
    doc: str
    section: str
    kind: str = "str"  # human-readable type for the generated doc
    default_doc: str = ""  # display override when the default is dynamic
    strict: bool = False  # parse errors raise instead of warn-and-default
    consensus: bool = False  # cluster-agreed (the engine's consensus tuple)


_REGISTRY: Dict[str, Knob] = {}
_SECTIONS: List[str] = []  # insertion order for doc rendering


def _knob(name, default, parse, doc, *, section, kind, default_doc="",
          strict=False, consensus=False) -> None:
    if name in _REGISTRY:
        raise ValueError(f"knob {name} declared twice")
    if section not in _SECTIONS:
        _SECTIONS.append(section)
    _REGISTRY[name] = Knob(
        name=name, default=default, parse=parse, doc=doc, section=section,
        kind=kind, default_doc=default_doc, strict=strict,
        consensus=consensus,
    )


# --- parsers -----------------------------------------------------------

_TRUTHY = frozenset({"1", "true", "yes", "on", "y", "enabled"})


def _bool(s: str) -> bool:
    return str(s).strip().lower() in _TRUTHY


def _int(s: str) -> int:
    return int(str(s).strip())


def _float(s: str) -> float:
    return float(str(s).strip())


def _int_bytes(s: str) -> int:
    """Integer byte count; accepts float notation ("8e6")."""
    return int(float(str(s).strip()))


def _str(s: str) -> str:
    return str(s)


def _stripped(s: str) -> str:
    return str(s).strip()


def _csv(s: str) -> tuple:
    return tuple(p.strip() for p in str(s).split(",") if p.strip())


def _opt_int(s: str):
    s = str(s).strip()
    return int(s) if s else None


def _choice(name: str, choices, *, empty_as: Optional[str] = None):
    """Lowercased membership check ("KF_X must be one of [...], got ...")."""
    allowed = tuple(choices)

    def parse(s: str) -> str:
        raw = str(s).strip().lower()
        if raw == "" and empty_as is not None:
            return empty_as
        if raw not in allowed:
            shown = sorted(c for c in allowed if c)
            raise ValueError(
                f"{name} must be one of {shown}, got {raw!r}"
            )
        return raw

    return parse


# --- declarations ------------------------------------------------------
# The reference's names, defaults, parsers and doc strings, for the knobs
# the port reads: the worker contract the runner sets, the elastic and
# monitored runners' and the standby pool's, the log level, the stall
# detector's switch, and the collective engine's and transport's.

_SEC_CONTRACT = "Worker contract (set by the runner)"
_knob("KF_SELF_SPEC", "", _str,
      "This worker's identity as `host:port`. Unset means single-process "
      "fallback: the worker becomes a one-peer cluster of itself.",
      section=_SEC_CONTRACT, kind="str")
_knob("KF_INIT_PEERS", "", _str,
      "Comma-separated initial peer list (`host:port,...`). Defaults to "
      "`KF_SELF_SPEC` (a cluster of one).",
      section=_SEC_CONTRACT, kind="str", default_doc="KF_SELF_SPEC")
_knob("KF_DEVICE_SLOTS", "", _csv,
      "Comma-separated accelerator chip ids this worker may open "
      "(empty = unrestricted). Mirrored into `TPU_VISIBLE_DEVICES`.",
      section=_SEC_CONTRACT, kind="csv")
_knob("KF_LOG_PREFIX", "", _str,
      "Per-worker log prefix (`rank/np`), set by the runner; falls back "
      "to `KF_SELF_SPEC`.",
      section=_SEC_CONTRACT, kind="str")
_knob("KF_INIT_RUNNERS", "", _str,
      "Comma-separated runner (supervisor) endpoints.",
      section=_SEC_CONTRACT, kind="str")
_knob("KF_PARENT_ID", "", _str,
      "The spawning runner's `host:port`, empty for orphan workers.",
      section=_SEC_CONTRACT, kind="str")
_knob("KF_INIT_CLUSTER_VERSION", "0", _int,
      "Cluster version the worker starts at (bumped by every resize).",
      section=_SEC_CONTRACT, kind="int")
_knob("KF_INIT_PROGRESS", "0", _int,
      "Training progress (steps) restored into the elastic state on start.",
      section=_SEC_CONTRACT, kind="int")
_knob("KF_ALLREDUCE_STRATEGY", "BINARY_TREE_STAR", _stripped,
      "Initial collective strategy name (see `base/strategy.py`; "
      "`AUTO` lets `auto_select` pick from the topology).",
      section=_SEC_CONTRACT, kind="str")
_knob("KF_SPAWN_TS", "", _str,
      "Unix timestamp the runner spawned this worker at; start() reports "
      "spawn→ready latency from it.",
      section=_SEC_CONTRACT, kind="float-ts")
_knob("KF_RUNNER_PID", "0", _int,
      "PID of the supervising runner (standby activation checks it).",
      section=_SEC_CONTRACT, kind="int")

_SEC_ELASTIC = "Elastic / adaptation"
_knob("KF_CONFIG_SERVER", "", _str,
      "Config-server URL for elastic membership proposals "
      "(empty = static cluster).",
      section=_SEC_ELASTIC, kind="url")
_knob("KF_ELASTIC_MODE", "", _str,
      "Resize style: empty (delta resize in-process) or `reload` "
      "(workers restart on membership change).",
      section=_SEC_ELASTIC, kind="str")
_knob("KF_RECOVER_EPOCH", "", _str,
      "Set by the monitored runner on relaunch: the minimum completed "
      "epoch; checkpoint restore caps at it.",
      section=_SEC_ELASTIC, kind="int")
_knob("KF_MONITOR_ADDR", "", _str,
      "Where `send_heartbeat` POSTs worker heartbeats "
      "(set by the monitored runner).",
      section=_SEC_ELASTIC, kind="host:port")
_knob("KF_CONFIG_ENABLE_MONITORING", "", _bool,
      "Truthy spelling enables the gradient-noise/variance monitor "
      "(also implied by `KF_TELEMETRY=metrics`).",
      section=_SEC_ELASTIC, kind="bool")
_knob("KF_CONFIG_ENABLE_STALL_DETECTION", "", _bool,
      "Truthy spelling logs collectives that exceed their deadline "
      "repeatedly until they complete.",
      section=_SEC_ELASTIC, kind="bool")

_SEC_STANDBY = "Standby pool"
_knob("KF_STANDBY_FIFO", "", _str,
      "Path of the activation FIFO a standby worker blocks on "
      "(`kf-standby` refuses to run without it).",
      section=_SEC_STANDBY, kind="path")
_knob("KF_STANDBY_PRELOAD", "", _csv,
      "Extra modules a standby imports before parking, so activation "
      "skips their import cost.",
      section=_SEC_STANDBY, kind="csv")
_knob("KF_ACTIVATED_TS", "", _str,
      "Monotonic timestamp stamped by the standby pool at activation "
      "(activation-latency accounting).",
      section=_SEC_STANDBY, kind="float-ts")

# the collective engine's knobs: every `consensus` one decides rendezvous
# names, message sizes or peer pairings, and HostSession.engine_knobs()
# lists them for the knob consensus between peers
_SEC_ENGINE = "Collective engine (cluster-agreed)"
_knob("KF_CONFIG_ALGO", "",
      _choice("KF_CONFIG_ALGO", ("", "tree", "segmented", "auto")),
      "Forces the collective algorithm family: `tree` (rank-0 graph "
      "walks), `segmented` (ring reduce-scatter/all-gather), or `auto` "
      "(topology heuristic). Unset: no override — the session keeps its "
      "configured strategy. Cluster-agreed: checked by "
      "`check_knob_consensus` at every session epoch.",
      section=_SEC_ENGINE, kind="choice", strict=True, consensus=True,
      default_doc="(unset: no override)")
_knob("KF_CONFIG_WIRE", "",
      _choice("KF_CONFIG_WIRE", ("off", "bf16", "f16", "auto", "int8", "int4"),
              empty_as="off"),
      "Compressed wire format for f32 allreduce payloads: bf16/f16 "
      "(2-byte, f32 ring accumulation), or block-scaled int8/int4 with "
      "error-feedback residuals (`KF_WIRE_BLOCK` elements per scale); "
      "`auto` resolves to bf16 for eligible payloads. Cluster-agreed.",
      section=_SEC_ENGINE, kind="choice", strict=True, consensus=True,
      default_doc="off")
_knob("KF_CONFIG_WIRE_MIN_BYTES", str(64 << 10), _int,
      "Payloads below this bypass the wire codec (keeps probe-sized "
      "monitored traffic exact). Cluster-agreed.",
      section=_SEC_ENGINE, kind="int", consensus=True)
_knob("KF_WIRE_BLOCK", "16", _int,
      "Elements per absmax scale block of the int8/int4 wire codec "
      "(one f32 scale per block: smaller blocks track outliers, bigger "
      "blocks amortize the 4-byte scale). Cluster-agreed: it decides "
      "the byte length of every quantized message.",
      section=_SEC_ENGINE, kind="int", consensus=True)
_knob("KF_CONFIG_CHUNK_BYTES", "0", _int,
      "Overrides the chunked-walk chunk size heuristic (0 = heuristic). "
      "Cluster-agreed.",
      section=_SEC_ENGINE, kind="int", consensus=True)
_knob("KF_CONFIG_SEGMENT_MIN_BYTES", str(64 << 10), _int,
      "Payloads below this fall back from the segmented ring to rank-0 "
      "tree graphs (per-segment framing overhead dominates). "
      "Cluster-agreed.",
      section=_SEC_ENGINE, kind="int", consensus=True)
_knob("KF_CONFIG_GROUP_WINDOW", "", _opt_int,
      "Concurrent workspaces per batch in group collectives; default "
      "scales with the cgroup-aware core count (min(8, cores)). "
      "Local-only (not cluster-agreed).",
      section=_SEC_ENGINE, kind="int", default_doc="min(8, cores)")
_knob("KF_CONFIG_GROUP_FUSE_MIN", "4", _int,
      "Minimum same-(dtype,op) tensors before group ops fuse them into "
      "one contiguous walk. Cluster-agreed.",
      section=_SEC_ENGINE, kind="int", consensus=True)
_knob("KF_CONFIG_GROUP_BUCKET_BYTES", str(64 << 20), _int,
      "Fused-bucket size cap for the 3-stage pack/walk/unpack pipeline. "
      "Cluster-agreed (part of the fused workspace name).",
      section=_SEC_ENGINE, kind="int", consensus=True)
_knob("KF_CONFIG_ASYNC", "",
      _choice("KF_CONFIG_ASYNC", ("off", "on", "auto"), empty_as="off"),
      "Asynchronous collective scheduler: group allreduces submitted "
      "per-tensor as gradients become ready launch from a background "
      "thread and overlap backprop (`on`), or only when the session has "
      "≥2 peers (`auto`). `off` runs the synchronous step-end group op. "
      "Cluster-agreed: the mode decides the fused rendezvous names, so "
      "it is checked by `check_knob_consensus` at every session epoch.",
      section=_SEC_ENGINE, kind="choice", strict=True, consensus=True,
      default_doc="off")
_knob("KF_CONFIG_ZERO", "",
      _choice("KF_CONFIG_ZERO", ("off", "on", "auto"), empty_as="off"),
      "ZeRO-1 sharded weight update: gradients are reduce-scattered, "
      "each peer runs the optimizer on (and holds state for) only its "
      "1/k shard, and an all-gather of updated weights (bf16 on the "
      "wire when `KF_CONFIG_WIRE` is active) broadcasts the result. "
      "`on` shards on every multi-peer session, `auto` resolves to on "
      "when the session has ≥2 peers, `off` keeps the replicated "
      "update. Cluster-agreed: the mode decides the whole step's "
      "rendezvous dataflow, so it is checked by `check_knob_consensus` "
      "at every session epoch.",
      section=_SEC_ENGINE, kind="choice", strict=True, consensus=True,
      default_doc="off")
_knob("KF_CONFIG_REPLAN", "",
      _choice("KF_CONFIG_REPLAN",
              ("off", "ring", "ring+segments", "auto", "hier"),
              empty_as="off"),
      "Measured-topology re-planning of the segmented ring: `ring` lets "
      "the vote-driven re-plan reorder ring neighbours from the measured "
      "link matrix, `ring+segments` additionally sizes segments by "
      "measured per-peer throughput, `auto` == `ring+segments`, `hier` "
      "derives TWO-LEVEL plans (per-host intra reduce/broadcast × an "
      "inter-host ring over elected heads, falling back to the flat "
      "measured ring on a single host group) and enables straggler "
      "demotion, `off` keeps the naive rank-order ring. Cluster-agreed: "
      "every peer must run the same lockstep re-plan rounds (and the "
      "adopted plan decides segment bounds), so it is checked by "
      "`check_knob_consensus` at every session epoch.",
      section=_SEC_ENGINE, kind="choice", strict=True, consensus=True,
      default_doc="off")
_knob("KF_REPLAN_DEMOTE_PATIENCE", "3", _int,
      "Closed decision-ledger windows the SAME peer must stay elected "
      "critical (with straggler cause ≠ network-transient) before "
      "`ReplanPolicy` votes it into the demoted role under "
      "`KF_CONFIG_REPLAN=hier`; a recovered peer is promoted back after "
      "the same number of clean windows. Cluster-agreed: demotion flips "
      "the adopted plan's rendezvous dataflow, so every peer must apply "
      "the same patience.",
      section=_SEC_ENGINE, kind="int", strict=True, consensus=True)
_knob("KF_CONFIG_ASYNC_QUEUE", "2", _int,
      "Async scheduler launch-queue depth: how many packed buckets may "
      "sit between the pack and walk stages (bounds live pooled staging "
      "buffers; the walk itself is serialized for cross-peer launch "
      "determinism). Local-only (not cluster-agreed — it changes no "
      "rendezvous name, only local overlap).",
      section=_SEC_ENGINE, kind="int")

_SEC_TRANSPORT = "Transport / shared memory"
_knob("KF_CONFIG_SHM", "1", lambda s: str(s).strip() != "0",
      "Same-host transport rides a shared-memory ring unless this is "
      "exactly `0`.",
      section=_SEC_TRANSPORT, kind="bool")
_knob("KF_CONFIG_SHM_CAPACITY", str(256 << 20), _int,
      "Shared-memory arena size in bytes.",
      section=_SEC_TRANSPORT, kind="int")
_knob("KF_CONFIG_SHM_MIN_BYTES", str(256 << 10), _int,
      "Frames smaller than this take the socket path (ring setup cost "
      "beats small copies).",
      section=_SEC_TRANSPORT, kind="int")

_SEC_DEBUG = "Debug instrumentation"
_knob("KF_DEBUG_PROTOCOL", "", _bool,
      "Truthy installs the runtime collective-order sentinel "
      "(`devtools/protowatch.py`): wraps the session's collective entry "
      "points, keeps a per-peer rolling digest of (kind, name, dtype, "
      "nbytes, strategy) per round, cross-checks it on the "
      "knob-independent star walk at scheduler flush boundaries, and on "
      "divergence reports each peer's first divergent call site as "
      "`protocol_divergence` audit events + "
      "`kungfu_debug_protocol_*` metrics — before the rendezvous hang, "
      "not after. Off = protowatch never imported, hot path untouched.",
      section=_SEC_DEBUG, kind="bool")

_SEC_LOG = "Logging"
_knob("KF_LOG_LEVEL", "", _stripped,
      "Log level (DEBUG/INFO/WARN/ERROR). Falls back to the reference's "
      "`KF_CONFIG_LOG_LEVEL`.",
      section=_SEC_LOG, kind="level", default_doc="KF_CONFIG_LOG_LEVEL")
_knob("KF_CONFIG_LOG_LEVEL", "INFO", _stripped,
      "Legacy (reference-parity) log level, used when `KF_LOG_LEVEL` "
      "is unset.",
      section=_SEC_LOG, kind="level")

_SEC_TELEMETRY = "Telemetry"
_knob("KF_TELEMETRY", "", _stripped,
      "Telemetry feature selection: comma list of `metrics`, `trace`, "
      "`audit`; `all`/any truthy value enables everything.",
      section=_SEC_TELEMETRY, kind="csv")
_knob("KF_TELEMETRY_MAX_SERIES", "512", _int,
      "Cardinality guard: max distinct label-sets per metric family "
      "(0 disables). Past the cap, lookups get a shared detached child "
      "and `kungfu_telemetry_dropped_series_total` counts the drops.",
      section=_SEC_TELEMETRY, kind="int")
_knob("KF_TELEMETRY_SPAN_SAMPLE", "1.0", _float,
      "Fraction of collective walks whose per-step spans are emitted, "
      "in [0,1]; deterministic (not random) sampling.",
      section=_SEC_TELEMETRY, kind="float")
_knob("KF_TRACE_BUFFER", "8192", _int,
      "Span ring-buffer capacity (events) for the /trace view.",
      section=_SEC_TELEMETRY, kind="int")

# --- accessors ---------------------------------------------------------

def _env(environ: Optional[Mapping[str, str]]) -> Mapping[str, str]:
    return os.environ if environ is None else environ


def declared() -> Dict[str, Knob]:
    """Name → Knob for every declared knob (a copy)."""
    return dict(_REGISTRY)


def names() -> List[str]:
    return sorted(_REGISTRY)


def is_set(name: str, environ: Optional[Mapping[str, str]] = None) -> bool:
    """True when the variable is present in the environment (even empty)."""
    _REGISTRY[name]  # KeyError on undeclared names: declare before use
    return name in _env(environ)


def raw(name: str, environ: Optional[Mapping[str, str]] = None) -> str:
    """The raw string value: the environment's, or the declared default
    when unset/empty."""
    k = _REGISTRY[name]
    v = _env(environ).get(name)
    if v is None or v.strip() == "":
        return k.default
    return v


def get(name: str, environ: Optional[Mapping[str, str]] = None):
    """Parsed knob value. Unset/empty resolves to the default; malformed
    values warn and fall back to the default, except strict knobs, which
    raise ValueError."""
    k = _REGISTRY[name]
    v = _env(environ).get(name)
    if v is None or v.strip() == "":
        return k.parse(k.default)
    try:
        return k.parse(v)
    except (ValueError, TypeError) as e:
        if k.strict:
            if name in str(e):
                raise
            raise ValueError(f"{name}: {e}") from None
        # import here, not at module level: the logger reads knobs too
        from kungfu_tpu_torch.telemetry import log

        log.warn("%s: malformed value %r (keeping default %r)",
                 name, v, k.default)
        return k.parse(k.default)


# --- doc generation ----------------------------------------------------

_DOC_HEADER = """\
# Configuration knobs of kungfu_tpu_torch

Every `KF_*` environment variable the port reads, generated from its
registry in `kungfu_tpu_torch/knobs.py` by `render_doc()`. Names, defaults
and parsing are those of `kungfu_tpu/knobs.py`. Unset or empty variables
resolve to the default; malformed values warn and keep the default,
except knobs marked **strict**, which fail fast.

Boolean knobs accept any truthy spelling (`1/true/yes/on/y/enabled`).
"""


def render_doc() -> str:
    out = [_DOC_HEADER]
    for section in _SECTIONS:
        out.append(f"\n## {section}\n")
        out.append("| Knob | Type | Default | What it does |")
        out.append("| --- | --- | --- | --- |")
        for k in sorted((k for k in _REGISTRY.values()
                         if k.section == section), key=lambda k: k.name):
            default = k.default_doc or k.default or "(empty)"
            kind = k.kind + (" · strict" if k.strict else "") + (
                " · consensus" if k.consensus else ""
            )
            out.append(f"| `{k.name}` | {kind} | `{default}` | {k.doc} |")
    out.append("")
    return "\n".join(out)
