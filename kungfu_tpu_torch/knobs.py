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
# the port reads: the worker contract the device plane and the logger
# read, the log level, and the stall detector's switch.

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

_SEC_ELASTIC = "Elastic / adaptation"
_knob("KF_CONFIG_ENABLE_STALL_DETECTION", "", _bool,
      "Truthy spelling logs collectives that exceed their deadline "
      "repeatedly until they complete.",
      section=_SEC_ELASTIC, kind="bool")

_SEC_LOG = "Logging"
_knob("KF_LOG_LEVEL", "", _stripped,
      "Log level (DEBUG/INFO/WARN/ERROR). Falls back to the reference's "
      "`KF_CONFIG_LOG_LEVEL`.",
      section=_SEC_LOG, kind="level", default_doc="KF_CONFIG_LOG_LEVEL")
_knob("KF_CONFIG_LOG_LEVEL", "INFO", _stripped,
      "Legacy (reference-parity) log level, used when `KF_LOG_LEVEL` "
      "is unset.",
      section=_SEC_LOG, kind="level")


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
