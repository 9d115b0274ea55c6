"""Prometheus text-exposition parsing and federation merge.

Port of `kungfu_tpu/telemetry/promparse.py`: a small parser for the text
format the metrics registry emits (sample lines with optional escaped
label values, ``# HELP``/``# TYPE`` metadata, ``+Inf``/``NaN`` values),
and the merge that re-serves many workers' pages as one exposition with
a ``peer`` label naming each scraped worker.

Federation follows Prometheus itself:

- the injected target label is ``peer``;
- a sample that ALREADY carries a ``peer`` label (the worker's
  per-remote-peer egress counters) keeps its value under
  ``exported_peer``, as a Prometheus server does on a label collision;
- ``# HELP``/``# TYPE`` metadata is emitted once per family and all
  samples of a family are regrouped to be consecutive.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

# one source of truth for text-format rendering rules: re-rendering a
# scraped page must produce exactly what the worker's registry emits
from kungfu_tpu_torch.telemetry.metrics import _escape_label as _escape
from kungfu_tpu_torch.telemetry.metrics import _fmt_value


class Sample(NamedTuple):
    name: str
    labels: Tuple[Tuple[str, str], ...]  # insertion-ordered (k, v) pairs
    value: float

    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)


def _parse_value(raw: str) -> float:
    low = raw.lower()
    if low in ("+inf", "inf"):
        return math.inf
    if low == "-inf":
        return -math.inf
    if low == "nan":
        return math.nan
    return float(raw)


def _parse_labels(body: str) -> List[Tuple[str, str]]:
    """Parse the inside of a ``{...}`` label body, honouring ``\\"``,
    ``\\\\`` and ``\\n`` escapes in values."""
    out: List[Tuple[str, str]] = []
    i, n = 0, len(body)
    while i < n:
        while i < n and body[i] in ", ":
            i += 1
        if i >= n:
            break
        eq = body.index("=", i)
        name = body[i:eq].strip()
        i = eq + 1
        if i >= n or body[i] != '"':
            raise ValueError(f"unquoted label value in {body!r}")
        i += 1
        chars: List[str] = []
        while i < n:
            c = body[i]
            if c == "\\" and i + 1 < n:
                nxt = body[i + 1]
                chars.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, nxt))
                i += 2
                continue
            if c == '"':
                i += 1
                break
            chars.append(c)
            i += 1
        out.append((name, "".join(chars)))
    return out


def parse_line(line: str) -> Optional[Sample]:
    """One sample line -> Sample; None for comments/blank/garbage."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if "{" in line:
        brace = line.index("{")
        name = line[:brace]
        close = line.rindex("}")
        labels = _parse_labels(line[brace + 1 : close])
        rest = line[close + 1 :].split()
    else:
        parts = line.split()
        if len(parts) < 2:
            return None
        name, rest = parts[0], parts[1:]
        labels = []
    if not rest:
        return None
    try:
        value = _parse_value(rest[0])  # rest[1], if any, is a timestamp
    except ValueError:
        return None
    return Sample(name, tuple(labels), value)


def parse_text(text: str) -> List[Sample]:
    out = []
    for line in text.splitlines():
        try:
            s = parse_line(line)
        except ValueError:
            s = None
        if s is not None:
            out.append(s)
    return out


def sample_value(
    samples: Iterable[Sample], name: str, **want_labels
) -> Optional[float]:
    """First matching sample's value (labels compared as a subset)."""
    want = {k: str(v) for k, v in want_labels.items()}
    for s in samples:
        if s.name != name:
            continue
        d = s.labels_dict()
        if all(d.get(k) == v for k, v in want.items()):
            return s.value
    return None


def _fmt(v: float) -> str:
    # the registry never renders NaN (counters/gauges hold real floats),
    # but a scraped page may carry one through a merge
    return "NaN" if math.isnan(v) else _fmt_value(v)


def render_sample(s: Sample) -> str:
    if s.labels:
        inner = ",".join(f'{k}="{_escape(v)}"' for k, v in s.labels)
        return f"{s.name}{{{inner}}} {_fmt(s.value)}"
    return f"{s.name} {_fmt(s.value)}"


def _family_of(name: str) -> str:
    """Histogram/summary series names map back to their family."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _meta_of(text: str) -> Dict[str, Dict[str, str]]:
    """family -> {"help": ..., "type": ...} from # HELP / # TYPE lines."""
    meta: Dict[str, Dict[str, str]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("#"):
            continue
        parts = line.split(None, 3)
        if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
            fam = parts[2]
            meta.setdefault(fam, {})[parts[1].lower()] = (
                parts[3] if len(parts) > 3 else ""
            )
    return meta


def inject_label(s: Sample, label: str, value: str) -> Sample:
    """Add the federation target label; an existing label of the same
    name is preserved as ``exported_<name>`` (Prometheus collision rule)."""
    labels = []
    for k, v in s.labels:
        labels.append((f"exported_{k}" if k == label else k, v))
    return Sample(s.name, ((label, value),) + tuple(labels), s.value)


def merge_expositions(pages: List[Tuple[Optional[str], str]]) -> str:
    """Federate [(peer_label, exposition_text), ...] into one page.

    Every sample gains ``peer="<label>"``; families are regrouped so all
    samples of a family are consecutive with one HELP/TYPE header (first
    scrape's metadata wins). A page with label ``None`` passes through
    without injection — the aggregator's own registry (whose
    ``kungfu_cluster_*`` gauges already carry the right peer labels)
    rides along that way.
    """
    meta: Dict[str, Dict[str, str]] = {}
    families: Dict[str, List[Sample]] = {}
    order: List[str] = []
    for peer_label, text in pages:
        for fam, m in _meta_of(text).items():
            meta.setdefault(fam, m)
        for s in parse_text(text):
            fam = _family_of(s.name)
            if fam not in families:
                families[fam] = []
                order.append(fam)
            families[fam].append(
                s if peer_label is None
                else inject_label(s, "peer", peer_label)
            )
    lines: List[str] = []
    for fam in order:
        m = meta.get(fam, {})
        if m.get("help"):
            lines.append(f"# HELP {fam} {m['help']}")
        if m.get("type"):
            lines.append(f"# TYPE {fam} {m['type']}")
        lines.extend(render_sample(s) for s in families[fam])
    return "\n".join(lines) + ("\n" if lines else "")
