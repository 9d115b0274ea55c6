"""Telemetry feature gating and the shared truthy parser.

Port of `kungfu_tpu/telemetry/config.py`. One place answers "is
telemetry on?" for the port's host plane:

- ``KF_TELEMETRY`` selects features by name (``metrics``, ``trace``,
  ``audit``; ``all``/any truthy value enables everything);
- :func:`truthy` is the single truthy-string parser, so
  ``KF_CONFIG_ENABLE_MONITORING=yes`` counts as on.

Feature lookups are cached (they sit near hot paths); tests that flip
the environment at run time call :func:`refresh`.
"""

from __future__ import annotations

from typing import FrozenSet, Optional

from kungfu_tpu_torch import knobs

TELEMETRY_ENV = "KF_TELEMETRY"
KNOWN_FEATURES = frozenset({"metrics", "trace", "audit"})

_TRUTHY = frozenset({"1", "true", "yes", "on", "y", "enabled"})
_FALSY = frozenset({"", "0", "false", "no", "off", "n", "disabled", "none"})


def truthy(value) -> bool:
    """Normalize a boolean-ish env value ("1"/"true"/"yes"/"on"/...)."""
    return str(value).strip().lower() in _TRUTHY


def env_truthy(name: str, default: str = "") -> bool:
    """Truthiness of a DECLARED boolean knob (`kungfu_tpu_torch/knobs.py`;
    an undeclared name is an error)."""
    try:
        raw = knobs.raw(name)
    except KeyError:
        raise KeyError(
            f"{name} is not a declared knob — declare it in "
            "kungfu_tpu_torch/knobs.py (name, default, parser, doc) before "
            "reading it"
        ) from None
    return truthy(raw or default)


_cache: dict = {"features": None, "forced": None}


def _parse_features(raw: str) -> FrozenSet[str]:
    raw = raw.strip().lower()
    if not raw or raw in _FALSY:
        return frozenset()
    if raw in ("all", "*") or raw in _TRUTHY:
        return KNOWN_FEATURES
    out = set()
    unknown = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if part in ("all", "*"):
            return KNOWN_FEATURES
        if part in KNOWN_FEATURES:
            out.add(part)
        else:
            unknown.append(part)
    if unknown:
        # a typo'd feature must not silently disable telemetry
        from kungfu_tpu_torch.telemetry import log

        log.warn(
            "%s: unknown feature(s) %s (known: %s)",
            TELEMETRY_ENV, ",".join(unknown), ",".join(sorted(KNOWN_FEATURES)),
        )
    return frozenset(out)


def features() -> FrozenSet[str]:
    """Enabled telemetry features (cached; see refresh())."""
    if _cache["forced"] is not None:
        return _cache["forced"]
    if _cache["features"] is None:
        _cache["features"] = _parse_features(knobs.raw(TELEMETRY_ENV))
    return _cache["features"]


def enabled(feature: str) -> bool:
    return feature in features()


def metrics_enabled() -> bool:
    """Metrics are on under KF_TELEMETRY=metrics OR the reference's
    KF_CONFIG_ENABLE_MONITORING knob."""
    return "metrics" in features() or env_truthy("KF_CONFIG_ENABLE_MONITORING")


def trace_enabled() -> bool:
    return "trace" in features()


# Per-step walk spans (host.rs.step / host.ag.step) are O(k * buckets)
# a training step and would evict everything else from the trace window
# on long runs; KF_TELEMETRY_SPAN_SAMPLE keeps one walk in 1/rate fully
# annotated (deterministic, not random: identical across reruns).
SPAN_SAMPLE_ENV = "KF_TELEMETRY_SPAN_SAMPLE"


def span_sample() -> float:
    """Fraction of walks whose per-step spans are emitted, in [0, 1]. A
    malformed value warns and reads as 1.0."""
    return min(max(knobs.get(SPAN_SAMPLE_ENV), 0.0), 1.0)


def enable(*names: str) -> None:
    """Force features on programmatically (tests, embedding)."""
    cur = _cache["forced"] or features()
    _cache["forced"] = frozenset(cur) | frozenset(
        n for n in names if n in KNOWN_FEATURES
    )


def refresh(forced: Optional[FrozenSet[str]] = None) -> None:
    """Drop caches and re-read the environment (tests flip env at runtime)."""
    _cache["features"] = None
    _cache["forced"] = forced
