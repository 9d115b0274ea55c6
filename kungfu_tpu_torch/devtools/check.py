"""Single devtools gate: ``python -m kungfu_tpu_torch.devtools.check``.

Port of `kungfu_tpu/devtools/check.py`: one command, one exit code,
every project invariant of the port. It runs the port's full kfcheck
rule set ONCE (per-file cache and all) over `kungfu_tpu_torch/` and
sections the report by concern:

- ``[kfcheck]``      the code rules (KF0xx–KF5xx, KF7xx)
- ``[knobs-doc]``    kungfu_tpu_torch/docs/knobs.md vs the knob
  registry (KF102)
- ``[metric-docs]``  kungfu_tpu_torch/docs/telemetry.md vs registered
  families (KF600/601)
- ``[span-docs]``    the doc's span table vs emitted span kinds (KF602)
- ``[audit-docs]``   the doc's audit event table vs recorded audit
  kinds (KF604)
- ``[signal-docs]``  the doc's policy signal table vs the keys written
  into PolicyContext.metrics (KF605)
- ``[endpoint-docs]`` the doc's endpoint table vs the HTTP routes the
  worker server and cluster aggregator actually serve (KF606)

Exit status is the contract — 0 clean, 1 findings — matching the
kfcheck CLI. ``tests/test_torch_port_kfcheck.py`` invokes it as the
port's gate.
"""

from __future__ import annotations

import argparse
import sys
from typing import List

from kungfu_tpu_torch.devtools.kfcheck import core

_DOC_RULES_KNOBS = ("KF102",)
_DOC_RULES_METRICS = ("KF600", "KF601")
_DOC_RULES_SPANS = ("KF602",)
_DOC_RULES_AUDIT = ("KF604",)
_DOC_RULES_SIGNALS = ("KF605",)
_DOC_RULES_ENDPOINTS = ("KF606",)


def _section(findings: List["core.Finding"], title: str, rules) -> List[str]:
    hits = [f for f in findings if f.rule in rules] if rules else findings
    lines = [f"[{title}] {'clean' if not hits else f'{len(hits)} finding(s)'}"]
    lines.extend("  " + f.render() for f in hits)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m kungfu_tpu_torch.devtools.check",
        description="the whole devtools gate in one invocation: kfcheck "
        "rules, knobs-doc staleness, metric-doc lint (exit 0 = clean)",
    )
    p.add_argument("--no-cache", action="store_true",
                   help="bypass the kfcheck per-file result cache")
    args = p.parse_args(argv)

    core._ensure_rules_loaded()
    findings = core.run_project(use_cache=not args.no_cache)
    doc_rules = (
        set(_DOC_RULES_KNOBS) | set(_DOC_RULES_METRICS)
        | set(_DOC_RULES_SPANS) | set(_DOC_RULES_AUDIT)
        | set(_DOC_RULES_SIGNALS) | set(_DOC_RULES_ENDPOINTS)
    )
    code = [f for f in findings if f.rule not in doc_rules]
    out: List[str] = []
    out.extend(_section(code, "kfcheck", None))
    out.extend(_section(findings, "knobs-doc", _DOC_RULES_KNOBS))
    out.extend(_section(findings, "metric-docs", _DOC_RULES_METRICS))
    out.extend(_section(findings, "span-docs", _DOC_RULES_SPANS))
    out.extend(_section(findings, "audit-docs", _DOC_RULES_AUDIT))
    out.extend(_section(findings, "signal-docs", _DOC_RULES_SIGNALS))
    out.extend(_section(findings, "endpoint-docs", _DOC_RULES_ENDPOINTS))
    n = len(findings)
    out.append(
        "check: clean" if n == 0
        else f"check: {n} finding{'s' if n != 1 else ''}"
    )
    sys.stdout.write("\n".join(out) + "\n")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
