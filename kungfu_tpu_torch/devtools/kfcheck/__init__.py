"""kfcheck: project-wide static analysis for kungfu_tpu_torch.

Port of `kungfu_tpu/devtools/kfcheck/`, aimed at the port's own tree.
The engine is a deeply multithreaded system whose failure modes were
hand-found concurrency bugs; generic linters know nothing about our lock
hierarchy, knob registry or telemetry discipline. kfcheck is the
project-specific layer: an AST-based analyzer with pluggable rules, a
machine-readable findings format and inline suppressions that REQUIRE a
written justification. The rules, their ids, names and logic are the
reference's; only the paths they are bound to name the port's files,
and its docs are `kungfu_tpu_torch/docs/`.

Run: ``python -m kungfu_tpu_torch.devtools.kfcheck [--json]``

Rule families (the reference's docs/devtools.md describes them):

- KF0xx  analyzer/suppression hygiene (parse errors, bad suppressions)
- KF1xx  config registry (KF_* knobs declared + read via
         kungfu_tpu_torch.knobs)
- KF2xx  lock discipline (no blocking under a lock, declared lock order)
- KF3xx  thread lifecycle (daemon or bounded join, bounded waits)
- KF4xx  exception hygiene (no silent broad excepts)
- KF5xx  CLI surface (no bare print outside cli/info and the port's
         counterparts of the reference's root scripts)
- KF6xx  telemetry docs (metric families, spans, audit kinds, policy
         signals and endpoints documented, no ghost rows)
- KF7xx  distributed protocol (the cross-module rules: wire-name
         discipline, knob-consensus coverage, collective symmetry,
         caller-buffer ownership) — paired with the runtime
         collective-order sentinel, devtools/protowatch.py

Suppression format, enforced::

    # kfcheck: disable=KF201 — <why this is safe, in words>

A suppression without a justification is itself a finding (KF001), and
an unused suppression is a finding (KF003), so the suppression surface
cannot rot.
"""

from kungfu_tpu_torch.devtools.kfcheck.core import (  # noqa: F401
    Finding,
    run_project,
)
