"""CLI entry point: ``python -m kungfu_tpu_torch.devtools.kfcheck``.

Port of `kungfu_tpu/devtools/kfcheck/__main__.py`. Exit status is the
contract — 0 means the tree is clean (every suppression justified), 1
means findings, 2 means usage error. CI and the tests key off it.
"""

from __future__ import annotations

import argparse
import sys

from kungfu_tpu_torch.devtools.kfcheck import core


def _write_knobs_doc(repo_root: str) -> str:
    import os

    from kungfu_tpu_torch import knobs

    path = os.path.join(repo_root, core.DOCS_DIR, "knobs.md")
    with open(path, "w", encoding="utf-8") as f:
        f.write(knobs.render_doc())
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m kungfu_tpu_torch.devtools.kfcheck",
        description="project-specific static analysis for kungfu_tpu_torch "
        "(config registry, lock discipline, thread lifecycle, exception "
        "hygiene, CLI/doc lint)",
    )
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--select", default="",
                   help="comma-separated rule ids to run (default: all; "
                   "stale-suppression findings are skipped for subsets)")
    p.add_argument("--list-rules", action="store_true",
                   help="print every rule id + description and exit")
    p.add_argument("--no-cache", action="store_true",
                   help="bypass the per-file result cache "
                   "(.kfcheck-torch-cache.json): re-parse and re-analyze "
                   "every file")
    p.add_argument("--write-knobs-doc", action="store_true",
                   help="regenerate kungfu_tpu_torch/docs/knobs.md from the "
                   "knob registry "
                   "and exit")
    args = p.parse_args(argv)

    if args.write_knobs_doc:
        path = _write_knobs_doc(core.REPO_ROOT)
        sys.stdout.write(f"wrote {path}\n")
        return 0

    core._ensure_rules_loaded()
    if args.list_rules:
        for rid in core.known_rule_ids():
            r = core.RULES.get(rid)
            desc = r.help if r is not None else core._META_RULES[rid]
            name = r.name if r is not None else "meta"
            sys.stdout.write(f"{rid}  {name}\n    {desc}\n")
        return 0

    select = None
    if args.select:
        select = [s.strip().upper() for s in args.select.split(",")
                  if s.strip()]
        unknown = [s for s in select if s not in core.known_rule_ids()]
        if unknown:
            sys.stderr.write(
                f"unknown rule id(s): {', '.join(unknown)} "
                f"(see --list-rules)\n"
            )
            return 2

    findings = core.run_project(select=select, use_cache=not args.no_cache)
    if args.json:
        sys.stdout.write(core.to_json(findings))
    else:
        for f in findings:
            sys.stdout.write(f.render() + "\n")
        n = len(findings)
        sys.stdout.write(
            "kfcheck: clean\n" if n == 0
            else f"kfcheck: {n} finding{'s' if n != 1 else ''}\n"
        )
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
