"""kfcheck core: file walking, AST contexts, rule registry, inline
suppressions, the findings model and the per-file result cache.

Port of `kungfu_tpu/devtools/kfcheck/core.py`, aimed at the port's own
tree: the package scanned by default is `kungfu_tpu_torch/`, the docs
the project rules read live in `kungfu_tpu_torch/docs/` (inside the
package, beside the code they describe), and the cache file is the
port's own `.kfcheck-torch-cache.json` (sharing the reference's would
let each analyzer's prune() drop the other's entries).

Design: rules are plain functions registered with :func:`rule`. File
rules get a :class:`FileContext` (path, source, AST, module constants,
comment map); project rules get the :class:`Project` (every file context
plus repo paths) and run once — they own cross-file invariants like
"docs/knobs.md matches the registry" or the KF7xx distributed-protocol
family.

Caching: each file's *raw* file-rule findings plus
the per-file **facts** the project rules consume (module string
constants, imports, knob literals, environment reads, wire-name call
sites, suppressions) are cached in ``<repo>/.kfcheck-torch-cache.json`` keyed
on (content sha256, rule-set version = hash of core.py + rules.py).
A cache hit skips ``ast.parse`` and the tokenizer entirely; the AST
stays available lazily (the :attr:`FileContext.tree` property parses on
first access) for the few project rules that need real trees (KF701
reads exactly two files). Suppressions are re-applied per run from the
cached facts, so a cached file behaves identically to a fresh one.
``--no-cache`` (or ``run_project(use_cache=False)``) bypasses it.

Suppressions are line-anchored comments::

    x = risky()  # kfcheck: disable=KF200 — send timeout bounds the hold

    # kfcheck: disable=KF301 — waiting ON the abort signal is abort-aware
    flag.wait()

A suppression must carry a justification after an em-dash/`--`/`-`
separator; bare ``disable=KF200`` is a KF001 finding. Suppressions that
match no finding are KF003 findings — a stale suppression hides nothing
but still rots trust in the ones that matter. ``disable-file=`` scopes a
rule off for a whole file (same justification contract).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import re
import tokenize
from typing import Callable, Dict, Iterable, List, Optional, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# rule ids for the analyzer's own meta findings
PARSE_ERROR = "KF000"
SUPPRESSION_NO_REASON = "KF001"
SUPPRESSION_UNKNOWN_RULE = "KF002"
SUPPRESSION_UNUSED = "KF003"

_META_RULES = {
    PARSE_ERROR: "file does not parse",
    SUPPRESSION_NO_REASON: "suppression missing a written justification",
    SUPPRESSION_UNKNOWN_RULE: "suppression names an unknown rule",
    SUPPRESSION_UNUSED: "suppression matches no finding (stale)",
}

# a whole-string knob name: KF_WIRE, KF_CONFIG_ALGO ... but not the bare
# "KF_"/"KF_CONFIG_" prefixes used for startswith() filters (shared by
# the fact extractor here and rules KF100/KF101)
KNOB_RE = re.compile(r"^KF_[A-Z0-9_]*[A-Z0-9]$")


def _attr_chain(node: ast.AST) -> Optional[str]:
    """Dotted name for Name/Attribute chains ("os.environ.get"), else
    None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    line: int  # line the comment sits on
    rules: Tuple[str, ...]
    reason: str
    file_scope: bool
    target: int  # code line covered (== line for trailing comments; the
    # next non-comment/non-blank line for comment-only lines, so a
    # justification may span several comment lines above the code)
    used: bool = False

    def covers(self, rule: str, line: int) -> bool:
        if rule not in self.rules:
            return False
        if self.file_scope:
            return True
        return line == self.target


_SUPPRESS_RE = re.compile(
    r"#\s*kfcheck:\s*(disable(?:-file)?)\s*=\s*"
    r"([A-Za-z0-9_,\s]*?)\s*(?:(?:—|–|--|-)\s*(.*))?$"
)

# environment-read call chains (fact extraction for KF101)
_ENV_READ_CHAINS = ("os.environ.get", "environ.get", "os.getenv", "getenv")

# wire-name call sites (fact extraction for KF700): method/ctor name ->
# (positional index of the name argument, keyword name). Workspace's
# `name` is the rendezvous identity every walk message derives from;
# the others take an explicit wire/consensus name.
_NAME_SITES = {
    "Workspace": (3, "name"),
    "all_gather_shards": (1, "name"),
    "broadcast_bytes": (1, "name"),
    "bytes_consensus": (1, "name"),
    "consensus": (1, "name"),
    "barrier": (0, "tag"),
}

_UNPARSED = object()


def _name_desc(expr: Optional[ast.expr]) -> Optional[dict]:
    """Compact, JSON-able descriptor of a wire-name expression (cached as
    a fact). `const` descriptors are the KF700 findings-to-be; `name` and
    `attr` resolve against module constants at rule time; `dyn` means the
    name carries runtime content (round stamps, identities) and passes."""
    if expr is None:
        return None
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return {"t": "const", "v": expr.value}
    if isinstance(expr, ast.JoinedStr):
        if any(isinstance(v, ast.FormattedValue) for v in expr.values):
            return {"t": "dyn"}
        parts = [v.value for v in expr.values
                 if isinstance(v, ast.Constant) and isinstance(v.value, str)]
        return {"t": "const", "v": "".join(parts)}
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _name_desc(expr.left)
        right = _name_desc(expr.right)
        if (left and right and left["t"] == "const"
                and right["t"] == "const"):
            return {"t": "const", "v": left["v"] + right["v"]}
        return {"t": "dyn"}
    if isinstance(expr, ast.Name):
        return {"t": "name", "v": expr.id}
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
        return {"t": "attr", "base": expr.value.id, "attr": expr.attr}
    return {"t": "dyn"}


class FileContext:
    """One analyzed file. Constructed either by parsing (fresh) or from
    cached facts (no parse); :attr:`tree` parses lazily in the cached
    case so project rules that need a real AST still get one."""

    def __init__(self, path: str, relpath: str, source: str,
                 cached: Optional[dict] = None, sha: Optional[str] = None):
        self.path = path
        self.relpath = relpath
        self.source = source
        # load_files passes the digest it already computed for the cache
        # lookup; direct constructions (fixture tests) compute their own
        self.sha = sha or hashlib.sha256(source.encode("utf-8")).hexdigest()
        self.lines = source.splitlines()
        self._tree = _UNPARSED
        self._nodes: Optional[Tuple[ast.AST, ...]] = None
        self.parse_error: Optional[str] = None
        self.suppressions: List[Suppression] = []
        self.malformed: List[Finding] = []  # KF001 raised during parse
        # facts (project-rule inputs; all JSON-able)
        self.str_constants: Dict[str, str] = {}
        # local name -> (source module basename, original name) for
        # `from pkg.mod import NAME [as alias]` — lets rules resolve
        # constants imported from other analyzed modules
        self.imported_names: Dict[str, Tuple[str, str]] = {}
        self.knob_literals: List[Tuple[int, str]] = []
        self.env_reads: List[Tuple[int, dict]] = []
        self.name_sites: List[Tuple[int, str, dict]] = []
        self.from_cache = cached is not None
        # raw file-rule findings restored from the cache (None = compute)
        self.cached_findings: Optional[List[Finding]] = None
        if cached is not None:
            self._load_cached(cached)
        else:
            self._parse()
            self._scan_comments()
            if self._tree is not None and self._tree is not _UNPARSED:
                self._extract_facts()

    # -- parsing ------------------------------------------------------

    @property
    def tree(self) -> Optional[ast.AST]:
        if self._tree is _UNPARSED:
            self._parse()
        return self._tree

    def _parse(self) -> None:
        try:
            self._tree = ast.parse(self.source, filename=self.path)
        except SyntaxError as e:
            self._tree = None
            self.parse_error = f"{e.msg} (line {e.lineno})"

    def walk(self) -> Iterable[ast.AST]:
        """Every node of the tree in ast.walk's order, walked once per
        file: the fact extractor, the file rules and the project rules
        that scan every tree (KF602/604/605) reuse the same node list."""
        if self.tree is None:
            return ()
        if self._nodes is None:
            self._nodes = tuple(ast.walk(self.tree))
        return self._nodes

    # -- fact extraction (one walk, everything project rules consume) --

    def _extract_facts(self) -> None:
        for node in self._tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)
            ):
                self.str_constants[node.targets[0].id] = node.value.value
            elif isinstance(node, ast.ImportFrom) and node.module:
                mod = node.module.rsplit(".", 1)[-1]
                for alias in node.names:
                    self.imported_names[alias.asname or alias.name] = (
                        mod, alias.name,
                    )
        for node in self.walk():
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and KNOB_RE.match(node.value)):
                self.knob_literals.append((node.lineno, node.value))
            elif isinstance(node, ast.Call):
                self._extract_env_read(node)
                self._extract_name_site(node)
            elif (
                isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and _attr_chain(node.value) in ("os.environ", "environ")
            ):
                desc = _name_desc(node.slice)
                if desc is not None:
                    self.env_reads.append((node.lineno, desc))

    def _extract_env_read(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        if chain in _ENV_READ_CHAINS and node.args:
            desc = _name_desc(node.args[0])
            if desc is not None:
                self.env_reads.append((node.lineno, desc))

    def _extract_name_site(self, node: ast.Call) -> None:
        seg = None
        if isinstance(node.func, ast.Attribute):
            seg = node.func.attr
        elif isinstance(node.func, ast.Name):
            seg = node.func.id
        if seg not in _NAME_SITES:
            return
        if seg != "Workspace" and not isinstance(node.func, ast.Attribute):
            # the collective entry points are methods (sess.barrier(...));
            # bare-name calls of e.g. `consensus` are unrelated helpers
            return
        pos, kw = _NAME_SITES[seg]
        expr = None
        for k in node.keywords:
            if k.arg == kw:
                expr = k.value
                break
        if expr is None and len(node.args) > pos:
            expr = node.args[pos]
        if expr is None:
            return
        desc = _name_desc(expr)
        if desc is not None:
            self.name_sites.append((node.lineno, seg, desc))

    # -- suppression comments -----------------------------------------

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.source).readline)
            comments = [
                (t.start[0], t.start[1], t.string)
                for t in tokens
                if t.type == tokenize.COMMENT
            ]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return
        for lineno, col, text in comments:
            m = _SUPPRESS_RE.search(text)
            if m is None:
                if "kfcheck:" in text:
                    self.malformed.append(Finding(
                        SUPPRESSION_NO_REASON, self.relpath, lineno,
                        f"unparseable kfcheck comment: {text.strip()!r}",
                    ))
                continue
            kind, rules_raw, reason = m.group(1), m.group(2), m.group(3)
            rules = tuple(
                r.strip().upper() for r in rules_raw.split(",") if r.strip()
            )
            reason = (reason or "").strip()
            if not rules or not reason:
                self.malformed.append(Finding(
                    SUPPRESSION_NO_REASON, self.relpath, lineno,
                    "suppression must name rule(s) and carry a written "
                    "justification: `# kfcheck: disable=KFxxx — <why>`",
                ))
                continue
            target = lineno
            if self.lines[lineno - 1].strip().startswith("#"):
                # comment-only line: cover the next code line, skipping
                # the rest of the justification block
                target = lineno + 1
                while target <= len(self.lines):
                    stripped = self.lines[target - 1].strip()
                    if stripped and not stripped.startswith("#"):
                        break
                    target += 1
            self.suppressions.append(Suppression(
                line=lineno,
                rules=rules,
                reason=reason,
                file_scope=(kind == "disable-file"),
                target=target,
            ))

    # -- cache (de)serialization --------------------------------------

    def facts_to_cache(self) -> dict:
        return {
            "parse_error": self.parse_error,
            "str_constants": self.str_constants,
            "imported_names": {
                k: list(v) for k, v in self.imported_names.items()
            },
            "knob_literals": [list(t) for t in self.knob_literals],
            "env_reads": [list(t) for t in self.env_reads],
            "name_sites": [list(t) for t in self.name_sites],
            "suppressions": [
                {
                    "line": s.line, "rules": list(s.rules),
                    "reason": s.reason, "file_scope": s.file_scope,
                    "target": s.target,
                }
                for s in self.suppressions
            ],
            "malformed": [f.to_json() for f in self.malformed],
        }

    def _load_cached(self, cached: dict) -> None:
        facts = cached["facts"]
        self.parse_error = facts["parse_error"]
        self.str_constants = dict(facts["str_constants"])
        self.imported_names = {
            k: tuple(v) for k, v in facts["imported_names"].items()
        }
        self.knob_literals = [tuple(t) for t in facts["knob_literals"]]
        self.env_reads = [(t[0], t[1]) for t in facts["env_reads"]]
        self.name_sites = [(t[0], t[1], t[2]) for t in facts["name_sites"]]
        self.suppressions = [
            Suppression(
                line=s["line"], rules=tuple(s["rules"]), reason=s["reason"],
                file_scope=s["file_scope"], target=s["target"],
            )
            for s in facts["suppressions"]
        ]
        self.malformed = [Finding(**f) for f in facts["malformed"]]
        self.cached_findings = [Finding(**f) for f in cached["findings"]]


# the port's docs (knobs.md, telemetry.md), relative to the repo root
DOCS_DIR = "kungfu_tpu_torch/docs"


class Project:
    """Everything the project-level rules need: the analyzed package,
    the repo root (the docs live under it, in DOCS_DIR) and every parsed
    file."""

    def __init__(self, pkg_root: str, repo_root: str,
                 files: List[FileContext]):
        self.pkg_root = pkg_root
        self.repo_root = repo_root
        self.files = files


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    help: str
    fn: Callable
    scope: str  # "file" | "project"


RULES: Dict[str, Rule] = {}


def rule(id: str, name: str, help: str, *, scope: str = "file"):
    """Register a rule. File rules: fn(ctx: FileContext) -> [Finding].
    Project rules: fn(project: Project) -> [Finding]."""

    def deco(fn):
        if id in RULES:
            raise ValueError(f"rule {id} registered twice")
        RULES[id] = Rule(id=id, name=name, help=help, fn=fn, scope=scope)
        return fn

    return deco


def known_rule_ids() -> List[str]:
    return sorted(set(RULES) | set(_META_RULES))


def _iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d for d in dirnames if d != "__pycache__" and not d.startswith(".")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


# ---------------------------------------------------------------------
# the per-file result cache
# ---------------------------------------------------------------------

CACHE_NAME = ".kfcheck-torch-cache.json"

_ruleset_version_memo: Optional[str] = None


def ruleset_version() -> str:
    """Hash of the analyzer's own source (core.py + rules.py): any rule
    edit — new rule, changed pattern, changed fact extraction —
    invalidates every cache entry. Self-maintaining, no manual bump."""
    global _ruleset_version_memo
    if _ruleset_version_memo is None:
        h = hashlib.sha256()
        here = os.path.dirname(os.path.abspath(__file__))
        for name in ("core.py", "rules.py"):
            with open(os.path.join(here, name), "rb") as f:
                h.update(f.read())
        _ruleset_version_memo = h.hexdigest()
    return _ruleset_version_memo


class ResultCache:
    """Per-file raw findings + facts keyed on (content sha, rule-set
    version). Unreadable/corrupt/mismatched caches are silently treated
    as empty — the cache can only skip work, never change results."""

    def __init__(self, repo_root: str):
        self.path = os.path.join(repo_root, CACHE_NAME)
        self.files: Dict[str, dict] = {}
        self.dirty = False
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            if data.get("version") == ruleset_version():
                self.files = data.get("files", {})
        except (OSError, ValueError, KeyError, TypeError):
            pass

    def lookup(self, relpath: str, sha: str) -> Optional[dict]:
        entry = self.files.get(relpath)
        if entry is not None and entry.get("sha") == sha:
            return entry
        return None

    def store(self, ctx: FileContext, findings: List[Finding]) -> None:
        self.files[ctx.relpath] = {
            "sha": ctx.sha,
            "facts": ctx.facts_to_cache(),
            "findings": [f.to_json() for f in findings],
        }
        self.dirty = True

    def prune(self, live_relpaths: Iterable[str]) -> None:
        live = set(live_relpaths)
        for gone in [p for p in self.files if p not in live]:
            del self.files[gone]
            self.dirty = True

    def save(self) -> None:
        if not self.dirty:
            return
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {"version": ruleset_version(), "files": self.files}, f
                )
            os.replace(tmp, self.path)
        except OSError:
            # a read-only checkout just runs uncached
            try:
                os.unlink(tmp)
            except OSError:
                pass


def load_files(pkg_root: str, repo_root: str,
               cache: Optional[ResultCache] = None) -> List[FileContext]:
    out = []
    for path in _iter_py_files(pkg_root):
        rel = os.path.relpath(path, repo_root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            source = f.read()
        sha = hashlib.sha256(source.encode("utf-8")).hexdigest()
        cached = cache.lookup(rel, sha) if cache is not None else None
        out.append(FileContext(path, rel, source, cached=cached, sha=sha))
    return out


def _ensure_rules_loaded() -> None:
    # import for side effect: each module registers its rules
    from kungfu_tpu_torch.devtools.kfcheck import rules as _rules  # noqa: F401


def run_project(
    pkg_root: Optional[str] = None,
    repo_root: Optional[str] = None,
    select: Optional[Iterable[str]] = None,
    use_cache: bool = True,
) -> List[Finding]:
    """Run every (selected) rule over the package; returns unsuppressed
    findings plus suppression-hygiene findings, sorted by location.

    With `use_cache` (the default) unchanged files skip parsing and the
    file-scope rules, reusing cached raw findings; the cache is only
    WRITTEN by full runs (`select=None` — a subset run computes a subset
    of findings, which must never masquerade as a file's complete
    result)."""
    _ensure_rules_loaded()
    repo_root = repo_root or REPO_ROOT
    pkg_root = pkg_root or os.path.join(repo_root, "kungfu_tpu_torch")
    selected = set(select) if select else None

    cache = ResultCache(repo_root) if use_cache else None
    files = load_files(pkg_root, repo_root, cache)
    project = Project(pkg_root, repo_root, files)

    findings: List[Finding] = []
    raw: List[Finding] = []

    file_rules = [r for r in RULES.values() if r.scope == "file"]
    for ctx in files:
        findings.extend(ctx.malformed)
        for sup in ctx.suppressions:
            for rid in sup.rules:
                if rid not in RULES and rid not in _META_RULES:
                    findings.append(Finding(
                        SUPPRESSION_UNKNOWN_RULE, ctx.relpath, sup.line,
                        f"suppression names unknown rule {rid!r} "
                        f"(known: {', '.join(known_rule_ids())})",
                    ))
        if ctx.parse_error is not None:
            findings.append(Finding(
                PARSE_ERROR, ctx.relpath, 1, ctx.parse_error))
            continue
        if ctx.cached_findings is not None:
            raw.extend(
                f for f in ctx.cached_findings
                if selected is None or f.rule in selected
            )
            continue
        computed: List[Finding] = []
        for r in file_rules:
            if selected is not None and r.id not in selected:
                continue
            computed.extend(r.fn(ctx))
        raw.extend(computed)
        if cache is not None and selected is None:
            cache.store(ctx, computed)

    for r in RULES.values():
        if r.scope != "project":
            continue
        if selected is not None and r.id not in selected:
            continue
        raw.extend(r.fn(project))

    # apply suppressions
    by_rel: Dict[str, FileContext] = {f.relpath: f for f in files}
    for f in raw:
        ctx = by_rel.get(f.path)
        sup = None
        if ctx is not None:
            for s in ctx.suppressions:
                if s.covers(f.rule, f.line):
                    sup = s
                    break
        if sup is not None:
            sup.used = True
        else:
            findings.append(f)

    # stale suppressions (skip when a rule subset is selected: the rules
    # that would have used them did not run)
    if selected is None:
        for ctx in files:
            for s in ctx.suppressions:
                if not s.used:
                    findings.append(Finding(
                        SUPPRESSION_UNUSED, ctx.relpath, s.line,
                        f"suppression for {','.join(s.rules)} matches no "
                        "finding — remove it (stale suppressions rot trust "
                        "in the live ones)",
                    ))

    if cache is not None and selected is None:
        cache.prune(f.relpath for f in files)
        cache.save()

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def to_json(findings: List[Finding]) -> str:
    return json.dumps([f.to_json() for f in findings], indent=2) + "\n"
