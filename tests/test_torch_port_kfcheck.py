"""The port's static analyzer (`kungfu_tpu_torch/devtools/kfcheck`,
`devtools/check.py`) against the reference's (`kungfu_tpu/devtools/`).

- every fixture snippet of tests/test_kfcheck.py, run through both
  analyzers' rule with the relpath mapped from `kungfu_tpu/` to
  `kungfu_tpu_torch/`, gives equal findings (rule, line, message with the
  package name and the docs root mapped);
- both list the same rule ids and names;
- each analyzer over the other's tree, renamed, finds what its own
  analyzer finds there: nothing;
- one planted violation per rule in a cached copy of the port's tree
  gives exactly that finding, at the file and line planted, so "clean"
  is never vacuous;
- the suppression contract and the per-file cache, against the port's
  own cache file;
- the gate, `python -m kungfu_tpu_torch.devtools.check`, exits 0;
- the port's docs: the five tables of kungfu_tpu_torch/docs/telemetry.md
  name what docs/telemetry.md names (one declared departure), and
  kungfu_tpu_torch/docs/knobs.md is the registry's render.

Everything runs in process but the gate; no world is spawned.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import kungfu_tpu
import kungfu_tpu_torch
from kungfu_tpu import knobs as ref_knobs
from kungfu_tpu.devtools.kfcheck import __main__ as ref_main
from kungfu_tpu.devtools.kfcheck import core as ref_core
from kungfu_tpu.devtools.kfcheck import rules as ref_R
from kungfu_tpu_torch import knobs as port_knobs
from kungfu_tpu_torch.devtools.kfcheck import __main__ as port_main
from kungfu_tpu_torch.devtools.kfcheck import core as port_core
from kungfu_tpu_torch.devtools.kfcheck import rules as port_R

REPO = Path(__file__).resolve().parent.parent
PORT_PKG = REPO / "kungfu_tpu_torch"
REF_PKG = REPO / "kungfu_tpu"
REF_TESTS = REPO / "tests" / "test_kfcheck.py"

ref_core._ensure_rules_loaded()
port_core._ensure_rules_loaded()


def to_port(text: str) -> str:
    """A reference path or message as the port spells it: the package
    renamed, and the docs root moved into the package."""
    text = re.sub(r"\bkungfu_tpu\b", "kungfu_tpu_torch", text)
    return re.sub(r"(?<![\w/])docs/", "kungfu_tpu_torch/docs/", text)


def to_ref(relpath: str) -> str:
    """A port relpath as it reads in a renamed copy of the port."""
    return re.sub(r"^kungfu_tpu_torch/", "kungfu_tpu/", relpath)


def mapped(findings):
    return [(f.rule, to_port(f.path), f.line, to_port(f.message)) for f in findings]


def plain(findings):
    return [(f.rule, f.path, f.line, f.message) for f in findings]


# ---------------------------------------------------------------------------
# (a) the reference's fixture snippets, through both analyzers
# ---------------------------------------------------------------------------

DEFAULT_REL = "kungfu_tpu/snippet.py"


def _module_env(tree):
    """The module-level string constants of tests/test_kfcheck.py."""
    env = {"textwrap": textwrap, "os": os}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            try:
                env[node.targets[0].id] = eval(  # noqa: S307 - our own test file
                    compile(ast.Expression(node.value), str(REF_TESTS), "eval"), dict(env))
            except Exception:  # noqa: BLE001 - only plain constants are wanted
                pass
    return env


def _eval(expr, env):
    return eval(compile(ast.Expression(expr), str(REF_TESTS), "eval"), dict(env))  # noqa: S307


def _calls_in_order(stmt):
    calls = [n for n in ast.walk(stmt) if isinstance(n, ast.Call)]
    return sorted(calls, key=lambda c: (c.lineno, c.col_offset))


def _snippets():
    """(id, kind, rule function or select, [(relpath, source)]) for every
    snippet the reference's tests hand a rule: `run_rule(R.check_x, src,
    rel)`, `R.check_x(project_of(...))` and `run_tmp_project(..., select)`."""
    tree = ast.parse(REF_TESTS.read_text())
    env0 = _module_env(tree)
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
            continue
        env, projects, n = dict(env0), {}, 0
        for stmt in fn.body:
            for call in _calls_in_order(stmt):
                name = call.func.id if isinstance(call.func, ast.Name) else None
                if name == "run_rule":
                    rule_fn = call.args[0].attr
                    src = _eval(call.args[1], env)
                    rel = _eval(call.args[2], env) if len(call.args) > 2 else DEFAULT_REL
                    out.append((f"{fn.name}-{n}", "file", rule_fn,
                                [(rel, textwrap.dedent(src))]))
                    n += 1
                elif name == "run_tmp_project":
                    files = _eval(call.args[1], env)
                    sel = next((_eval(k.value, env) for k in call.keywords
                                if k.arg == "select"), None)
                    out.append((f"{fn.name}-{n}", "tmp", sel,
                                [(f"kungfu_tpu/{r}", textwrap.dedent(s))
                                 for r, s in files.items()]))
                    n += 1
                elif (isinstance(call.func, ast.Attribute)
                      and isinstance(call.func.value, ast.Name)
                      and call.func.value.id == "R" and call.args
                      and isinstance(call.args[0], ast.Name)
                      and call.args[0].id in projects):
                    out.append((f"{fn.name}-{n}", "project", call.func.attr,
                                projects[call.args[0].id]))
                    n += 1
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                target, value = stmt.targets[0].id, stmt.value
                if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
                        and value.func.id == "project_of":
                    projects[target] = [
                        (rel, textwrap.dedent(src))
                        for rel, src in (_eval(a, env) for a in value.args)]
                else:
                    try:
                        env[target] = _eval(value, env)
                    except Exception:  # noqa: BLE001 - a runtime value, not a snippet
                        pass
    return out


SNIPPETS = _snippets()


def test_the_snippet_scan_finds_every_rule_the_reference_tests_by_snippet():
    fns = {s[2] for s in SNIPPETS if s[1] in ("file", "project")}
    assert fns == {
        "check_knob_declared", "check_env_reads", "check_blocking_under_lock",
        "check_lock_hierarchy", "check_thread_lifecycle", "check_unbounded_wait",
        "check_unbounded_join", "check_scheduler_threads", "check_silent_broad_except",
        "check_bare_print", "check_wire_names", "check_consensus_coverage",
        "check_collective_symmetry", "check_caller_buffer_ownership"}
    assert sum(s[1] == "tmp" for s in SNIPPETS) >= 6
    assert len(SNIPPETS) >= 45


def _write_tree(root: Path, pkg: str, files):
    for rel, src in files:
        path = root / (pkg + rel[len("kungfu_tpu"):])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)


@pytest.mark.parametrize("snippet", SNIPPETS, ids=[s[0] for s in SNIPPETS])
def test_a_reference_snippet_gives_the_same_findings_in_both(snippet, tmp_path):
    _, kind, what, files = snippet
    if kind == "file":
        (rel, src), = files
        ref = getattr(ref_R, what)(ref_core.FileContext("/tmp/snippet.py", rel, src))
        port = getattr(port_R, what)(port_core.FileContext("/tmp/snippet.py", to_port(rel), src))
    elif kind == "project":
        ref = getattr(ref_R, what)(ref_core.Project("/tmp/pkg", "/tmp/repo", [
            ref_core.FileContext("/tmp/snippet.py", rel, src) for rel, src in files]))
        port = getattr(port_R, what)(port_core.Project("/tmp/pkg", "/tmp/repo", [
            port_core.FileContext("/tmp/snippet.py", to_port(rel), src) for rel, src in files]))
    else:
        _write_tree(tmp_path / "ref", "kungfu_tpu", files)
        _write_tree(tmp_path / "port", "kungfu_tpu_torch", files)
        ref = ref_core.run_project(pkg_root=str(tmp_path / "ref" / "kungfu_tpu"),
                                   repo_root=str(tmp_path / "ref"), select=what)
        port = port_core.run_project(pkg_root=str(tmp_path / "port" / "kungfu_tpu_torch"),
                                     repo_root=str(tmp_path / "port"), select=what)
    assert mapped(ref) == plain(port)


# ---------------------------------------------------------------------------
# (b) the rule set
# ---------------------------------------------------------------------------

def _listed(main, capsys):
    assert main.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    return re.findall(r"^(KF\d{3})  (\S+)$", out, re.M)


def test_list_rules_names_the_same_25_ids_in_both(capsys):
    ref, port = _listed(ref_main, capsys), _listed(port_main, capsys)
    assert port == ref
    assert len(port) == 25
    assert len(port_core.RULES) == 21
    assert port_core.known_rule_ids() == ref_core.known_rule_ids()


# help texts are the reference's with the paths mapped, but for two that
# drop the numbers of the changes they were learned from
HELP_DEPARTURES = {"KF700", "KF703"}


@pytest.mark.parametrize("rid", sorted(ref_core.RULES))
def test_a_rule_keeps_its_name_scope_and_help(rid):
    ref, port = ref_core.RULES[rid], port_core.RULES[rid]
    assert (port.name, port.scope, port.fn.__name__) == (ref.name, ref.scope, ref.fn.__name__)
    if rid not in HELP_DEPARTURES:
        assert port.help == to_port(ref.help)
    else:
        assert re.sub(r"\(the .*\)$", "", port.help) == \
            re.sub(r"\(the .*\)$", "", ref.help)


def test_the_meta_rules_are_the_references():
    assert port_core._META_RULES == ref_core._META_RULES


def test_the_cli_contract(capsys, monkeypatch, tmp_path):
    assert port_main.main(["--select", "KF9ZZ"]) == 2
    assert "unknown rule id" in capsys.readouterr().err
    monkeypatch.setattr(port_core, "REPO_ROOT", str(tmp_path))
    (tmp_path / "kungfu_tpu_torch" / "docs").mkdir(parents=True)
    assert port_main.main(["--write-knobs-doc"]) == 0
    assert capsys.readouterr().out.startswith("wrote ")
    assert (tmp_path / "kungfu_tpu_torch" / "docs" / "knobs.md").read_text() == \
        port_knobs.render_doc()
    # a tree with one finding: exit 1, and --json gives it
    pkg = tmp_path / "kungfu_tpu_torch"
    (pkg / "x.py").write_text("def f(ev):\n    ev.wait()\n")
    assert port_main.main(["--json", "--select", "KF301", "--no-cache"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert got == [{"rule": "KF301", "path": "kungfu_tpu_torch/x.py", "line": 2,
                    "message": got[0]["message"]}]


def test_the_ruleset_version_hashes_the_ports_own_sources():
    assert port_core.ruleset_version() != ref_core.ruleset_version()
    assert port_core.CACHE_NAME == ".kfcheck-torch-cache.json" != ref_core.CACHE_NAME


# ---------------------------------------------------------------------------
# (c) each analyzer over the other's tree, renamed
# ---------------------------------------------------------------------------

def _copy_tree(src_pkg: Path, dst_pkg: Path, docs_src: Path, docs_dst: Path):
    shutil.copytree(src_pkg, dst_pkg, ignore=lambda d, names: [
        n for n in names
        if n == "__pycache__" or (not n.endswith(".py") and not (Path(d) / n).is_dir())])
    shutil.rmtree(dst_pkg / "docs", ignore_errors=True)
    docs_dst.mkdir(parents=True, exist_ok=True)
    for name in ("knobs.md", "telemetry.md"):
        shutil.copy(docs_src / name, docs_dst / name)


def test_the_reference_over_the_renamed_port_finds_what_the_port_finds(tmp_path, monkeypatch):
    _copy_tree(PORT_PKG, tmp_path / "kungfu_tpu", PORT_PKG / "docs", tmp_path / "docs")
    # the renamed tree's registry is the port's
    monkeypatch.setattr(kungfu_tpu, "knobs", port_knobs)
    # the one declared departure: the port's counterparts of the
    # reference's root scripts, exempt from KF500 in the port's analyzer
    monkeypatch.setattr(ref_R, "_PRINT_EXEMPT_PREFIX", ref_R._PRINT_EXEMPT_PREFIX + tuple(
        to_ref(p) for p in port_R._PRINT_EXEMPT_ROOT_SCRIPTS))
    ref = ref_core.run_project(pkg_root=str(tmp_path / "kungfu_tpu"),
                               repo_root=str(tmp_path), use_cache=False)
    port = port_core.run_project()
    assert mapped(ref) == plain(port) == []
    n = sum(1 for _ in (tmp_path / "kungfu_tpu").rglob("*.py"))
    assert n == sum(1 for p in PORT_PKG.rglob("*.py") if "__pycache__" not in p.parts) > 100


def test_the_port_over_the_renamed_reference_finds_what_the_reference_finds(
        tmp_path, monkeypatch):
    pkg = tmp_path / "kungfu_tpu_torch"
    _copy_tree(REF_PKG, pkg, REPO / "docs", pkg / "docs")
    monkeypatch.setattr(kungfu_tpu_torch, "knobs", ref_knobs)
    port = port_core.run_project(pkg_root=str(pkg), repo_root=str(tmp_path), use_cache=False)
    ref = ref_core.run_project()
    assert plain(port) == mapped(ref) == []


def _file_rules(core, R, relpath, source):
    ctx = core.FileContext("/tmp/x.py", relpath, source)
    return [f for r in core.RULES.values() if r.scope == "file" for f in r.fn(ctx)]


PORT_FILES = sorted(str(p.relative_to(REPO)) for p in PORT_PKG.rglob("*.py")
                    if "__pycache__" not in p.parts)


@pytest.mark.parametrize("rel", PORT_FILES)
def test_a_port_file_gives_the_same_raw_findings_under_both(rel):
    """Before suppressions: each file rule of both analyzers over the
    port's file (the reference's at its renamed path) finds the same,
    but for the declared KF500 departure."""
    src = (REPO / rel).read_text()
    ref = _file_rules(ref_core, ref_R, to_ref(rel), src)
    port = _file_rules(port_core, port_R, rel, src)
    if rel.startswith(port_R._PRINT_EXEMPT_ROOT_SCRIPTS):
        ref = [f for f in ref if f.rule != "KF500"]
    assert sorted(mapped(ref)) == sorted(plain(port))


# ---------------------------------------------------------------------------
# (d) one planted violation per rule
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("kfport")
    _copy_tree(PORT_PKG, root / "kungfu_tpu_torch", PORT_PKG / "docs",
               root / "kungfu_tpu_torch" / "docs")
    return root


def run_copy(root: Path, use_cache=True):
    return port_core.run_project(pkg_root=str(root / "kungfu_tpu_torch"),
                                 repo_root=str(root), use_cache=use_cache)


def test_the_copy_of_the_port_is_clean_and_cached(port_copy):
    assert run_copy(port_copy) == []
    data = json.loads((port_copy / ".kfcheck-torch-cache.json").read_text())
    assert data["version"] == port_core.ruleset_version()
    assert len(data["files"]) == len(PORT_FILES)
    assert run_copy(port_copy) == []  # served from the cache


def _append(code):
    code = textwrap.dedent(code)

    def plant(text):
        return text.rstrip("\n") + "\n\n\n" + code
    return plant


def _replace(old, new):
    def plant(text):
        assert text.count(old) == 1, old
        return text.replace(old, new)
    return plant


def _line_of(needle):
    """The expected line: the first line of the planted text holding it."""
    def find(text):
        for i, line in enumerate(text.splitlines(), start=1):
            if needle in line:
                return i
        raise AssertionError(f"{needle!r} not in the planted file")
    return find


def _first_row(text):
    return next(i for i, line in enumerate(text.splitlines(), start=1)
                if line.startswith("| `KF_"))


def _row_of(needle):
    return _line_of(f"| `{needle}`")


def _one(_text):
    return 1


def _last_except(text):
    return max(i for i, line in enumerate(text.splitlines(), start=1)
               if line.strip() == "except Exception:")


def _knob_decl_line(name):
    tree = ast.parse((PORT_PKG / "knobs.py").read_text())
    return next(n.lineno for n in ast.walk(tree)
                if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "_knob"
                and n.args and getattr(n.args[0], "value", None) == name)


def _doc_row(name):
    return _row_of(name)((PORT_PKG / "docs" / "telemetry.md").read_text())


DOC = "kungfu_tpu_torch/docs/telemetry.md"
KNOBS_DOC = "kungfu_tpu_torch/docs/knobs.md"

# rule -> (file planted, plant, file of the finding when another, its
# line as a function of the planted text, words of its message)
PLANTS = {
    "KF000": ("kungfu_tpu_torch/planted.py", lambda t: "def (:\n", None, _one, "invalid syntax"),
    "KF001": ("kungfu_tpu_torch/peer.py", _append("x = 1  # kfcheck: disable=KF400\n"),
              None, _line_of("disable=KF400"), "written justification"),
    "KF003": ("kungfu_tpu_torch/peer.py", _append("""\
        def _planted(ev):
            ev.wait(1.0)  # kfcheck: disable=KF301 — nothing to suppress here
        """), None, _line_of("nothing to suppress"), "matches no finding"),
    "KF100": ("kungfu_tpu_torch/peer.py", _append('_PLANTED = "KF_PLANTED_UNDECLARED"\n'),
              None, _line_of("KF_PLANTED_UNDECLARED"), "KF_PLANTED_UNDECLARED"),
    "KF101": ("kungfu_tpu_torch/telemetry/flight.py",
              _append('_PLANTED = os.environ.get("KF_CONFIG_ALGO")\n'),
              None, _line_of("_PLANTED"), "direct environment read of 'KF_CONFIG_ALGO'"),
    "KF102": (KNOBS_DOC, lambda t: t.replace("| `KF_", "| `KF_PLANTED", 1), None, _first_row,
              "stale vs the registry"),
    "KF200": ("kungfu_tpu_torch/utils/pool.py", _append("""\
        def _planted(self):
            with self._lock:
                time.sleep(1)
        """), None, _line_of("time.sleep(1)"), "time.sleep"),
    "KF201": ("kungfu_tpu_torch/utils/pool.py", _replace('_KF_LOCK_ORDER = ("_lock", "cond")\n', ""),
              None, _line_of("with w.cond:"), "declares no lock hierarchy"),
    "KF300": ("kungfu_tpu_torch/utils/pool.py", _append("threading.Thread(target=len).start()\n"),
              None, _line_of("target=len"), "daemon=True"),
    "KF301": ("kungfu_tpu_torch/runner/watch.py", _append("""\
        def _planted(ev):
            ev.wait()
        """), None, _line_of("ev.wait()"), "unbounded .wait()"),
    "KF302": ("kungfu_tpu_torch/runner/watch.py", _append("""\
        def _planted(t):
            t.join()
        """), None, _line_of("t.join()"), "unbounded .join()"),
    "KF303": ("kungfu_tpu_torch/collective/scheduler.py", _append("""\
        def _planted():
            threading.Thread(target=len, daemon=True).start()
        """), None, _line_of("target=len"), "outside _spawn_registered"),
    "KF400": ("kungfu_tpu_torch/telemetry/memory.py", _append("""\
        def _planted():
            try:
                len([])
            except Exception:
                pass
        """), None, _last_except, "swallows"),
    "KF500": ("kungfu_tpu_torch/api.py", _append('print("planted")\n'),
              None, _line_of('print("planted")'), "bare print()"),
    "KF600": ("kungfu_tpu_torch/telemetry/metrics.py",
              _append('_PLANTED = "kungfu_planted_family_total"\n'), DOC, _one,
              "'kungfu_planted_family_total' is registered"),
    "KF601": (DOC, lambda t: re.sub(r"(\n\| `kungfu_)", "\n| `kungfu_planted_ghost` | counter | "
                                    r"— | planted |\1", t, count=1),
              None, _row_of("kungfu_planted_ghost"), "'kungfu_planted_ghost' but no code"),
    "KF602": ("kungfu_tpu_torch/peer.py",
              _replace('with trace.span("resize.drain_scheduler"):', "if True:"),
              DOC, lambda t: _doc_row("resize.drain_scheduler"),
              "documents 'resize.drain_scheduler' but no code emits it"),
    "KF604": ("kungfu_tpu_torch/peer.py", _append('audit.record_event("planted_kind")\n'),
              DOC, _one, "'planted_kind' is recorded"),
    "KF605": (DOC, lambda t: re.sub(r"\n\| `monitor/noise_scale` \|[^\n]*", "", t), None, _one,
              "'monitor/noise_scale' is written"),
    "KF606": (DOC, lambda t: re.sub(r"\n\| `/memory` \|[^\n]*", "", t), None, _one,
              "endpoint '/memory' is served"),
    "KF700": ("kungfu_tpu_torch/api.py", _append("""\
        def _planted(sess):
            sess.barrier(tag=":planted")
        """), None, _line_of('tag=":planted"'), "constant wire name ':planted'"),
    "KF701": ("kungfu_tpu_torch/collective/host_session.py",
              _replace('            ("KF_CONFIG_ZERO", self.zero_mode),\n', ""),
              "kungfu_tpu_torch/knobs.py", lambda t: _knob_decl_line("KF_CONFIG_ZERO"),
              "KF_CONFIG_ZERO is declared consensus=True"),
    "KF702": ("kungfu_tpu_torch/collective/walks.py", _append("""\
        def _planted(self, w):
            if self.rank == 0:
                self.sess.all_reduce(w)
        """), None, _line_of("self.sess.all_reduce(w)"), ".all_reduce() runs under a rank"),
    "KF703": ("kungfu_tpu_torch/collective/walks.py", _append("""\
        def _planted(self, w):
            np.copyto(w.recv, w.send)
        """), None, _line_of("np.copyto(w.recv, w.send)"), "no abort/cancel in scope"),
}


def test_every_registered_rule_has_a_plant():
    assert set(port_core.RULES) <= set(PLANTS)
    assert set(PLANTS) - set(port_core.RULES) == {"KF000", "KF001", "KF003"}


@pytest.mark.parametrize("rid", sorted(PLANTS))
def test_a_planted_violation_gives_exactly_its_finding(rid, port_copy):
    rel, plant, at, line_of, words = PLANTS[rid]
    path = port_copy / rel
    before = path.read_text() if path.exists() else None
    planted = plant(before or "")
    try:
        path.write_text(planted)
        got = run_copy(port_copy)
    finally:
        if before is None:
            path.unlink()
        else:
            path.write_text(before)
    line = line_of(planted)
    assert [(f.rule, f.path, f.line) for f in got] == [(rid, at or rel, line)], \
        [f.render() for f in got]
    assert words in got[0].message


def test_an_unknown_rule_in_a_suppression_is_a_finding_and_stale(port_copy):
    path = port_copy / "kungfu_tpu_torch" / "peer.py"
    before = path.read_text()
    planted = _append("x = 1  # kfcheck: disable=KF999 — no such rule\n")(before)
    try:
        path.write_text(planted)
        got = run_copy(port_copy)
    finally:
        path.write_text(before)
    line = _line_of("KF999")(planted)
    assert [(f.rule, f.path, f.line) for f in got] == [
        ("KF002", "kungfu_tpu_torch/peer.py", line), ("KF003", "kungfu_tpu_torch/peer.py", line)]


# ---------------------------------------------------------------------------
# (e) suppressions and the cache, against the port's cache file
# ---------------------------------------------------------------------------

def write_pkg(tmp_path, files):
    pkg = tmp_path / "kungfu_tpu_torch"
    pkg.mkdir(exist_ok=True)
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return pkg


def run_tmp(tmp_path, use_cache=True, select=None):
    return port_core.run_project(pkg_root=str(tmp_path / "kungfu_tpu_torch"),
                                 repo_root=str(tmp_path), select=select, use_cache=use_cache)


def rule_ids(findings):
    return [f.rule for f in findings]


SUPPRESSIONS = {
    "no-reason": ("ev.wait()  # kfcheck: disable=KF301", ["KF001", "KF301"]),
    "em-dash": ("ev.wait()  # kfcheck: disable=KF301 — waits ON the abort signal", []),
    "en-dash": ("ev.wait()  # kfcheck: disable=KF301 – waits ON the abort signal", []),
    "double-hyphen": ("ev.wait()  # kfcheck: disable=KF301 -- waits ON the abort signal", []),
    "hyphen": ("ev.wait()  # kfcheck: disable=KF301 - waits ON the abort signal", []),
    "two-rules": ("ev.wait()  # kfcheck: disable=KF301,KF200 — waits ON the abort signal", []),
    "lower-case": ("ev.wait()  # kfcheck: disable=kf301 — waits ON the abort signal", []),
    "other-rule": ("ev.wait()  # kfcheck: disable=KF302 — the wrong rule", ["KF301"]),
    "unparseable": ("ev.wait()  # kfcheck: enable=KF301", ["KF001", "KF301"]),
    "block-above": ("# kfcheck: disable=KF301 — the justification for this wait\n"
                    "    # spans several comment lines before the code it covers\n"
                    "    ev.wait()", []),
}


@pytest.mark.parametrize("case", sorted(SUPPRESSIONS))
def test_the_suppression_contract(case, tmp_path):
    line, want = SUPPRESSIONS[case]
    write_pkg(tmp_path, {"x.py": f"def f(ev):\n    {line}\n"})
    assert sorted(rule_ids(run_tmp(tmp_path, select=["KF301"]))) == want


def test_disable_file_scopes_the_whole_file(tmp_path):
    write_pkg(tmp_path, {"x.py": '''
        # kfcheck: disable-file=KF301 — fixture: every wait here is abort-aware
        def f(ev, other):
            ev.wait()
            other.wait()
    '''})
    assert run_tmp(tmp_path, select=["KF301"]) == []


def test_cache_round_trip_preserves_findings(tmp_path):
    write_pkg(tmp_path, {"x.py": "def f(ev):\n    ev.wait()\n"})
    first = run_tmp(tmp_path)
    assert (tmp_path / ".kfcheck-torch-cache.json").exists()
    assert not (tmp_path / ".kfcheck-cache.json").exists()
    assert run_tmp(tmp_path) == first
    assert "KF301" in rule_ids(first)
    files = port_core.load_files(str(tmp_path / "kungfu_tpu_torch"), str(tmp_path),
                                 port_core.ResultCache(str(tmp_path)))
    assert files[0].from_cache and files[0]._tree is port_core._UNPARSED


def test_cache_invalidated_by_content_change(tmp_path):
    write_pkg(tmp_path, {"x.py": "def f(ev):\n    ev.wait()\n"})
    assert "KF301" in rule_ids(run_tmp(tmp_path))
    write_pkg(tmp_path, {"x.py": "def f(ev):\n    ev.wait(1.0)\n"})
    assert "KF301" not in rule_ids(run_tmp(tmp_path))


def test_cache_invalidated_by_ruleset_version(tmp_path, monkeypatch):
    write_pkg(tmp_path, {"x.py": "def f(ev):\n    ev.wait()\n"})
    run_tmp(tmp_path)
    data = json.loads((tmp_path / ".kfcheck-torch-cache.json").read_text())
    assert data["version"] == port_core.ruleset_version()
    monkeypatch.setattr(port_core, "_ruleset_version_memo", "different-rules")
    assert port_core.ResultCache(str(tmp_path)).files == {}


def test_cache_not_written_by_select_or_uncached_runs(tmp_path):
    write_pkg(tmp_path, {"x.py": "def f(ev):\n    ev.wait()\n"})
    run_tmp(tmp_path, select=["KF301"])
    run_tmp(tmp_path, use_cache=False)
    assert not (tmp_path / ".kfcheck-torch-cache.json").exists()


def test_cache_prunes_deleted_files(tmp_path):
    write_pkg(tmp_path, {"x.py": "A = 1\n", "y.py": "B = 2\n"})
    run_tmp(tmp_path)
    (tmp_path / "kungfu_tpu_torch" / "y.py").unlink()
    run_tmp(tmp_path)
    data = json.loads((tmp_path / ".kfcheck-torch-cache.json").read_text())
    assert set(data["files"]) == {"kungfu_tpu_torch/x.py"}


def test_cached_suppressions_still_apply_and_rot(tmp_path):
    def mine(findings):
        return [f.rule for f in findings if f.rule in ("KF001", "KF003", "KF301")]

    write_pkg(tmp_path, {"x.py": "def f(ev):\n"
                         "    ev.wait()  # kfcheck: disable=KF301 — abort-aware by contract\n"})
    assert mine(run_tmp(tmp_path)) == []
    assert mine(run_tmp(tmp_path)) == []
    write_pkg(tmp_path, {"x.py": "def f(ev):\n"
                         "    ev.wait(1.0)  # kfcheck: disable=KF301 — nothing to suppress\n"})
    run_tmp(tmp_path)
    assert mine(run_tmp(tmp_path)) == ["KF003"]


def test_the_two_analyzers_keep_their_caches_apart(tmp_path):
    """One repo root, both packages: each analyzer's prune() keeps to its
    own cache file, so neither drops the other's entries."""
    write_pkg(tmp_path, {"x.py": "A = 1\n"})
    (tmp_path / "kungfu_tpu").mkdir()
    (tmp_path / "kungfu_tpu" / "y.py").write_text("B = 2\n")
    for _ in range(2):
        run_tmp(tmp_path)
        ref_core.run_project(pkg_root=str(tmp_path / "kungfu_tpu"), repo_root=str(tmp_path))
    port = json.loads((tmp_path / ".kfcheck-torch-cache.json").read_text())
    ref = json.loads((tmp_path / ".kfcheck-cache.json").read_text())
    assert set(port["files"]) == {"kungfu_tpu_torch/x.py"}
    assert set(ref["files"]) == {"kungfu_tpu/y.py"}


def test_every_suppression_in_the_port_has_a_reason():
    files = port_core.load_files(str(PORT_PKG), str(REPO))
    n = 0
    for ctx in files:
        assert not ctx.malformed, [f.render() for f in ctx.malformed]
        for s in ctx.suppressions:
            n += 1
            assert len(s.reason) >= 10, (ctx.relpath, s.line, s.reason)
    assert n >= 20


# ---------------------------------------------------------------------------
# (f) the gate
# ---------------------------------------------------------------------------

SECTIONS = ("kfcheck", "knobs-doc", "metric-docs", "span-docs", "audit-docs",
            "signal-docs", "endpoint-docs")


def test_the_gate_exits_0_with_every_section_clean():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-m", "kungfu_tpu_torch.devtools.check"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.splitlines() == [f"[{s}] clean" for s in SECTIONS] + ["check: clean"]
    assert "jax" not in r.stderr


def test_the_gate_sections_a_finding_and_exits_1(monkeypatch, capsys):
    from kungfu_tpu_torch.devtools import check

    finding = port_core.Finding("KF602", DOC, 3, "planted")
    monkeypatch.setattr(port_core, "run_project", lambda **kw: [finding])
    assert check.main(["--no-cache"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[kfcheck] clean" and out[3] == "[span-docs] 1 finding(s)"
    assert out[4] == "  " + finding.render() and out[-1] == "check: 1 finding"


# ---------------------------------------------------------------------------
# the port's docs against the reference's
# ---------------------------------------------------------------------------

def _metric_rows(project, R):
    got = R._telemetry_doc(project)
    return {name for line in got[1] if line.startswith("| `kungfu_")
            for name in re.findall(r"`(kungfu_[a-z0-9_]+)`", line.split("|")[1])}


TABLES = {
    "metrics": lambda p, R: _metric_rows(p, R),
    "spans": lambda p, R: {n for _, n in R._span_table_rows(p)},
    "audit": lambda p, R: {n for _, n in R._audit_table_rows(p)},
    "signals": lambda p, R: {n for _, n in R._signal_table_rows(p)},
    "endpoints": lambda p, R: {n for _, n in R._endpoint_table_rows(p)},
}

# the port's rows that the reference's doc lacks, each with its reason
DEPARTURES = {
    "signals": {"monitor/noise_scale"},  # written by the port's bench_wire_q.py,
    # which the port's analyzer scans; the reference's is a root script
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_a_table_of_the_ports_doc_names_what_the_references_names(table):
    ref = TABLES[table](ref_core.Project(str(REF_PKG), str(REPO), []), ref_R)
    port = TABLES[table](port_core.Project(str(PORT_PKG), str(REPO), []), port_R)
    assert len(ref) >= 5
    assert port == ref | DEPARTURES.get(table, set())


def test_the_ports_knobs_doc_is_its_registrys_render():
    assert (PORT_PKG / "docs" / "knobs.md").read_text() == port_knobs.render_doc()


@pytest.fixture(scope="module")
def project():
    return port_core.Project(str(PORT_PKG), str(REPO), port_core.load_files(
        str(PORT_PKG), str(REPO)))


@pytest.mark.parametrize("rid", ["KF600", "KF601", "KF602", "KF604", "KF605", "KF606",
                                 "KF102", "KF701", "KF100", "KF101"])
def test_a_project_rule_is_clean_on_the_port_and_sees_enough(rid, project):
    """Each doc and registry rule over the real port: no raw finding at
    all (none of them is suppressed anywhere), and its scan finds more
    than the floor under which it reports itself broken."""
    assert port_core.RULES[rid].fn(project) == []
    sizes = {
        "KF600": (len(port_R._source_metric_names(project)), 30),
        "KF601": (len(_metric_rows(project, port_R)), 20),
        "KF602": (len(port_R._source_span_names(project)), 15),
        "KF604": (len(port_R._source_audit_kinds(project)), 8),
        "KF605": (len(port_R._source_signal_keys(project)), 10),
        "KF606": (len(port_R._source_endpoints(project)), 12),
        "KF102": (len(port_knobs.names()), 60),
        "KF701": (sum(1 for _, flag in port_R._knob_registry_decls(next(
            c for c in project.files if c.relpath == port_R._REGISTRY_FILE)).values() if flag),
            5),
        "KF100": (sum(len(c.knob_literals) for c in project.files), 50),
        "KF101": (len(port_R._cross_constants(project)), 50),
    }
    got, floor = sizes[rid]
    assert got > floor, (rid, got)
