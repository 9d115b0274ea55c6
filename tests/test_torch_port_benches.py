"""The port's benchmarks on the CPU against the JAX package's:
`kungfu_tpu_torch/benchmarks/__main__.py`, `bench_hier.py` and
`bench_wire_q.py`; mirrors tests/test_bench_host_smoke.py.

- `bench_xla` on a spawned gloo world of 2 (exact sums, the reference's
  RESULT line) and `bench_gns` on the CPU.
- The host benches in process, at the `tiny` model on worlds of 2 peers
  of each package: `bench_host`, `bench_p2p`, the wire, async, ZeRO and
  re-plan A/Bs and the steps, resources and memory reports print the
  reference's lines (numbers aside), and ZeRO's state bytes are the
  reference's exactly.
- `bench_scrape` at one small fleet into a temporary path: the schema of
  `BENCH_AGG_r15.json`.
- `main`'s flag errors are the reference's.
- One kfrun world of 2 running `--method HOST` (ports in 12000-19999).

`bench_hier` and `bench_wire_q` are held in `test_torch_port_bench_legs.py`.

In-process worlds bind port 0 outside 38000-38999."""

import contextlib
import io
import json
import re
import sys
import threading
from pathlib import Path

import pytest
import torch

from kungfu_tpu import api as rapi
from kungfu_tpu import peer as rpeer
from kungfu_tpu.benchmarks import __main__ as rbench
from kungfu_tpu.telemetry import config as rconfig
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu.telemetry import steptrace as rsteptrace
from kungfu_tpu_torch import api
from kungfu_tpu_torch import peer as tpeer
from kungfu_tpu_torch.benchmarks import __main__ as bench
from kungfu_tpu_torch.parallel.distributed import spawn_world
from kungfu_tpu_torch.telemetry import config, decisions, steptrace
from test_torch_port_runner import free_range, port_env
from test_torch_port_worlds import (  # noqa: F401 - fixtures used by name
    PerThreadCounter, free_ports, make_world, new_epoch, ref_native, run_all, small_arenas)

REPO = Path(__file__).resolve().parent.parent
NUM = re.compile(r"\d+(\.\d+)?(e[-+]?\d+)?%?")


def template(line):
    """A printed line with its numbers taken out."""
    return NUM.sub("#", line)


# ---------------------------------------------------------------------------
# the device paths
# ---------------------------------------------------------------------------

RESULT_XLA = re.compile(r"^RESULT: \d+\.\d{3} \+-\d+\.\d{3} \(GiB/s\) \[XLA x(\d+) devices, "
                        r"([\w-]+)\]$")


def _xla_worker(rank, peers, model, out_dir):
    import os

    os.environ["KF_SELF_SPEC"] = peers[rank]
    os.environ["KF_INIT_PEERS"] = ",".join(peers)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = bench.bench_xla(model, 3, device="cpu")
    exact = all(torch.equal(o, x * res["devices"]) for o, x in zip(res["outs"], res["inputs"]))
    (Path(out_dir) / f"xla{rank}.json").write_text(json.dumps(
        {"out": buf.getvalue(), "exact": exact, "devices": res["devices"],
         "sizes": [o.numel() for o in res["outs"]]}))
    from kungfu_tpu_torch.parallel import shutdown_device_plane

    shutdown_device_plane()


@pytest.mark.parametrize("model", ["tiny", "slp-mnist"])
def test_bench_xla_sums_a_gloo_world_of_two_exactly(model, tmp_path):
    spawn_world(_xla_worker, 2, 120, args=(model, str(tmp_path)))
    for rank in range(2):
        rec = json.loads((tmp_path / f"xla{rank}.json").read_text())
        assert rec["exact"] and rec["devices"] == 2
        assert rec["sizes"] == bench_hier_sizes(model)
        m = RESULT_XLA.match(rec["out"].strip())
        assert m and m.groups() == ("2", model), rec["out"]


def bench_hier_sizes(model):
    from kungfu_tpu_torch.models.fake import FAKE_MODELS

    return FAKE_MODELS[model]


def test_bench_xla_on_the_cpu_alone_is_a_world_of_one(capsys):
    res = bench.bench_xla("tiny", 2, device="cpu")
    assert res["devices"] == 1
    assert all(torch.equal(o, x) for o, x in zip(res["outs"], res["inputs"]))
    assert RESULT_XLA.match(capsys.readouterr().out.strip()).groups() == ("1", "tiny")


def test_bench_gns_times_both_steps_on_the_cpu(capsys):
    res = bench.bench_gns(3, device="cpu")
    out = capsys.readouterr().out.strip()
    assert re.fullmatch(r"RESULT: plain \d+\.\d{3} ms/step, \+GNS \d+\.\d{3} ms/step, "
                        r"overhead [-+]\d+\.\d% \[GNS x1 devices\]", out), out
    assert res["plain_ms"] > 0 and res["gns_ms"] > 0 and res["devices"] == 1


@pytest.mark.parametrize("method", ["XLA", "GNS"])
def test_the_device_paths_default_to_the_card(method):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--method", method, "--model", "tiny", "--iters", "1"])


# ---------------------------------------------------------------------------
# the host benches in process, both packages
# ---------------------------------------------------------------------------

@pytest.fixture
def host_world(ref_native, monkeypatch):
    """run(pkg, fn, env): a world of 2 peers of `pkg` whose sessions start
    under `env`, `fn()` run on each peer's thread with the package's
    default peer that thread's own; returns what was printed."""
    from kungfu_tpu.collective.host_session import HostSession as RHostSession
    from kungfu_tpu_torch.collective.host_session import HostSession

    monkeypatch.setattr(api, "_async_seq", PerThreadCounter())
    # read from the environment when the engine is imported: tiny payloads
    # segment and encode only with both floors at 0
    for cls in (HostSession, RHostSession):
        monkeypatch.setattr(cls, "SEGMENT_MIN_BYTES", 0)
        monkeypatch.setattr(cls, "WIRE_MIN_BYTES", 0)
    started = []

    def run(pkg, fn, env=None, k=2):
        for key, value in (env or {}).items():
            monkeypatch.setenv(key, value)
        for cfg in (config, rconfig):
            cfg.refresh(None)
        for dec, st in ((decisions, steptrace), (rdecisions, rsteptrace)):
            dec.reset_ledger()
            st.reset_store()
        world = make_world([pkg] * k, strategy="STAR")
        started.append(world)
        new_epoch(world)
        tls = threading.local()
        for mod in ((api, tpeer) if pkg == "port" else (rapi, rpeer)):
            monkeypatch.setattr(mod, "get_default_peer", lambda: tls.peer)

        def rank(r):
            tls.peer = world[r]
            fn()

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_all([lambda r=r: rank(r) for r in range(k)], join=300)
        for key in env or {}:
            monkeypatch.delenv(key)
        return buf.getvalue().splitlines()

    yield run
    for world in started:
        for p in world:
            p.stop()
    for cfg in (config, rconfig):
        cfg.refresh(None)


def _both(host_world, name, env=None, args=()):
    """The lines each package's `name(*args)` prints on a world of 2."""
    mod = {"port": bench, "ref": rbench}
    out = {}
    for pkg in ("port", "ref"):
        out[pkg] = host_world(pkg, lambda: getattr(mod[pkg], name)(*args), env)
    return out["port"], out["ref"]


def _comparable(lines, drop=("TRACE ", "WIRE ")):
    """The lines' templates, without the ones that name spans by their
    package's own profile (the trace's top ten by time) and the WIRE
    lines: the peers of an in-process world share one registry, so which
    labels moved while rank 0 timed its iterations depends on where the
    other peer was."""
    return sorted(template(x) for x in lines if not x.startswith(drop))


SEGMENTED = {"KF_CONFIG_ALGO": "segmented", "KF_CONFIG_SEGMENT_MIN_BYTES": "0",
             "KF_CONFIG_WIRE_MIN_BYTES": "0", "KF_TELEMETRY": "metrics"}


@pytest.mark.parametrize("algo,wire", [("tree", ""), ("segmented", ""), ("segmented", "bf16"),
                                       ("segmented", "int8")])
def test_bench_host_prints_the_references_lines_and_bytes(algo, wire, host_world):
    env = dict(SEGMENTED, KF_CONFIG_ALGO=algo)
    if wire:
        env["KF_CONFIG_WIRE"] = wire
    mine, theirs = _both(host_world, "bench_host", env, ("tiny", 2))
    assert _comparable(mine) == _comparable(theirs)
    wire_lines = [x for x in mine if x.startswith("WIRE ")]
    label = "RING_SEGMENTED" if algo == "segmented" else "BINARY_TREE"
    assert any(label in x and f'codec="{wire or "off"}"' in x for x in wire_lines), wire_lines
    assert any(x.startswith("EFF ") and label in x for x in mine)
    assert any(x.startswith("TRACE ") for x in mine)


def test_bench_p2p_prints_the_references_line(host_world):
    mine, theirs = _both(host_world, "bench_p2p", None, ("slp-mnist", 3))
    assert [template(x) for x in mine] == [template(x) for x in theirs]
    assert mine[0].endswith("[P2P x2 workers, slp-mnist]")


def test_the_wire_ab_prints_the_references_lines(host_world):
    env = dict(SEGMENTED, KF_CONFIG_WIRE="bf16")
    mine, theirs = _both(host_world, "bench_host_wire_ab", env, ("tiny", 2))
    assert _comparable(mine) == _comparable(theirs)
    assert any("median speedup" in x for x in mine)


def test_the_async_ab_prints_the_references_lines(host_world):
    env = dict(SEGMENTED, KF_CONFIG_ASYNC="on")
    mine, theirs = _both(host_world, "bench_host_async_ab", env, ("tiny", 2, 2, 2))
    assert _comparable(mine) == _comparable(theirs)
    assert any(x.startswith("OVERLAP tiny: flush-wait") for x in mine)


def test_the_zero_ab_prints_the_references_lines_and_state(host_world):
    env = dict(SEGMENTED, KF_CONFIG_ASYNC="on", KF_CONFIG_ZERO="on")
    mine, theirs = _both(host_world, "bench_host_zero_ab", env, ("tiny", 2))
    assert _comparable(mine) == _comparable(theirs)
    # the optimizer state's bytes are the reference's exactly
    assert [x for x in mine if x.startswith("STATE ")] == \
        [x for x in theirs if x.startswith("STATE ")]
    assert any(x.startswith("WIRE zero=sharded ") and 'collective="reduce_scatter"' in x
               for x in mine)


def test_the_async_and_zero_abs_need_the_scheduler(host_world):
    for name in ("bench_host_async_ab", "bench_host_zero_ab"):
        with pytest.raises(SystemExit, match="needs the scheduler"):
            host_world("port", lambda: getattr(bench, name)("tiny", 1), {})


REPLAN_LINES = [
    "REPLAN tiny: adopted # (predicted gain #x)",
    "RESULT: # +-# (GiB/s) median # [HOST-AB ring=naive, x# workers, tiny, # interleaved samples]",
    "RESULT: # +-# (GiB/s) median # [HOST-AB ring=measured, x# workers, tiny, # interleaved "
    "samples]",
    "RESULT: measured-order / naive-order median speedup: #x [interleaved paired, tiny, shaped]",
    "RESULT: # +-# ms/step median # [HOST-AB segments=equal, x# workers, rs+update+ag #MiB, "
    "slow-rank x# compute, # interleaved samples]",
    "RESULT: # +-# ms/step median # [HOST-AB segments=weighted, x# workers, rs+update+ag #MiB, "
    "slow-rank x# compute, # interleaved samples]",
    "RESULT: equal / weighted median step-time ratio: #x [interleaved paired, compute-shaped "
    "peer]",
]


def test_the_replan_ab_prints_the_references_lines(host_world, monkeypatch):
    """The re-plan A/B under a shaped edge (the segments leg cut to 64 Ki
    elements): the lines of the reference's format strings; with
    `decisions` the ledger's DECISIONS lines too."""
    monkeypatch.setattr(bench, "SEG_ELEMS", 64 << 10)
    ports = free_ports(2)
    monkeypatch.setattr("test_torch_port_worlds.free_ports", lambda n: ports)
    env = dict(SEGMENTED, KF_CONFIG_REPLAN="auto", KF_CONFIG_SHM="0",
               KF_SHAPE_LINKS=f"127.0.0.1:{ports[0]}>127.0.0.1:{ports[1]}=lat:10",
               KF_DECISION_WINDOW="6", KF_DECISION_SETTLE="1")
    lines = host_world("port", lambda: bench.bench_host_replan_ab("tiny", 4, 2, True), env)
    head = [x for x in lines if not x.startswith("DECISIONS")]
    body = [template(x).replace("adopted RingPlan", "adopted") for x in head]
    assert [re.sub(r"adopted .* \(predicted", "adopted # (predicted", x) for x in body] == \
        REPLAN_LINES or body[0].startswith("REPLAN tiny: no plan adopted"), lines
    dec = [x for x in lines if x.startswith("DECISIONS")]
    assert dec and all(template(x).startswith("DECISIONS tiny: ") for x in dec)


def _planes():
    from kungfu_tpu.telemetry import memory as rmemory
    from kungfu_tpu.telemetry import resource as rresource
    from kungfu_tpu_torch.telemetry import memory, resource

    return {"port": (resource, memory), "ref": (rresource, rmemory)}


PLANES = _planes()


@pytest.mark.parametrize("report", ["report_steps", "report_resources", "report_memory"])
def test_each_report_prints_the_references_lines(report, host_world, monkeypatch):
    env = dict(SEGMENTED, KF_CONFIG_ASYNC="on", KF_TELEMETRY_SPAN_SAMPLE="1")
    mods = {"port": bench, "ref": rbench}
    out = {}
    for pkg in ("port", "ref"):
        mod = mods[pkg]
        # one plane a process and one accountant registry a package: fresh
        # ones, or what earlier cases of this process left (a ZeRO
        # session's accountant, a long-lived plane's leak verdict) shows
        resource_mod, memory_mod = PLANES[pkg]
        resource_mod.reset_plane()
        memory_mod.reset_plane()
        monkeypatch.setattr(memory_mod, "_accountants", {})

        def fn(mod=mod, planes=PLANES[pkg]):
            for plane in planes:  # main's anchor: the window spans the bench
                plane.get_plane().maybe_sweep(force=True)
            mod.bench_host_async_ab("tiny", 1, 1, 1)
            getattr(mod, report)("tiny")

        lines = host_world(pkg, fn, env)
        out[pkg] = [x for x in lines if x.split(" ")[0] in ("STEPS", "RESOURCES", "MEMORY")]
    word = {"report_steps": "STEPS", "report_resources": "RESOURCES",
            "report_memory": "MEMORY"}[report]
    assert out["port"] and all(x.startswith(word) for x in out["port"])

    def shape(lines):  # the bucket lists and the saturation flag: what each plane saw
        return sorted(re.sub(r" \[.*\]", " [...]", template(x)).replace(" SATURATED", "")
                      for x in lines if not x.startswith("STEPS critical"))

    assert shape(out["port"]) == shape(out["ref"])


# ---------------------------------------------------------------------------
# bench_scrape, main's flags, one kfrun world
# ---------------------------------------------------------------------------

def _keys(d, prefix=""):
    out = set()
    if isinstance(d, dict):
        for k, v in d.items():
            out.add(f"{prefix}/{k}")
            out |= _keys(v, f"{prefix}/{k}")
    return out


def test_bench_scrape_writes_the_references_schema(tmp_path, monkeypatch):
    monkeypatch.delenv("KF_AGG_HIER_MIN_PEERS", raising=False)
    path = tmp_path / "agg.json"
    bench.bench_scrape(str(path), sweeps=1, host_counts=(4,))
    doc = json.loads(path.read_text())
    schema = json.loads((REPO / "BENCH_AGG_r15.json").read_text())
    schema["results"] = {"k64": schema["results"]["k64"]}
    assert _keys(doc) == _keys(schema)
    k64 = doc["results"]["k64"]
    assert (k64["flat"]["mode"], k64["scale"]["mode"]) == ("flat", "hier")
    assert k64["hosts"] == 4 and k64["workers_per_host"] == 16
    assert k64["links_payload_ratio"] > 1 and "KF_AGG_HIER_MIN_PEERS" not in __import__(
        "os").environ


def test_bench_scrapes_default_path_is_the_references():
    import inspect

    assert inspect.signature(bench.bench_scrape).parameters["out_path"].default == \
        inspect.signature(rbench.bench_scrape).parameters["out_path"].default


FLAG_ERRORS = [
    ["--algo", "tree"],
    ["--method", "XLA", "--wire", "bf16"],
    ["--method", "P2P", "--wire-ab"],
    ["--method", "GNS", "--async"],
    ["--zero"],
    ["--steps"],
    ["--resources"],
    ["--memory"],
    ["--replan"],
    ["--method", "HOST", "--wire-ab", "--async"],
    ["--method", "HOST", "--zero", "--replan"],
    ["--method", "HOST", "--decisions"],
    ["--method", "TPU"],
    ["--algo", "ring"],
    ["--wire", "int2"],
    ["--iters", "ten"],
]


def _parse_error(main, argv, monkeypatch):
    err = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["bench"] + argv)
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        main(argv) if main is bench.main else main()
    return e.value.code, err.getvalue().splitlines()[-1].split(": error: ", 1)[1]


@pytest.mark.parametrize("argv", FLAG_ERRORS, ids=[" ".join(a) for a in FLAG_ERRORS])
def test_mains_flag_errors_are_the_references(argv, monkeypatch):
    assert _parse_error(bench.main, argv, monkeypatch) == \
        _parse_error(rbench.main, argv, monkeypatch)


def test_device_applies_to_the_device_paths_only(monkeypatch):
    code, msg = _parse_error(bench.main, ["--method", "HOST", "--device", "cpu"], monkeypatch)
    assert code == 2 and "--device applies to the device paths" in msg


AGENT = """
import sys
from kungfu_tpu_torch.benchmarks.__main__ import main

main(["--method", "HOST", "--model", "tiny", "--iters", "2", "--algo", "segmented",
      "--wire", "bf16", "--resources", "--memory"])
"""


def test_a_kfrun_world_runs_the_host_bench(tmp_path):
    import subprocess

    agent = tmp_path / "bench_agent.py"
    agent.write_text(AGENT)
    base = free_range(2)
    runner_port = free_ports(1)[0]
    env = port_env()
    env.update(KF_CONFIG_SEGMENT_MIN_BYTES="0", KF_CONFIG_WIRE_MIN_BYTES="0")
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "2", "-H", "127.0.0.1:2",
         "-port-range", f"{base}-{base + 1}", "-runner-port", str(runner_port),
         "-monitor-port", "0", "-builtin-config-port", "0", "-timeout", "120",
         sys.executable, str(agent)],
        env=env, capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    lines = r.stdout.splitlines()
    assert any("RESULT:" in x and "[HOST x2 workers, tiny]" in x for x in lines), r.stdout
    assert any("WIRE " in x and "RING_SEGMENTED" in x and 'codec="bf16"' in x for x in lines)
    assert any("WIRE saved by codec" in x for x in lines)
    assert any("EFF " in x and "wait" in x and "walks)" in x for x in lines)
    assert any("RESOURCES tiny: cpu" in x for x in lines), r.stdout
    assert any("MEMORY tiny: rss" in x for x in lines), r.stdout
