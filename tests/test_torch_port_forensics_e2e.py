"""Run-level forensics end to end under the port's kfrun (`-w -debug-port`),
one world of 4 workers at a time on ports in 12000-19999, the debug port
there too; mirrors tests/test_steps_e2e.py and tests/test_flight_e2e.py.

- 4 port workers under a shaped edge (`KF_SHAPE_LINKS`: 30 ms on each of
  rank 1's sends to rank 2) run asynchronous group all-reduce rounds
  under a PolicyRunner: `/cluster/steps` names rank 1 and its edge to
  rank 2 within a few steps, `/cluster/health` carries the steps summary,
  and every worker's own ring, lanes and ``step/*`` signals agree.
- A mixed world, ranks 0 and 2 the JAX package's workers and 1 and 3 the
  port's, under the port's kfrun: the same election, and
  `/cluster/health` lists all 4 peers.
- A port worker that SIGKILLs itself under `-w -auto-recover` leaves its
  black box at every surface: the runner's `worker_postmortem` audit
  record (`/cluster/audit`), `/cluster/postmortem` and
  `<run dir>/postmortems.jsonl`, each naming the signal and the worker's
  last printed line; the survivors' journals read back whole."""

import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.request
from pathlib import Path

import pytest

from kungfu_tpu.telemetry import flight as rflight
from kungfu_tpu_torch.telemetry import flight
from test_torch_port_runner import free_range, port_env

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""\
    import json, os, signal, sys, time
    me = os.environ["KF_SELF_SPEC"]
    specs = os.environ["KF_INIT_PEERS"].split(",")
    rank = specs.index(me)
    if os.environ.get("KF_INIT_CLUSTER_VERSION", "0") != "0":
        time.sleep(120)  # a survivor respawned by the recovery: idle until stopped
        sys.exit(0)
    ref = str(rank) in os.environ["FX_REF_RANKS"].split(",")
    import numpy as np
    if ref:
        from kungfu_tpu import api
        from kungfu_tpu.policy import PolicyRunner
        from kungfu_tpu.telemetry import steptrace
        wrap, unwrap = (lambda x: x), np.asarray
    else:
        import torch
        from kungfu_tpu_torch import api
        from kungfu_tpu_torch.policy import PolicyRunner
        from kungfu_tpu_torch.telemetry import steptrace
        wrap, unwrap = torch.from_numpy, (lambda t: t.numpy())
    k = len(specs)
    # 4 gradients of 1 MB and the ranks' stop votes, one fused bucket
    grads = [wrap(np.full(n, float(rank + 1), np.float32)) for n in [250_000] * 4 + [1]]
    outs = [wrap(np.empty(n, np.float32)) for n in [250_000] * 4 + [1]]
    done = os.environ["FX_DONE"]
    deadline = time.time() + 120
    with PolicyRunner([], batch_size=1) as runner:
        steps = 0
        while True:
            # a rank votes to stop once the harness saw the election and
            # its own signals name the edge; all stop together
            grads[4][0] = float(time.time() > deadline or os.path.exists(done) and bool(
                runner.ctx.metrics.get("step/critical_edge") or os.environ.get("FX_DIE_RANK")))
            with runner.step():
                api.group_all_reduce_async(grads, name="step", outs=outs).wait()
            assert float(unwrap(outs[0])[0]) == k * (k + 1) / 2
            steps += 1
            if float(unwrap(outs[4])[0]) == k:
                break
            time.sleep(0.05)
    tls = steptrace.get_store().timelines()
    print("FX " + json.dumps({
        "rank": rank, "ref": ref, "steps": steps,
        "rounds": [t["round"] for t in tls],
        "lanes": sorted({len(t["buckets"]) for t in tls}),
        "edges": sorted({b["edge"] for t in tls for b in t["buckets"] if b["edge"]}),
        "critical_edge": runner.ctx.metrics.get("step/critical_edge"),
        "overlap_frac": runner.ctx.metrics.get("step/overlap_frac"),
        "updated_at": runner.ctx.metrics.get("cluster/updated_at")}), flush=True)
    if os.environ.get("FX_DIE_RANK") == str(rank):
        print(f"fx rank {rank}: last words before SIGKILL", flush=True)
        time.sleep(0.5)  # the runner's pump reads the line first
        os.kill(os.getpid(), signal.SIGKILL)
    if os.environ.get("FX_DIE_RANK"):
        time.sleep(120)  # a survivor: the recovery's SIGTERM ends it
    api.run_barrier()
    """)


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


def run_world(tmp, ref_ranks="", die_rank=None, timeout=150.0):
    """One kfrun world of 4; returns what the runner's views and the
    workers showed. Steps until /cluster/steps holds 4 merged steps (and,
    with `die_rank`, until /cluster/postmortem records the death)."""
    (tmp / "w.py").write_text(WORKER)
    base, dbg, runner = free_range(4), free_range(1), free_range(1)
    specs = [f"127.0.0.1:{base + i}" for i in range(4)]
    run_dir = tmp / "run"
    env = port_env()
    env.update(KF_TELEMETRY="metrics,audit", KF_CONFIG_ASYNC="on", KF_CONFIG_ALGO="segmented",
               KF_CONFIG_SHM="0", KF_CLUSTER_SCRAPE_INTERVAL="0.5", KF_FLIGHT_INTERVAL="0.2",
               KF_SHAPE_LINKS=f"{specs[1]}>{specs[2]}=lat:30", KF_TELEMETRY_DIR=str(run_dir),
               FX_DONE=str(tmp / "done"), FX_REF_RANKS=ref_ranks,
               FX_DIE_RANK="" if die_rank is None else str(die_rank))
    extra = [] if die_rank is None else ["-auto-recover", "30s", "-builtin-config-port", "0"]
    out, err = tmp / "kfrun.out", tmp / "kfrun.err"
    p = subprocess.Popen(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "4", "-H", "127.0.0.1:4",
         "-port-range", f"{base}-{base + 3}", "-runner-port", str(runner), "-monitor-port", "0",
         "-warm-spares", "0", "-w", "-debug-port", str(dbg), "-timeout", str(int(timeout)),
         *extra, "--", sys.executable, str(tmp / "w.py")],
        env=env, cwd=REPO, stdout=out.open("w"), stderr=err.open("w"))
    url = f"http://127.0.0.1:{dbg}"
    got = {"specs": specs, "run_dir": run_dir}
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and p.poll() is None:
            try:
                steps = _get(url + "/cluster/steps")
                if steps["count"] >= 4 and "steps" not in got:
                    got["steps"], got["health"] = steps, _get(url + "/cluster/health")
                    (tmp / "done").write_text("ok")
                if "steps" in got and die_rank is not None:
                    pm = _get(url + "/cluster/postmortem")
                    if pm["deaths"]:
                        got["postmortem"] = pm
                        got["audit"] = _get(url + "/cluster/audit")
                        break
                elif "steps" in got:
                    break
            except (OSError, ValueError):
                pass
            time.sleep(0.3)
        if die_rank is None:
            p.wait(max(1.0, deadline - time.monotonic()))
        else:
            p.terminate()  # kfrun dies; its workers get SIGTERM from kf-pdeathsig
            p.wait(30)
            time.sleep(1.0)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
    got["rc"] = p.returncode
    got["stdout"], got["stderr"] = out.read_text(), err.read_text()
    got["workers"] = {w["rank"]: w for w in (json.loads(line.split("FX ", 1)[1])
                                             for line in got["stdout"].splitlines()
                                             if "FX {" in line)}
    assert "steps" in got, f"no merged steps:\n{got['stderr'][-3000:]}"
    return got


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("fxport"))


@pytest.fixture(scope="module")
def mixed_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("fxmixed"), ref_ranks="0,2")


@pytest.fixture(scope="module")
def dying_world(tmp_path_factory):
    return run_world(tmp_path_factory.mktemp("fxdeath"), die_rank=3)


def _names_the_shaped_edge(world):
    specs = world["specs"]
    recent = world["steps"]["steps"][-3:]
    assert recent and all((s["critical"]["peer"], s["critical"]["edge"]) == (specs[1], specs[2])
                          for s in recent), world["steps"]
    assert all(s["peer_count"] == 4 and 0 <= s["overlap_frac"] <= 1 for s in recent)
    summary = world["health"]["steps"]
    assert (summary["critical_peer"], summary["critical_edge"]) == (specs[1], specs[2])


def test_the_port_world_names_the_shaped_edge(port_world):
    assert port_world["rc"] == 0, port_world["stderr"][-3000:]
    _names_the_shaped_edge(port_world)


def test_the_port_workers_record_their_lanes_and_read_the_election(port_world):
    specs, workers = port_world["specs"], port_world["workers"]
    assert sorted(workers) == [0, 1, 2, 3]
    for r, w in workers.items():
        assert w["edges"] == [specs[(r + 1) % 4]]  # the ring successor
        assert w["lanes"] == [1] and w["rounds"] == sorted(set(w["rounds"]))
        assert w["critical_edge"] == specs[2] and w["updated_at"] is not None
        assert 0 <= w["overlap_frac"] <= 1


def test_a_mixed_world_names_the_shaped_edge(mixed_world):
    assert mixed_world["rc"] == 0, mixed_world["stderr"][-3000:]
    _names_the_shaped_edge(mixed_world)
    workers = mixed_world["workers"]
    assert [workers[r]["ref"] for r in range(4)] == [True, False, True, False]
    assert all(w["critical_edge"] == mixed_world["specs"][2] for w in workers.values())


def test_a_mixed_worlds_health_lists_all_four_peers(mixed_world):
    peers = mixed_world["health"]["peers"]
    assert sorted(peers) == sorted(mixed_world["specs"])
    for info in peers.values():
        assert info["error"] is None and info["step_rate"] > 0
        assert info["step_time_p50_ms"] <= info["step_time_p99_ms"]


def test_a_sigkilled_worker_is_in_cluster_postmortem(dying_world):
    dead = dying_world["specs"][3]
    pms = dying_world["postmortem"]
    assert pms["deaths"] == 1 and list(pms["peers"]) == [dead]
    pm = pms["peers"][dead][0]
    assert pm["death"] == "signal SIGKILL (-9)" and pm["clean_exit"] is False
    assert any("fx rank 3: last words before SIGKILL" in line for line in pm["output_tail"])
    assert pm["journal_records"] > 2 and pm["journal_errors"] == []
    assert pm["last_step"] == dying_world["workers"][3]["steps"]
    assert pm["last_step_timeline"]["buckets"]
    text = flight.render_postmortem(pm)
    assert "SIGKILL" in text and f"last step: {int(pm['last_step'])}" in text


def test_a_sigkilled_worker_is_in_the_runners_audit(dying_world):
    dead = dying_world["specs"][3]
    recs = [r for r in dying_world["audit"] if r["kind"] == "worker_postmortem"]
    assert len(recs) == 1 and recs[0]["peer"] == dead
    assert recs[0]["detail"]["death"] == "signal SIGKILL (-9)"
    assert f"worker_postmortem recorded for {dead}" in dying_world["stderr"]
    assert f"worker {dead} died with exit code -9" in dying_world["stderr"]


def test_a_sigkilled_worker_is_in_postmortems_jsonl(dying_world):
    run_dir, dead = str(dying_world["run_dir"]), dying_world["specs"][3]
    for mod in (flight, rflight):
        pms = mod.read_postmortems(run_dir)
        assert [pm["peer"] for pm in pms] == [dead]
        assert pms[0]["death"] == "signal SIGKILL (-9)"
    # the survivors were stopped by SIGTERM: each journal reads whole and
    # ends with its flush
    for spec in dying_world["specs"][:3]:
        recs, errors = rflight.read_journal(flight.peer_dir(run_dir, spec))
        assert errors == [] and recs[-1]["kind"] == "exit"
        assert recs[-1]["reason"] == "sigterm", recs[-1]
