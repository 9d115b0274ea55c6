"""The port's checkpointer (`kungfu_tpu_torch/elastic/checkpoint.py`)
against the JAX package's: the reference's six checkpoint cases
(tests/test_checkpoint.py) rerun on the port; `dump_final_variables`
byte for byte the reference's file over 13 dtypes and nested dicts with
unsorted keys; each package loading the other's file; a save killed at
three points leaving `latest_step` where it was; one resume under the
port's kfrun `-auto-recover`; `api.trace_summary` against the
reference's arithmetic; `ElasticState.note_checkpoint`; and the torch
frontend's S-SGD hooks through a 2 -> 4 -> 2 resize (a known fault,
strict xfail: ROADMAP Queue 3)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kungfu_tpu.elastic import checkpoint as rcheckpoint
from kungfu_tpu_torch import api
from kungfu_tpu_torch.elastic.checkpoint import (
    STATE_FILE,
    Checkpointer,
    dump_final_variables,
    load_final_variables,
)
from kungfu_tpu_torch.utils import trace

from test_torch_port_runner import free_range, port_env
from test_torch_port_worlds import free_ports

REPO = Path(__file__).resolve().parent.parent
RUN_TIMEOUT = 240  # seconds one spawned kfrun world may take


def _state(v):
    return {
        "params": {"w": torch.full((3, 2), float(v)), "b": torch.ones(2) * v},
        "opt": {"momentum": torch.zeros(2)},
    }


def _ckpt(path, **kw):
    return Checkpointer(str(path), device="cpu", **kw)


# ---------------------------------------------------------------------------
# the reference's six cases, on the port
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    ckpt = _ckpt(tmp_path / "ck", save_rank=None)
    assert ckpt.latest_step() is None
    state, start = ckpt.restore_or(_state(0))
    assert start == 0
    for step in (1, 2, 3):
        assert ckpt.save(step, _state(step))
    out, start = ckpt.restore_or(_state(0))
    assert start == 3
    np.testing.assert_array_equal(out["params"]["w"].numpy(), np.full((3, 2), 3.0))
    ckpt.close()


def test_window_bounds_old_steps(tmp_path):
    ckpt = _ckpt(tmp_path / "ck", max_to_keep=2, save_rank=None)
    for step in range(1, 5):
        ckpt.save(step, _state(step))
    assert ckpt.all_steps() == [3, 4]
    # nothing else is left in the directory: no temporaries, no old steps
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4"]
    ckpt.close()


def test_recover_epoch_caps_restore(tmp_path, monkeypatch):
    """A checkpoint ahead of the cluster-wide safe epoch must be skipped
    (KF_RECOVER_EPOCH contract of the monitored runner)."""
    ckpt = _ckpt(tmp_path / "ck", save_rank=None)
    for step in (1, 2, 3):
        ckpt.save(step, _state(step))
    monkeypatch.setenv("KF_RECOVER_EPOCH", "2")
    assert ckpt.latest_step() == 2
    out, start = ckpt.restore_or(_state(0))
    assert start == 2
    np.testing.assert_array_equal(out["params"]["b"].numpy(), [2.0, 2.0])
    ckpt.close()


def test_rank_gating(tmp_path, monkeypatch):
    ckpt = _ckpt(tmp_path / "ck", save_rank=0)
    monkeypatch.setattr(Checkpointer, "_my_rank", lambda self: 1)
    assert not ckpt.save(1, _state(1))
    assert ckpt.latest_step() is None
    monkeypatch.setattr(Checkpointer, "_my_rank", lambda self: 0)
    assert ckpt.save(1, _state(1))
    ckpt.close()


def test_dump_final_variables_bf16(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.bfloat16) / 3, "s": torch.tensor(2.5)}
    path = str(tmp_path / "variables-final.kf")
    dump_final_variables(path, tree)
    out = load_final_variables(path, tree)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], tree["w"])
    assert float(out["s"]) == 2.5


CKPT_AGENT = textwrap.dedent("""\
    import os, sys
    import torch
    from kungfu_tpu_torch import api, cmd
    from kungfu_tpu_torch.elastic.checkpoint import Checkpointer

    CKDIR = sys.argv[1]
    EPOCHS = 5
    rank = api.current_rank()
    restart = "--restart" in sys.argv
    ckpt = Checkpointer(CKDIR, save_rank=0, device="cpu")
    state, start = ckpt.restore_or({"acc": torch.zeros(3, dtype=torch.float64)})
    print(f"agent rank={rank} restart={restart} start={start}", flush=True)
    if restart:
        assert start >= 2, f"resume lost the checkpoint: start={start}"
    for epoch in range(start, EPOCHS):
        cmd.monitor_batch_begin(rank)
        # "training": every epoch adds the epoch index, allreduced
        delta = api.all_reduce_array(torch.full((3,), float(epoch), dtype=torch.float64),
                                     name=f"e{epoch}") / api.cluster_size()
        state = {"acc": state["acc"] + delta}
        cmd.monitor_batch_end(rank)
        ckpt.save(epoch + 1, state)
        cmd.monitor_epoch_end(rank)
        if epoch == 2 and not restart and rank == 0:
            print("agent: crash after epoch 3 checkpoint", flush=True)
            os._exit(5)
    expect = sum(range(EPOCHS))
    got = float(state["acc"][0])
    assert got == expect, (got, expect)
    cmd.monitor_train_end(rank)
    print(f"agent done rank={rank} acc={got}", flush=True)
""")


def test_checkpoint_resume_under_auto_recover(tmp_path):
    """The port's kfrun -auto-recover: a worker crashes after the epoch-3
    checkpoint; the relaunch restores from it (capped by
    KF_RECOVER_EPOCH) and the final accumulated state is exactly the
    no-crash result."""
    (tmp_path / "agent.py").write_text(CKPT_AGENT)
    base, runner = free_range(2), free_ports(1)[0]
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "2", "-H", "127.0.0.1:2",
         "-auto-recover", "10s", "-monitor-port", "0", "-port-range", f"{base}-{base + 1}",
         "-runner-port", str(runner), "--", sys.executable, str(tmp_path / "agent.py"),
         str(tmp_path / "ck")],
        env=port_env(), capture_output=True, text=True, timeout=RUN_TIMEOUT, cwd=REPO)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "crash after epoch 3 checkpoint" in r.stdout
    done = [l for l in r.stdout.splitlines() if "agent done" in l]
    assert len(done) == 2, r.stdout
    for l in done:
        assert "acc=10.0" in l, l
    # the relaunch really resumed (start>=2), it didn't redo everything
    resumed = [l for l in r.stdout.splitlines() if "restart=True" in l]
    assert len(resumed) == 2, r.stdout


# ---------------------------------------------------------------------------
# dump_final_variables byte for byte, and across packages
# ---------------------------------------------------------------------------

DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
          "float16", "bfloat16", "float32", "float64"]


def _np_values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return np.asarray(rng.integers(0, 2, shape)).astype(bool)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return np.asarray(rng.integers(max(info.min, -1000), min(info.max, 1000), shape)).astype(dtype)
    a = np.asarray(rng.normal(size=shape) * 3)
    return a.astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _trees(dtype, seed=0):
    """The same tree in both packages' terms: numpy leaves for the
    reference, tensors for the port; dict keys given unsorted."""
    np_tree = {"z": _np_values(dtype, (3, 4), seed), "a": _np_values(dtype, (5,), seed + 1),
               "m": {"y": _np_values(dtype, (), seed + 2), "b": _np_values(dtype, (2, 1, 2),
                                                                           seed + 3)}}

    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _to_torch(v) for k, v in t.items()}

    return np_tree, conv(np_tree)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dump_final_variables_is_byte_equal_to_the_references(dtype, tmp_path):
    np_tree, t_tree = _trees(dtype)
    rcheckpoint.dump_final_variables(str(tmp_path / "ref.kf"), np_tree)
    dump_final_variables(str(tmp_path / "port.kf"), t_tree)
    assert (tmp_path / "port.kf").read_bytes() == (tmp_path / "ref.kf").read_bytes()


def test_dump_final_variables_of_a_mixed_nested_tree_is_byte_equal(tmp_path):
    """Dicts with unsorted keys inside lists and tuples, every dtype at
    once, empty and zero-dimensional leaves, a Python number."""
    leaves = {d: _np_values(d, (2, 3), i) for i, d in enumerate(DTYPES)}
    np_tree = {"zz": [leaves[d] for d in DTYPES[:6]],
               "aa": ({"q": leaves[d], "c": np.zeros((0, 3), np.float32)} for d in DTYPES[6:]),
               "s": 2.5}
    np_tree["aa"] = tuple(np_tree["aa"])
    t_tree = {"zz": [_to_torch(a) for a in np_tree["zz"]],
              "aa": tuple({"q": _to_torch(x["q"]), "c": torch.zeros(0, 3)} for x in np_tree["aa"]),
              "s": 2.5}
    rcheckpoint.dump_final_variables(str(tmp_path / "ref.kf"), np_tree)
    dump_final_variables(str(tmp_path / "port.kf"), t_tree)
    assert (tmp_path / "port.kf").read_bytes() == (tmp_path / "ref.kf").read_bytes()


def _same(t: torch.Tensor, a: np.ndarray) -> bool:
    return t.shape == a.shape and t.reshape(-1).view(torch.uint8).numpy().tobytes() == \
        np.ascontiguousarray(a).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_port_loads_the_references_file(dtype, tmp_path):
    np_tree, t_tree = _trees(dtype, seed=5)
    rcheckpoint.dump_final_variables(str(tmp_path / "ref.kf"), np_tree)
    like = {"z": torch.zeros_like(t_tree["z"]), "a": torch.zeros_like(t_tree["a"]),
            "m": {"y": torch.zeros_like(t_tree["m"]["y"]), "b": torch.zeros_like(t_tree["m"]["b"])}}
    out = load_final_variables(str(tmp_path / "ref.kf"), like)
    for got, want in [(out["z"], np_tree["z"]), (out["a"], np_tree["a"]),
                      (out["m"]["y"], np_tree["m"]["y"]), (out["m"]["b"], np_tree["m"]["b"])]:
        assert got.dtype == t_tree["z"].dtype and _same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_reference_loads_the_ports_file(dtype, tmp_path):
    np_tree, t_tree = _trees(dtype, seed=9)
    dump_final_variables(str(tmp_path / "port.kf"), t_tree)
    out = rcheckpoint.load_final_variables(str(tmp_path / "port.kf"), np_tree)
    for key in ("z", "a"):
        got = np.asarray(out[key])
        assert got.dtype == np_tree[key].dtype and got.tobytes() == np_tree[key].tobytes()
    for key in ("y", "b"):
        got = np.asarray(out["m"][key])
        assert got.dtype == np_tree["m"][key].dtype and got.tobytes() == np_tree["m"][key].tobytes()


def test_reference_jax_arrays_dump_as_the_ports_tensors(tmp_path):
    """The reference's own use: jax arrays on its device, bf16 among them."""
    tree = {"w": jnp.arange(6, dtype=jnp.bfloat16) / 3, "s": jnp.float32(2.5),
            "k": jnp.arange(4, dtype=jnp.int32)}
    rcheckpoint.dump_final_variables(str(tmp_path / "ref.kf"), tree)
    port = {"w": torch.arange(6, dtype=torch.bfloat16) / 3, "s": torch.tensor(2.5),
            "k": torch.arange(4, dtype=torch.int32)}
    dump_final_variables(str(tmp_path / "port.kf"), port)
    assert (tmp_path / "port.kf").read_bytes() == (tmp_path / "ref.kf").read_bytes()


# ---------------------------------------------------------------------------
# restore onto a tree; a save killed mid-write
# ---------------------------------------------------------------------------

def test_restore_keeps_each_leafs_dtype_shape_and_kind(tmp_path):
    ckpt = _ckpt(tmp_path / "ck", save_rank=None)
    state = {"w": torch.randn(3, 4).to(torch.bfloat16), "i": torch.arange(5, dtype=torch.int64),
             "n": np.arange(3, dtype=np.float32), "s": 7, "cl": torch.randn(2, 3, 4, 5).to(
                 memory_format=torch.channels_last)}
    ckpt.save(4, state)
    like = {"w": torch.zeros(3, 4, dtype=torch.bfloat16), "i": torch.zeros(5, dtype=torch.int64),
            "n": np.zeros(3, np.float32), "s": 0, "cl": torch.zeros(2, 3, 4, 5)}
    out = ckpt.restore(like)
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], state["w"])
    assert out["i"].dtype == torch.int64 and torch.equal(out["i"], state["i"])
    assert isinstance(out["n"], np.ndarray) and np.array_equal(out["n"], state["n"])
    assert int(out["s"]) == 7 and out["cl"].shape == (2, 3, 4, 5)
    assert torch.equal(out["cl"], state["cl"])
    assert ckpt.restore(like, step=4)["i"].tolist() == [0, 1, 2, 3, 4]


def test_restore_raises_without_a_checkpoint_and_on_another_tree(tmp_path):
    ckpt = _ckpt(tmp_path / "ck", save_rank=None)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(_state(0))
    ckpt.save(1, _state(1))
    with pytest.raises(ValueError, match="leaf"):
        ckpt.restore({"params": {"w": torch.zeros(3, 2)}})  # fewer leaves
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"params": {"w": torch.zeros(2, 3), "b": torch.zeros(2)},
                      "opt": {"momentum": torch.zeros(2)}})


def test_resaving_a_step_replaces_it(tmp_path):
    ckpt = _ckpt(tmp_path / "ck", save_rank=None)
    ckpt.save(2, _state(2))
    ckpt.save(2, _state(9))
    assert ckpt.all_steps() == [2]
    assert float(ckpt.restore(_state(0))["params"]["b"][0]) == 9.0


def test_the_checkpointer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        Checkpointer(str(tmp_path / "ck"))
    assert Checkpointer(str(tmp_path / "ck"), device="cpu").device.type == "cpu"


KILL_POINTS = {
    # half the blob written, then the process dies
    "mid_write": "ck._write_durably = lambda path, data: (open(path, 'wb').write(data[:len(data) // 2]), os._exit(9))",
    # the file whole and synced, the directory not yet in place
    "before_rename": "real = os.replace\n"
                     "os.replace = lambda a, b: os._exit(9) if '.tmp-' in a and 'gone' not in b else real(a, b)",
    # the old step's removal half done: renamed away, not yet deleted
    "mid_prune": "ck.shutil.rmtree = lambda *a, **k: os._exit(9)",
}


@pytest.mark.parametrize("point", list(KILL_POINTS))
def test_a_save_killed_mid_write_leaves_latest_step_unchanged(point, tmp_path):
    ckdir = tmp_path / "ck"
    ckpt = _ckpt(ckdir, max_to_keep=2, save_rank=None)
    ckpt.save(1, _state(1))
    ckpt.save(2, _state(2))
    code = textwrap.dedent(f"""\
        import os, sys, torch
        sys.path.insert(0, {str(REPO)!r})
        from kungfu_tpu_torch.elastic import checkpoint as ck
        c = ck.Checkpointer({str(ckdir)!r}, max_to_keep=2, save_rank=None, device="cpu")
        """) + KILL_POINTS[point] + textwrap.dedent("""
        c.save(3, {"params": {"w": torch.full((3, 2), 3.0), "b": torch.ones(2) * 3},
                   "opt": {"momentum": torch.zeros(2)}})
        print("SAVED", flush=True)
        """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 9 and "SAVED" not in r.stdout, r.stdout + r.stderr
    want = 3 if point == "mid_prune" else 2  # step 3 was in place before the prune
    assert ckpt.latest_step() == want
    out = ckpt.restore(_state(0))
    assert float(out["params"]["b"][0]) == float(want)
    # the directory stays usable: the next save lands and prunes
    ckpt.save(4, _state(4))
    assert ckpt.latest_step() == 4 and len(ckpt.all_steps()) == 2


def test_a_step_directory_without_its_file_is_not_a_step(tmp_path):
    ckpt = _ckpt(tmp_path / "ck", save_rank=None)
    ckpt.save(1, _state(1))
    os.mkdir(tmp_path / "ck" / "5")  # a foreign or broken directory
    (tmp_path / "ck" / "7").mkdir()
    (tmp_path / "ck" / "7" / (STATE_FILE + ".partial")).write_bytes(b"x")
    assert ckpt.latest_step() == 1


# ---------------------------------------------------------------------------
# trace_summary; ElasticState.note_checkpoint
# ---------------------------------------------------------------------------

def test_trace_summary_totals_spans_by_name_as_the_reference():
    from kungfu_tpu.telemetry import tracing as rtracing

    trace.clear()
    durations = [("worker.startup", 0.01234), ("worker.peer_init", 0.00051),
                 ("worker.startup", 0.2), ("collective.all_reduce", 0.00333),
                 ("worker.parse_config", 0.0000449)]
    for name, d in durations:
        trace.record(name, d)
    want = {}
    for name, d in durations:
        want[name] = want.get(name, 0.0) + d * 1e3
    want = {k: round(v, 1) for k, v in want.items()}
    assert api.trace_summary() == want
    assert api.trace_summary("worker.") == {k: v for k, v in want.items()
                                            if k.startswith("worker.")}
    # the reference's own function on the same events
    rtracing.clear()
    for name, d in durations:
        rtracing.record(name, d)
    assert rtracing.summary_ms("worker.") == api.trace_summary("worker.")
    trace.clear()
    rtracing.clear()


def test_note_checkpoint_records_the_version(monkeypatch):
    from kungfu_tpu_torch.elastic.state import ElasticState

    class FakePeer:
        class config:
            init_progress = 0

    monkeypatch.setattr("kungfu_tpu_torch.peer.get_default_peer", lambda: FakePeer())
    es = ElasticState(max_progress=10)
    assert es._checkpoint_version is None
    es.note_checkpoint(np.int64(3))
    assert es._checkpoint_version == 3 and type(es._checkpoint_version) is int


# ---------------------------------------------------------------------------
# the torch frontend's hooks across a resize
# ---------------------------------------------------------------------------

HOOK_WORKER = textwrap.dedent("""\
    import hashlib, json
    import torch
    from kungfu_tpu_torch import api
    from kungfu_tpu_torch import torch as kf_torch
    from kungfu_tpu_torch.elastic import ElasticState, StepBasedSchedule
    from kungfu_tpu_torch.models.mlp import init_mlp, mlp_loss

    SCHEDULE, BATCH = "2:3,4:3,2:3", 8
    models = {k: init_mlp(torch.Generator().manual_seed(0), in_dim=16, hidden=8, out_dim=4,
                          device="cpu") for k in ("hooks", "step_end")}
    opts = {k: torch.optim.SGD(m.parameters(), lr=0.1) for k, m in models.items()}
    hooks = kf_torch.SynchronousSGDOptimizer(opts["hooks"], name="hooks")
    sched = StepBasedSchedule(SCHEDULE)
    es = ElasticState(max_progress=sum(n * s for n, s in [(2, 3), (4, 3), (2, 3)]) * BATCH)
    state = {"hooks": models["hooks"].tree(), "step_end": models["step_end"].tree(),
             "step": torch.zeros(1, dtype=torch.int64)}

    @torch.no_grad()
    def set_state(t):
        for k in ("hooks", "step_end"):
            for n, v in t[k].items():
                state[k][n].copy_(v)
        state["step"].copy_(t["step"])

    es.register_state(lambda: state, set_state)

    def digest(m):
        return hashlib.sha256(b"".join(p.detach().numpy().tobytes()
                                       for p in m.parameters())).hexdigest()

    while not es.stopped():
        with es.scope():
            rank, size = api.current_rank(), api.cluster_size()
            g = torch.Generator().manual_seed(es.progress * 100 + rank)
            x, y = torch.randn(BATCH, 16, generator=g), torch.randint(0, 4, (BATCH,), generator=g)
            hooks.zero_grad()
            mlp_loss(models["hooks"].tree(), (x, y)).backward()
            hooks.step()
            # the step-end path: the fused gradients summed under the synced progress
            opts["step_end"].zero_grad()
            mlp_loss(models["step_end"].tree(), (x, y)).backward()
            ps = list(models["step_end"].parameters())
            avg = api.all_reduce_array(torch.cat([p.grad.reshape(-1) for p in ps]),
                                       name=f"g{es.progress}") / size
            off = 0
            for p in ps:
                p.grad.copy_(avg[off:off + p.numel()].view_as(p))
                off += p.numel()
            opts["step_end"].step()
            state["step"] += 1
            print("STEP " + json.dumps({"step": int(state["step"]) - 1, "rank": rank,
                                        "size": size, "hooks": digest(models["hooks"]),
                                        "step_end": digest(models["step_end"])}), flush=True)
            if rank == 0:
                sched.maybe_propose(int(state["step"]))
            es.end(BATCH * size)
    print(f"done reason={es.stop_reason}", flush=True)
""")


@pytest.mark.xfail(strict=True, reason=(
    "ROADMAP Queue 3: the torch frontend's wire names count rounds per process "
    "(the scheduler's rounds, _sync_round, the optimizer's step), so a joiner's first "
    "step cannot meet the survivors' and the grow hangs"))
def test_synchronous_sgd_hooks_survive_a_resize_bitwise_equal_to_the_step_end_path(tmp_path):
    """SynchronousSGDOptimizer's post-accumulate-grad hooks (KF_CONFIG_ASYNC
    on) through StepBasedSchedule("2:3,4:3,2:3") under the port's kfrun -w:
    after every step every rank's hook-path parameters must equal the
    step-end path's bit for bit."""
    (tmp_path / "w.py").write_text(HOOK_WORKER)
    base, runner = free_range(4), free_ports(1)[0]
    env = port_env()
    env["KF_CONFIG_ASYNC"] = "on"
    r = subprocess.run(
        [sys.executable, "-m", "kungfu_tpu_torch.runner.cli", "-np", "2", "-H", "127.0.0.1:4",
         "-w", "-builtin-config-port", "0", "-port-range", f"{base}-{base + 3}",
         "-runner-port", str(runner), "-monitor-port", "0", "-timeout", "30",
         "--", sys.executable, str(tmp_path / "w.py")],
        env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT, cwd=REPO)
    steps = [json.loads(l.split("STEP ", 1)[1]) for l in r.stdout.splitlines() if "STEP " in l]
    sizes = {}
    for s in steps:
        assert s["hooks"] == s["step_end"], s
        sizes.setdefault(s["step"], set()).add(s["size"])
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert [sorted(sizes[i])[0] for i in sorted(sizes)] == [2, 2, 2, 4, 4, 4, 2, 2, 2]
