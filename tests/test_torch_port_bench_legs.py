"""The port's in-process A/B benches on the CPU against the JAX
package's: `kungfu_tpu_torch/bench_hier.py` and `bench_wire_q.py`, each
leg at small sizes (k 4-16 peers over 2-4 virtual hosts): the
reference's JSON keys and exact checks (every walk's sum, the measured
clustering recovering the shaped hosts, one plan digest, bit-identical
rounds, the quantized wires' byte ratios), the live demotion graded
`delivered` and promoted back, and the process left as found.
`bench_wire_q`'s vote-ledger leg grades its flips from step times and
is run by hand (`python -m kungfu_tpu_torch.bench_wire_q`).

In-process worlds bind port 0 outside 38000-38999."""

import json

import pytest

from kungfu_tpu_torch import bench_hier, bench_wire_q
from test_torch_port_worlds import free_ports, small_arenas  # noqa: F401 - a fixture


# ---------------------------------------------------------------------------
# bench_hier and bench_wire_q at small sizes
# ---------------------------------------------------------------------------

HIER_KEYS = {
    "k64_shared_uplink_ab": {"experiment", "k", "hosts", "payload_bytes", "naive_round_ms",
                             "flat_measured_round_ms", "hier_round_ms", "speedup_hier_vs_flat",
                             "speedup_hier_vs_naive", "flat_order_crossings", "hier_heads",
                             "rounds_per_block", "blocks"},
    "k256_lockstep_adoption": {"experiment", "k", "hosts", "peer_start_s", "lockstep_adopt_s",
                               "hier_walk_round_s", "walk_harness_s", "groups",
                               "within_budget", "budget_s"},
    "k8_live_demotion": {"experiment", "k", "straggler_rank", "ledger_window",
                         "demote_patience", "shaped_round_ms", "demoted_round_ms",
                         "demote_step", "demoted", "verdicts", "verdict_step", "unshape_step",
                         "promote_step", "promoted_within_windows"},
}


@pytest.fixture
def bench_ports(monkeypatch):
    """The benches' peers on ports bound to 0 outside 38000-38999 (both
    benches start their clusters through bench_hier's)."""
    monkeypatch.setattr(bench_hier, "_reserve_ports", free_ports)


def _printed(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]


@pytest.mark.parametrize("k,hosts", [(8, 2), (8, 4)])
def test_the_shared_uplink_ab_recovers_the_hosts(k, hosts, bench_ports, capsys):
    out = bench_hier.k64_shared_uplink_ab(k=k, hosts=hosts, n=16 * 1024, rounds=2, blocks=1)
    assert _printed(capsys) == [out] and set(out) == HIER_KEYS["k64_shared_uplink_ab"]
    assert (out["k"], out["hosts"], out["payload_bytes"]) == (k, hosts, 64 << 10)
    assert len(out["hier_heads"]) == hosts
    assert sorted(h % hosts for h in out["hier_heads"]) == list(range(hosts))


@pytest.mark.parametrize("k,hosts", [(8, 2), (16, 4)])
def test_the_lockstep_adoption_derives_one_plan(k, hosts, bench_ports, capsys):
    out = bench_hier.k256_lockstep_adoption(k=k, hosts=hosts)
    assert _printed(capsys) == [out] and set(out) == HIER_KEYS["k256_lockstep_adoption"]
    assert out["groups"] == hosts and out["within_budget"]


def test_a_live_demotion_is_delivered_and_promoted_back(bench_ports, capsys):
    # the k=64 leg's probes (3 frames of 64 KiB): the reference's 2 of 16
    # KiB can blur the two hosts' rates on a host busy with other tests
    out = bench_hier.k8_live_demotion(probe_frames=3, probe_bytes=64 << 10)
    assert _printed(capsys) == [out] and set(out) == HIER_KEYS["k8_live_demotion"]
    assert out["demoted"] == [5] and out["verdicts"] == ["delivered"]
    assert out["promote_step"] > out["unshape_step"] >= out["verdict_step"] > out["demote_step"]


def test_the_benches_leave_the_process_as_they_found_it(bench_ports):
    import os

    from kungfu_tpu_torch.collective.host_session import HostSession
    from kungfu_tpu_torch.transport import shaping

    before = (HostSession.SEGMENT_MIN_BYTES, HostSession.WIRE_MIN_BYTES, shaping.BURST_SECONDS,
              os.environ.get("KF_CONFIG_SHM"), os.environ.get("KF_TELEMETRY"))
    bench_hier.k256_lockstep_adoption(k=4, hosts=2)
    bench_wire_q.k8_zero_weight_ab(k=4, n=4096, rounds=1, blocks=1, min_speedup=None)
    assert before == (HostSession.SEGMENT_MIN_BYTES, HostSession.WIRE_MIN_BYTES,
                      shaping.BURST_SECONDS, os.environ.get("KF_CONFIG_SHM"),
                      os.environ.get("KF_TELEMETRY"))


@pytest.mark.parametrize("k,hosts", [(4, 2), (8, 2)])
def test_the_wire_precision_ab_measures_the_references_ratios(k, hosts, bench_ports, capsys):
    out = bench_wire_q.k8_wire_precision_ab(k=k, hosts=hosts, n=16 * 1024, rounds=2, blocks=1,
                                            min_speedup=None)
    assert _printed(capsys) == [out]
    assert set(out) == {"experiment", "k", "hosts", "payload_bytes", "rounds_per_block",
                        "blocks", "round_ms", "speedup_int8_vs_bf16", "speedup_int4_vs_bf16",
                        "wire_payload_ratio", "saved_matches_wire"}
    assert out["wire_payload_ratio"] == {"bf16": 0.5, "int8": 0.3125, "int4": 0.1875}
    assert all(out["saved_matches_wire"].values())


@pytest.mark.parametrize("k", [4, 8])
def test_the_zero_weight_ab_keeps_every_peers_weights_equal(k, bench_ports, capsys):
    out = bench_wire_q.k8_zero_weight_ab(k=k, n=16 * 1024, rounds=2, blocks=1, min_speedup=None)
    assert _printed(capsys) == [out]
    assert set(out) == {"experiment", "k", "param_bytes", "rounds_per_block", "blocks",
                        "step_ms", "speedup_int8_vs_bf16", "speedup_int4_vs_bf16",
                        "params_converged_finite"}
    assert out["params_converged_finite"] and set(out["step_ms"]) == {"bf16", "int8", "int4"}
