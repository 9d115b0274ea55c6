"""The port's policy engine (`kungfu_tpu_torch/policy.py`) against the JAX
package's (`kungfu_tpu/policy.py`); mirrors the policy cases of
tests/test_replan.py and tests/test_decisions.py.

- Fake sessions fed the same seeded metric sequences make the same
  re-plan votes, stale-row withholds, demotions, promotions and
  rollbacks under each package's `ReplanPolicy`, the same precision
  votes, rollbacks and cooldown withholds under `PrecisionPolicy`, and
  the same straggler actions under `StragglerPolicy`.
- `PolicyRunner` publishes step timing, feeds the decision ledger, and
  refreshes the link-table, walk-profiler and ledger signals with the
  reference's key eviction; one failing plane never drops the others.
In process, no transport."""

import random

import pytest

from kungfu_tpu import policy as rpolicy
from kungfu_tpu.telemetry import decisions as rdecisions
from kungfu_tpu_torch import policy
from kungfu_tpu_torch.telemetry import config, decisions, link, metrics
from test_torch_port_telemetry import clean_telemetry  # noqa: F401

PEERS = [f"127.0.0.1:{10000 + i}" for i in range(4)]


class _Peers:
    """A peer list that ranks either package's PeerID by its text."""

    def __getitem__(self, r):
        return PEERS[r]

    def rank(self, pid):
        s = str(pid)
        return PEERS.index(s) if s in PEERS else None


class _Plan:
    def __init__(self, order, gain):
        self.order, self.gain = tuple(order), gain


class FakeSession:
    """The rounds the policies drive, as a deterministic function of the
    votes: a re-plan adopts on every second yes-vote, a demote/promote
    proposal always carries, a precision proposal carries on odd rounds."""

    def __init__(self, replan_mode="hier", size=4):
        self.size, self.replan_mode, self.peers = size, replan_mode, _Peers()
        self.calls = []
        self._demoted = ()
        self._yes = 0
        self._rounds = 0
        self._wire = "off"

    def check_replan(self, want=True, min_gain=1.05):
        self.calls.append(("replan", want, min_gain))
        if not want:
            return None
        self._yes += 1
        return _Plan([0, 2, 1, 3], 1.5) if self._yes % 2 == 0 else None

    def check_demote(self, demote=None, promote=None):
        self.calls.append(("demote", demote, promote))
        new = tuple(sorted((set(self._demoted) | ({demote} if demote is not None else set()))
                           - ({promote} if promote is not None else set())))
        if new == self._demoted:
            return None
        self._demoted = new
        return _Plan([0, 1, 2, 3], 1.0)

    def demoted_peers(self):
        return self._demoted

    def active_wire_mode(self):
        return self._wire

    def check_precision(self, proposal=None, trigger="noise_scale", signals=None):
        self._rounds += 1
        self.calls.append(("precision", proposal, trigger, dict(signals or {})))
        if proposal is not None and proposal != self._wire and self._rounds % 2:
            self._wire = proposal
            return proposal
        return None


def _replan_metrics(rng, step):
    m = {}
    if rng.random() < 0.7:
        m["links/slowest_edge"] = [None, rng.choice(PEERS[1:3])]
    if rng.random() < 0.3:
        m["step/critical_edge"] = rng.choice(PEERS)
    if rng.random() < 0.5:
        m["cluster/updated_at"] = step // rng.choice([1, 2, 3])
    if rng.random() < 0.2:
        m["links/oldest_row_age_s"] = rng.choice([5.0, 120.0])
    if rng.random() < 0.6:
        m["step/critical_peer"] = rng.choice([PEERS[3], PEERS[3], PEERS[2], None])
    if rng.random() < 0.5:
        m["cluster/straggler_causes"] = {PEERS[3]: rng.choice(["compute", "network", "memory"])}
    if rng.random() < 0.2:
        m["resource/saturated_peers"] = [PEERS[2]]
    if rng.random() < 0.3:
        m["cluster/stragglers"] = rng.sample(PEERS, rng.randint(0, 2))
    if rng.random() < 0.1:
        m["decision/regressed"] = ["peer_demoted"]
    return m


def _drive(pkg, seed, steps, make_policy, metrics_of, sess):
    rng = random.Random(seed)
    pol = make_policy(pkg, sess)
    ctx = pkg.PolicyContext(batch_size=32)
    seen = []
    for step in range(1, steps + 1):
        ctx.step = step
        for k in list(ctx.metrics):
            if not k.startswith(("replan/", "precision/", "cluster/straggler_action")):
                ctx.metrics.pop(k)
        ctx.metrics.update(metrics_of(rng, step))
        pol.after_step(ctx)
        seen.append({k: v for k, v in ctx.metrics.items()
                     if k.startswith(("replan/", "precision/", "cluster/straggler_action"))})
    return sess.calls, seen


def _replan_policy(interval, patience, demote_patience):
    def make(pkg, sess):
        return pkg.ReplanPolicy(interval_steps=interval, patience=patience,
                                session_supplier=lambda: sess,
                                demote_patience=demote_patience)
    return make


@pytest.mark.parametrize("mode", ["hier", "auto"])
@pytest.mark.parametrize("interval,patience,demote_patience", [(1, 1, 1), (2, 2, 2), (4, 3, 1)])
@pytest.mark.parametrize("seed", range(4))
def test_replan_policies_vote_alike(seed, interval, patience, demote_patience, mode,
                                    monkeypatch):
    for pkg in (decisions, rdecisions):
        monkeypatch.setattr(pkg.get_ledger(), "window", 2)
    make = _replan_policy(interval, patience, demote_patience)
    mine = _drive(policy, seed, 60, make, _replan_metrics, FakeSession(mode))
    theirs = _drive(rpolicy, seed, 60, make, _replan_metrics, FakeSession(mode))
    assert mine == theirs
    assert any(c[0] == "replan" for c in mine[0])


def test_replan_policy_withholds_its_vote_on_stale_rows():
    for pkg in (policy, rpolicy):
        sess = FakeSession("auto")
        pol = pkg.ReplanPolicy(interval_steps=1, patience=1, session_supplier=lambda: sess,
                               max_row_age_s=30.0)
        ctx = pkg.PolicyContext(batch_size=1)
        ctx.step = 1
        ctx.metrics.update({"links/slowest_edge": [None, PEERS[2]],
                            "links/oldest_row_age_s": 31.0})
        pol.after_step(ctx)
        assert sess.calls == [("replan", False, 1.05)]
        assert ctx.metrics["replan/vote_withheld_stale_links"] == 31.0


def test_replan_policy_rejects_a_zero_interval():
    for pkg in (policy, rpolicy):
        with pytest.raises(ValueError):
            pkg.ReplanPolicy(interval_steps=0)


def _precision_metrics(rng, step):
    m = {"monitor/noise_scale": rng.choice([None, 10.0, 300.0, 5000.0, -1.0])}
    if rng.random() < 0.1:
        m["decision/regressed"] = ["precision_switch"]
    return {k: v for k, v in m.items() if v is not None}


@pytest.mark.parametrize("interval,patience,cooldown", [(1, 1, 0), (2, 2, 3), (3, 1, 8)])
@pytest.mark.parametrize("seed", range(4))
def test_precision_policies_vote_alike(seed, interval, patience, cooldown):
    def make(pkg, sess):
        return pkg.PrecisionPolicy(interval_steps=interval, patience=patience,
                                   cooldown_intervals=cooldown, session_supplier=lambda: sess)

    mine = _drive(policy, seed, 50, make, _precision_metrics, FakeSession())
    theirs = _drive(rpolicy, seed, 50, make, _precision_metrics, FakeSession())
    assert mine == theirs


def _straggler_metrics(rng, step):
    m = {"cluster/updated_at": step // 2}
    if rng.random() < 0.8:
        m["cluster/stragglers"] = rng.sample(PEERS[:2], rng.randint(0, 2))
    return m


@pytest.mark.parametrize("patience", [1, 2, 3])
@pytest.mark.parametrize("seed", range(2))
def test_straggler_policies_act_alike(seed, patience):
    def make(pkg, sess):
        return pkg.StragglerPolicy(patience=patience)

    mine = _drive(policy, seed, 40, make, _straggler_metrics, FakeSession())
    theirs = _drive(rpolicy, seed, 40, make, _straggler_metrics, FakeSession())
    assert mine == theirs


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class _Count(policy.BasePolicy):
    def __init__(self):
        self.seen = []

    def after_step(self, ctx):
        self.seen.append(dict(ctx.metrics))


def test_the_runner_publishes_steps_feeds_the_ledger_and_refreshes_signals(monkeypatch):
    from kungfu_tpu_torch import api

    monkeypatch.setattr(api, "detached", lambda: False)  # no default peer here
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    config.refresh(None)
    decisions.reset_ledger()
    monkeypatch.setattr(policy.PolicyRunner, "CLUSTER_SIGNAL_PERIOD", 0.0)
    table = link.get_table()
    table.observe_send("127.0.0.1:1", 1 << 20, 0.01)
    table.observe_send("127.0.0.1:2", 1 << 20, 0.1)
    probe = _Count()
    with policy.PolicyRunner([probe], batch_size=8, total_samples=24) as runner:
        with runner.step():
            pass
        assert runner.ctx.metrics["links/slowest_edge"] == [None, "127.0.0.1:2"]
        assert runner.ctx.metrics["links/min_bw"] == pytest.approx(10 * (1 << 20))
        # a source that goes quiet takes its stale signals with it
        table.prune([])
        with runner.step():
            pass
        assert "links/min_bw" not in runner.ctx.metrics
        with runner.step():
            pass
    assert runner.ctx.stopped and runner.ctx.trained_samples == 24
    assert len(decisions.get_ledger()._recent) == 3
    text = metrics.render()
    assert "kungfu_steps_total 3" in text and "kungfu_step_duration_seconds_count 3" in text
    decisions.reset_ledger()


def test_one_failing_plane_never_drops_the_others(monkeypatch):
    monkeypatch.setenv("KF_TELEMETRY", "metrics")
    config.refresh(None)
    monkeypatch.setattr(policy.PolicyRunner, "CLUSTER_SIGNAL_PERIOD", 0.0)
    link.get_table().observe_send("127.0.0.1:7", 1 << 20, 0.5)

    def boom():
        raise RuntimeError("ledger down")

    monkeypatch.setattr(decisions, "get_ledger", boom)
    runner = policy.PolicyRunner([], batch_size=1)
    runner.ctx.metrics["decision/last_kind"] = "stale"
    runner._pull_cluster_signals()
    assert runner.ctx.metrics["links/slowest_edge"] == [None, "127.0.0.1:7"]
    assert "decision/last_kind" not in runner.ctx.metrics
    assert set(policy.PolicyRunner.SIGNAL_KEYS) >= {"links/min_bw", "decision/regressed",
                                                    "step/critical_edge", "memory/pressure"}
