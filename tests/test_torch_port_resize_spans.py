"""The resize spans of a port `Peer` against the reference's, in process.

A world grows k -> k+1 -> k through the config server under ElasticState
(the worlds, the fake runner and the worker of
tests/test_torch_port_resize.py). Every peer that leaves an epoch closes
its old session inside `resize.drain_scheduler`, once per resize it takes
part in, nested in `resize.update`, as the reference's `Peer._update_to`
does; and each peer's sequence of `resize.*` spans, by name and depth, is
the one an all-reference world records at the same place in the same
resize plan.
"""

import threading

import pytest

from kungfu_tpu.telemetry import tracing as rtracing
from kungfu_tpu_torch.telemetry import tracing

from test_torch_port_resize import LAYOUTS, World, elastic_worker, tls  # noqa: F401 - tls: fixture
from test_torch_port_worlds import small_arenas  # noqa: F401 - autouse: small shm rings

MAX_PROGRESS = 8


def _resize_spans():
    """thread ident -> [(name, depth)] of every resize.* span, both rings."""
    out = {}
    for trc in (tracing, rtracing):
        for ev in sorted(trc.full_events("resize."), key=lambda e: e.start):
            out.setdefault(ev.tid, []).append((ev.name, ev.depth))
    return out


def run_world(tls, kinds, joiners, where, shed):
    """The world of test_grow_then_shrink_keeps_every_peer_on_the_roots_state;
    returns spec index -> that peer's resize.* spans, and its results."""
    k = len(kinds)
    world = World(tls, kinds, joiners, None)
    first = list(range(k))
    grown = [k] + first if where == "first" else first + [k]
    shrunk = [i for i in grown if i != shed]
    inner = elastic_worker(world, {2: grown, 5: shrunk}, MAX_PROGRESS)

    def worker(kind, peer):
        res = inner(kind, peer)
        res["tid"] = threading.get_ident()
        return res

    world.worker = worker
    for trc in (tracing, rtracing):
        trc.clear()
    results = world.run()
    spans = _resize_spans()
    return ({world.specs.index(spec): spans.get(res["tid"], [])
             for spec, res in results.items()}, results)


_REFERENCE = {}


def reference_spans(tls, layout):
    """The same plan in an all-reference world (one run per plan shape)."""
    kinds, joiners, where, shed = LAYOUTS[layout]
    key = (len(kinds), where, shed)
    if key not in _REFERENCE:
        _REFERENCE[key] = run_world(tls, ["ref"] * len(kinds), ["ref"], where, shed)[0]
    return _REFERENCE[key]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_resize_drains_the_old_session_inside_its_span(layout, tls):
    kinds, joiners, where, shed = LAYOUTS[layout]
    k = len(kinds)
    spans, _ = run_world(tls, kinds, joiners, where, shed)
    assert sorted(spans) == list(range(k + 1))
    for i, seq in spans.items():
        drains = [d for name, d in seq if name == "resize.drain_scheduler"]
        # the first peers take part in both resizes, the joiner only in
        # the shrink (it had no session to drain at the grow)
        assert len(drains) == (1 if i == k else 2), (layout, i, seq)
        # each drain nests in the resize.update span that swaps sessions
        for j, (name, depth) in enumerate(seq):
            if name == "resize.drain_scheduler":
                assert seq[j - 1] == ("resize.update", depth - 1), (layout, i, seq)
    assert spans == reference_spans(tls, layout)
