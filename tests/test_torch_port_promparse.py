"""The port's exposition parser and federation merge
(`kungfu_tpu_torch/telemetry/promparse.py`) against the JAX package's:
each package's parser reads the other's registry text to the same
samples, tricky sample lines parse alike, and `merge_expositions`,
`inject_label`, `render_sample` and `sample_value` agree."""

import math
import random

import pytest

from kungfu_tpu.telemetry import metrics as rmetrics
from kungfu_tpu.telemetry import promparse as rpromparse
from kungfu_tpu_torch.telemetry import metrics, promparse
from test_torch_port_telemetry import LABEL_VALUES, _drive, clean_telemetry  # noqa: F401


def _same(a, b) -> bool:
    """Sample lists equal, NaN equal to NaN."""
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (x.name, x.labels) != (y.name, y.labels):
            return False
        if not (x.value == y.value or (math.isnan(x.value) and math.isnan(y.value))):
            return False
    return True


@pytest.mark.parametrize("seed", range(15))
def test_each_parser_reads_the_others_text_alike(seed):
    mine, theirs = _drive(metrics, seed), _drive(rmetrics, seed)
    assert mine == theirs
    a, b = promparse.parse_text(theirs), rpromparse.parse_text(mine)
    assert a and _same(a, b)
    # a parsed page re-renders to its own sample lines
    lines = [l for l in mine.splitlines() if l and not l.startswith("#")]
    assert [promparse.render_sample(s) for s in a] == lines


LINES = [
    'plain 1', 'plain 1 1700000000000', 'with_labels{a="1",b="two"} 2.5',
    'esc{v="a\\"b\\\\c\\nd"} -3', 'inf{x="y"} +Inf', 'ninf -Inf', 'nan NaN', 'lower inf',
    '# HELP x y', '# TYPE x counter', '', '   ', 'garbage', 'novalue{a="b"}',
    'bad{a="b"} notanumber', 'spaced{a="b", c="d"} 4', 'unquoted{a=b} 1',
    'brace_in_value{a="}"} 5', 'trailing_comma{a="b",} 6']


@pytest.mark.parametrize("line", LINES)
def test_sample_lines_parse_alike(line):
    def parse(mod):
        try:
            return ("ok", mod.parse_line(line))
        except ValueError as e:
            return ("error", type(e).__name__)

    mine, theirs = parse(promparse), parse(rpromparse)
    assert mine[0] == theirs[0]
    if mine[0] == "ok" and mine[1] is not None:
        assert _same([mine[1]], [theirs[1]])
        assert promparse.render_sample(mine[1]) == rpromparse.render_sample(theirs[1])
    else:
        assert mine == theirs
    assert _same(promparse.parse_text(line), rpromparse.parse_text(line))


@pytest.mark.parametrize("seed", range(6))
def test_merged_expositions_agree(seed):
    rng = random.Random(seed)
    pages = []
    for i in range(rng.randint(1, 4)):
        text = _drive(metrics, seed * 10 + i)
        reg = metrics.Registry()
        reg.counter("kungfu_egress_bytes_total", "e", ("peer",)).labels(
            f"127.0.0.1:{i}").inc(i + 1)
        pages.append((rng.choice([None, f"127.0.0.1:{20000 + i}"]), text + reg.render()))
    mine, theirs = promparse.merge_expositions(pages), rpromparse.merge_expositions(pages)
    assert mine == theirs
    merged = promparse.parse_text(mine)
    labelled = [p for p, _ in pages if p is not None]
    if labelled:
        got = [s for s in merged if s.name == "kungfu_egress_bytes_total"
               and s.labels_dict().get("peer") == labelled[0]]
        assert got and all("exported_peer" in s.labels_dict() for s in got)


@pytest.mark.parametrize("value", LABEL_VALUES)
def test_inject_label_keeps_a_colliding_label_as_exported(value):
    s = promparse.Sample("x", (("peer", value), ("k", "v")), 1.0)
    rs = rpromparse.Sample("x", (("peer", value), ("k", "v")), 1.0)
    mine, theirs = promparse.inject_label(s, "peer", "w0"), rpromparse.inject_label(rs, "peer", "w0")
    assert tuple(mine) == tuple(theirs)
    assert mine.labels_dict() == {"peer": "w0", "exported_peer": value, "k": "v"}
    assert promparse.render_sample(mine) == rpromparse.render_sample(theirs)


def test_sample_value_matches_label_subsets():
    text = _drive(metrics, 3)
    mine, theirs = promparse.parse_text(text), rpromparse.parse_text(text)
    for s in mine[:30]:
        want = dict(s.labels)
        assert promparse.sample_value(mine, s.name, **want) == rpromparse.sample_value(
            theirs, s.name, **want)
    assert promparse.sample_value(mine, "absent") is None
    assert promparse.merge_expositions([]) == rpromparse.merge_expositions([]) == ""
