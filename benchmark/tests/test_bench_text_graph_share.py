"""The reader of ``text_graph_share.search``: known values on made-up
``clip.encode_text`` spans with mixed ``graph`` attributes, nothing from
a program whose spans carry no ``graph`` or that records no spans, and
0 in a tiny traced run on the CPU, where the tower runs eagerly."""

import pytest

from benchmark import harness, program_spans, stats
from benchmark.devtrace import busy_s
from benchmark.spec import Bench

NAME = "text_graph_share.search"
CELL = "clip.library.bf16_4m"
MS = 1_000_000                      # ns
EVENTS = [(5, 6), (15, 16), (25, 26), (35, 36)]


def _search(i, t, **attrs):
    """A search at ``t`` ms whose text tower ran inside it."""
    return [(i, 0, i, 7, "library.search", t * MS, (t + 10) * MS, {}),
            (i + 1, i, i, 7, "clip.encode_text", (t + 1) * MS,
             (t + 2) * MS, attrs)]


def _ctx(spans, requests, monkeypatch):
    monkeypatch.setattr(program_spans, "_recorded",
                        lambda lo, hi: [s for s in spans
                                        if s[5] >= lo and s[6] <= hi])
    events = [("k", harness.EPOCH_NS + a * MS, harness.EPOCH_NS + b * MS)
              for a, b in EVENTS]
    recs = [stats.Record(i, i, 0.0, 0.1, True, 1) for i in range(requests)]
    return harness.Context(Bench().cell(CELL), harness.Window(0.0, 0.1, recs),
                           events, busy_s(events), 0.1)


def _read(ctx):
    return Bench().reader(NAME).read(ctx)


@pytest.mark.parametrize("graphs,share", [
    ((1, 2, 4, 8), 100.0),
    ((0, 0), 0.0),
    # a span without ``graph`` (a program that does not say) is not counted
    ((1, 0, 4, None), 200 / 3)])
def test_known_shares(monkeypatch, graphs, share):
    spans = []
    for n, g in enumerate(graphs):
        spans += _search(2 * n + 1, 10 * n,
                         **({} if g is None else {"graph": g}))
    assert _read(_ctx(spans, len(graphs), monkeypatch)) == pytest.approx(share)


def test_nothing_without_the_graph_attribute(monkeypatch):
    """A program whose encode spans carry no ``graph`` (the parent of
    this metric) reads nothing."""
    spans = _search(1, 0) + _search(3, 10)
    assert _read(_ctx(spans, 2, monkeypatch)) is None


def test_nothing_without_the_programs_spans(monkeypatch):
    ctx = _ctx([], 2, monkeypatch)
    assert _read(ctx) is None
    # a program with no recorder at all
    from avede_tpu_torch.utils import trace

    monkeypatch.undo()
    monkeypatch.delattr(trace, "spans_between")
    assert program_spans.window_spans(ctx) == []
    assert _read(ctx) is None


def test_a_tiny_traced_run_reads_0_on_the_cpu(tiny):
    r = harness.run_cell(tiny, CELL, 2 ** 31 + 4243, 0.3, True, "cpu", 0.0)
    assert r["correct"], r["checks"]
    assert r["metrics"][NAME]["value"] == 0.0
