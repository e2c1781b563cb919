"""The readers of the program's own spans (``program_spans.py``): known
values on a made-up traced window, nothing from a program without
spans, and every one of a cell's readers non-null in a tiny traced run
on the CPU."""

import pytest

from benchmark import harness, program_spans, stats
from benchmark.devtrace import busy_s
from benchmark.spec import Bench

SEARCH = ["prewarm_ms.search", "text_encode_ms.search", "index_ms.search",
          "index_rounds_per_search", "idle_outside_spans.search"]
RERANK = ["upload_ms.rerank", "vision_launch_ms.rerank",
          "idle_outside_spans.rerank"]
MS = 1_000_000                      # ns


def _span(i, parent, root, thread, name, a, b, **attrs):
    """A span as the program records it, times in ms."""
    return (i, parent, root, thread, name, a * MS, b * MS, attrs)


# one search, two rounds of the index; device events cut the idle time
SEARCH_SPANS = [
    _span(1, 0, 1, 7, "library.search", 0, 80),
    _span(2, 1, 1, 7, "library.prewarm", 0, 10),
    _span(3, 1, 1, 7, "clip.encode_text", 10, 30),
    _span(4, 1, 1, 7, "index.search", 30, 40),
    _span(5, 1, 1, 7, "index.search", 40, 50)]
SEARCH_EVENTS = [(5, 6), (20, 21), (35, 36), (45, 46), (60, 61)]
# idle by the spans open at each gap's middle, ms: [0, 5] prewarm,
# [6, 20] and [21, 35] encode, [36, 45] index, [46, 60] the search's own
# time, [61, 100] none
SEARCH_IDLE = {"library.prewarm": 5, "clip.encode_text": 28,
               "index.search": 9, "library.search": 14, "no span open": 39}

# two clients' requests on two threads
RERANK_SPANS = [
    _span(1, 0, 1, 7, "blip2.frame_repr", 0, 60),
    _span(2, 1, 1, 7, "blip2.upload", 0, 20),
    _span(3, 1, 1, 7, "blip2.vision", 20, 30),
    _span(4, 0, 4, 7, "blip2.scores_from_repr", 60, 70),
    _span(5, 0, 5, 8, "blip2.frame_repr", 10, 80),
    _span(6, 5, 5, 8, "blip2.upload", 10, 40),
    _span(7, 5, 5, 8, "blip2.vision", 40, 50),
    _span(8, 0, 8, 8, "blip2.scores_from_repr", 80, 90)]
RERANK_EVENTS = [(25, 26), (45, 46), (85, 86)]
# [0, 25] both uploading; [26, 45] one in frame_repr's own time, one
# uploading; [46, 85] one scoring, one in frame_repr's own time;
# [86, 100] none
RERANK_IDLE = {"blip2.upload": 25, "blip2.frame_repr+blip2.upload": 19,
               "blip2.frame_repr+blip2.scores_from_repr": 39,
               "no span open": 14}


def _ctx(cell, spans, events, requests, monkeypatch):
    monkeypatch.setattr(program_spans, "_recorded",
                        lambda lo, hi: [s for s in spans
                                        if s[5] >= lo and s[6] <= hi])
    events = [("k", harness.EPOCH_NS + a * MS, harness.EPOCH_NS + b * MS)
              for a, b in events]
    recs = [stats.Record(i, i, 0.0, 0.1, True, 1) for i in range(requests)]
    return harness.Context(Bench().cell(cell), harness.Window(0.0, 0.1, recs),
                           events, busy_s(events), 0.1)


def _read(names, ctx):
    bench = Bench()
    return {m: bench.reader(m).read(ctx) for m in names}


def _table(err):
    """The idle seconds by span that a reader wrote, as ms."""
    out = {}
    for line in err.splitlines()[1:]:
        if not line.startswith("  "):
            break
        label, value = line.strip().rsplit(None, 1)
        out[label] = float(value) * 1e3
    return out


def test_search_readers(monkeypatch, capsys):
    ctx = _ctx("clip.library.bf16_4m", SEARCH_SPANS, SEARCH_EVENTS, 1,
               monkeypatch)
    got = _read(SEARCH, ctx)
    assert got["prewarm_ms.search"] == pytest.approx(10.0)
    assert got["text_encode_ms.search"] == pytest.approx(20.0)
    assert got["index_ms.search"] == pytest.approx(20.0)
    assert got["index_rounds_per_search"] == pytest.approx(2.0)
    assert got["idle_outside_spans.search"] == pytest.approx(100 * 39 / 95)
    assert _table(capsys.readouterr().err) == pytest.approx(SEARCH_IDLE)


def test_rerank_readers(monkeypatch, capsys):
    ctx = _ctx("blip2.rerank.cold30", RERANK_SPANS, RERANK_EVENTS, 2,
               monkeypatch)
    got = _read(RERANK, ctx)
    assert got["upload_ms.rerank"] == pytest.approx((20 + 30) / 2)
    assert got["vision_launch_ms.rerank"] == pytest.approx((10 + 10) / 2)
    assert got["idle_outside_spans.rerank"] == pytest.approx(100 * 14 / 97)
    assert _table(capsys.readouterr().err) == pytest.approx(RERANK_IDLE)


def test_a_child_cuts_its_parent():
    """Each span's own pieces: the search keeps what its children leave."""
    spans = [program_spans.Span(*s) for s in SEARCH_SPANS]
    assert program_spans.innermost(spans) == [
        ("library.search", 50 * MS, 80 * MS), ("library.prewarm", 0, 10 * MS),
        ("clip.encode_text", 10 * MS, 30 * MS),
        ("index.search", 30 * MS, 40 * MS),
        ("index.search", 40 * MS, 50 * MS)]


def test_text_encode_counts_hits_as_nothing(monkeypatch):
    """A search whose query hit the text LRU has no encode span: the
    mean counts it as 0."""
    ctx = _ctx("clip.library.bf16_4m", SEARCH_SPANS, SEARCH_EVENTS, 2,
               monkeypatch)
    assert _read(["text_encode_ms.search"], ctx) == {
        "text_encode_ms.search": pytest.approx(10.0)}


@pytest.mark.parametrize("cell,names", [("clip.library.bf16_4m", SEARCH),
                                        ("blip2.rerank.cold30", RERANK)])
def test_nothing_without_the_programs_spans(monkeypatch, cell, names):
    ctx = _ctx(cell, [], SEARCH_EVENTS, 2, monkeypatch)
    assert _read(names, ctx) == {m: None for m in names}
    # a program with no recorder at all (the parent of this change)
    from avede_tpu_torch.utils import trace

    monkeypatch.undo()
    monkeypatch.delattr(trace, "spans_between")
    assert program_spans.window_spans(ctx) == []
    assert _read(names, ctx) == {m: None for m in names}


@pytest.mark.parametrize("cell,names", [("clip.library.bf16_4m", SEARCH),
                                        ("blip2.rerank.cold30", RERANK)])
def test_a_tiny_traced_run_reports_them(tiny, cell, names):
    r = harness.run_cell(tiny, cell, 2 ** 31 + 4242, 0.3, True, "cpu", 0.0)
    assert r["correct"], r["checks"]
    for m in names:
        assert r["metrics"][m]["value"] is not None, m
