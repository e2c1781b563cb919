"""The port's span recorder (``avede_tpu_torch/utils/trace.py``): off
without a profiler, on under one, parent and root per thread, a bounded
ring, the profiler's clock; and the spans inside the library search and
the BLIP-2 rerank, which never reach the metrics monitor."""

import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from avede_tpu_torch.utils import trace
from avede_tpu_torch.utils.metrics import get_monitor

NEW_SPANS = {"library.search", "library.prewarm", "clip.encode_text",
             "index.search", "blip2.frame_repr", "blip2.upload",
             "blip2.vision", "blip2.scores_from_repr"}


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring in the recorder's place → it."""
    r = trace.SpanRing()
    monkeypatch.setattr(trace, "RING", r)
    return r


def _recording():
    """A CPU-activity profile, started on this thread."""
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[4], []).append(s)
    return out


def _children(spans, parent):
    return [s for s in spans if s[1] == parent[0]]


def test_off_records_nothing_and_opens_no_range(ring, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(trace, "record_function", refuse)
    before = get_monitor().summary()["operations"].get(
        "trace.test_off", {}).get("count_total", 0)
    with trace.span("a", k=1):
        with trace.span("b"):
            pass
    with trace.trace("trace.test_off"):
        pass
    assert len(ring) == 0 and ring.dropped == 0
    assert trace.span("a") is trace.span("b")       # one shared sink
    after = get_monitor().summary()["operations"]["trace.test_off"]
    assert after["count_total"] == before + 1       # the monitor still


def test_worker_threads_record_their_own_trees(ring):
    both_open = threading.Barrier(2, timeout=30)
    idents = {}

    def work(tag):
        idents[tag] = threading.get_ident()
        with trace.span("outer", tag=tag):
            both_open.wait()            # the other thread's outer is open
            with trace.span("inner"):
                pass

    with _recording():
        threads = [threading.Thread(target=work, args=(t,))
                   for t in ("x", "y")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = trace.spans_between(0, time.perf_counter_ns())
    assert len(spans) == 4
    named = _by_name(spans)
    roots = {s[7]["tag"]: s for s in named["outer"]}
    assert set(roots) == {"x", "y"}
    for tag, root in roots.items():
        sid, parent, rid, thread = root[:4]
        assert parent == 0 and rid == sid and thread == idents[tag]
        (inner,) = _children(spans, root)
        assert inner[4] == "inner" and inner[2] == sid
        assert inner[3] == idents[tag]
        assert root[5] <= inner[5] <= inner[6] <= root[6]
    assert roots["x"][0] != roots["y"][0]


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    small = trace.SpanRing(4)
    for i in range(10):
        small.add((i + 1, 0, i + 1, 0, "s", 10 * i, 10 * i + 5, {}))
    assert len(small) == 4 and small.dropped == 6
    assert [s[0] for s in small.between(0, 1000)] == [7, 8, 9, 10]
    assert [s[0] for s in small.between(70, 84)] == [8]
    monkeypatch.setattr(trace, "RING", trace.SpanRing(2))
    with _recording():
        for _ in range(5):
            with trace.span("s"):
                pass
    assert len(trace.RING) == 2 and trace.RING.dropped == 3


def test_a_span_starts_on_the_profilers_clock(ring):
    # benchmark/harness.py's map from perf_counter onto the profiler's
    # clock
    epoch_ns = time.time_ns() - time.perf_counter_ns()
    with _recording():
        with trace.span("clock.warm"):  # the first range pays its set-up
            pass
    with _recording() as prof:
        with trace.span("clock.probe"):
            time.sleep(0.002)
    (s,) = _by_name(trace.spans_between(0, time.perf_counter_ns())
                    )["clock.probe"]
    (e,) = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "clock.probe"]
    assert abs(e.start_ns() - (epoch_ns + s[5])) < 1_000_000


def test_profile_to_empties_the_ring(ring, tmp_path):
    ring.add((1, 0, 1, 0, "left.over", 0, 1, {}))
    seen = []
    with trace.profile_to(str(tmp_path / "prof")):
        seen.append(len(ring))
        with trace.span("in.profile"):
            pass
        seen.append(len(ring))
    assert seen == [0, 1] and len(ring) == 0
    assert any((tmp_path / "prof").iterdir())


# -- the library search ------------------------------------------------
@pytest.fixture(scope="module")
def engine():
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine

    return ClipEngine(cfg=tiny_test_config(), device="cpu")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _library(engine, tmp_path, monkeypatch, rows):
    from avede_tpu_torch.services.library_search import LibrarySearch
    from avede_tpu_torch.utils.config import settings

    monkeypatch.setattr(settings, "VIDEO_DIR", str(tmp_path))
    monkeypatch.setattr(settings, "LIBRARY_INDEX_ENABLED", True)
    for vid in rows:
        (tmp_path / f"{vid}.mp4").touch()
    phase1 = SimpleNamespace(engine=engine, frame_embeddings=lambda p, v: (
        rows[v], np.arange(len(rows[v]), dtype=np.float32).tolist()))
    return LibrarySearch(phase1)


def _two_videos(seed=0, n=40, dim=32):
    rng = np.random.default_rng(seed)
    return {v: _unit(rng.normal(size=(n, dim))) for v in ("v0", "v1")}


def test_a_search_is_one_tree(engine, ring, tmp_path, monkeypatch):
    search = _library(engine, tmp_path, monkeypatch, _two_videos())
    with _recording():
        out = search.search("a trace of two videos", top_k=4,
                            threshold=-1.0, per_video_k=3)
    assert len(out["results"]) == 4
    spans = trace.spans_between(0, time.perf_counter_ns())
    (root,) = _by_name(spans)["library.search"]
    assert root[1] == 0 and root[2] == root[0]
    kids = _children(spans, root)
    assert {s[4] for s in kids} == {"library.prewarm", "clip.encode_text",
                                    "index.search"}
    assert all(s[2] == root[0] for s in spans)
    assert sum(s[4] == "index.search" for s in kids) == 1


def test_a_repeated_query_encodes_nothing(engine, ring, tmp_path,
                                          monkeypatch):
    search = _library(engine, tmp_path, monkeypatch, _two_videos(1))
    with _recording():
        for _ in range(2):
            search.search("the same words twice", top_k=4, threshold=-1.0,
                          per_video_k=3)
    spans = trace.spans_between(0, time.perf_counter_ns())
    first, second = sorted(_by_name(spans)["library.search"],
                           key=lambda s: s[5])
    assert "clip.encode_text" in {s[4] for s in _children(spans, first)}
    assert "clip.encode_text" not in {s[4] for s in
                                      _children(spans, second)}


def test_a_starved_cap_records_each_round(engine, ring, tmp_path,
                                         monkeypatch):
    query = "one video owns every top score"
    q = engine.embed_texts(query)[0]
    rng = np.random.default_rng(2)
    rows = {"hot": _unit(q + 0.01 * rng.normal(size=(300, q.size))),
            "cold": _unit(rng.normal(size=(300, q.size)))}
    search = _library(engine, tmp_path, monkeypatch, rows)
    with _recording():
        out = search.search(query, top_k=6, threshold=-1.0, per_video_k=3)
    assert sorted(r["video_id"] for r in out["results"]) == \
        ["cold"] * 3 + ["hot"] * 3
    spans = trace.spans_between(0, time.perf_counter_ns())
    (root,) = _by_name(spans)["library.search"]
    rounds = [s for s in _children(spans, root) if s[4] == "index.search"]
    # K' = 64 and 256 hold only the hot video's rows; 1024 reaches cold
    assert len(rounds) == 3
    assert all(s[2] == root[0] for s in rounds)


# -- the BLIP-2 rerank -------------------------------------------------
@pytest.fixture(scope="module")
def reranker():
    from avede_tpu_torch.models.qformer import tiny_qformer_config
    from avede_tpu_torch.models.tokenizer import HashTokenizer
    from avede_tpu_torch.services.captioner import Blip2RerankService

    # 128 rows hold [CLS] = 101 and [SEP] = 102
    cfg = dataclasses.replace(tiny_qformer_config(), vocab_size=128)
    return Blip2RerankService(cfg=cfg, tokenizer=HashTokenizer(100),
                              device="cpu")


def _frames(n=3):
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, size=(n, 48, 64, 3), dtype=np.uint8)


def test_a_rerank_is_two_roots(reranker, ring):
    with _recording():
        reprs = reranker.frame_repr(_frames())
        scores, _ = reranker.scores_from_repr(reprs, "a red car")
    assert scores.shape == (3,)
    spans = trace.spans_between(0, time.perf_counter_ns())
    named = _by_name(spans)
    (image,) = named["blip2.frame_repr"]
    (text,) = named["blip2.scores_from_repr"]
    assert image[1] == 0 and text[1] == 0 and image[0] != text[0]
    kids = _children(spans, image)
    assert [s[4] for s in sorted(kids, key=lambda s: s[5])] == \
        ["blip2.upload", "blip2.vision"]
    assert all(s[2] == image[0] for s in kids)
    assert _children(spans, text) == []


def test_new_spans_stay_out_of_the_monitor(engine, reranker, ring,
                                           tmp_path, monkeypatch):
    search = _library(engine, tmp_path, monkeypatch, _two_videos(4))
    with _recording():
        search.search("kept out of the monitor", top_k=2, threshold=-1.0,
                      per_video_k=1)
        reranker.rerank_scores(_frames(2), "a red car")
    recorded = {s[4] for s in trace.spans_between(0, time.perf_counter_ns())}
    assert recorded == NEW_SPANS
    assert not NEW_SPANS & set(get_monitor().summary()["operations"])
