"""``ClipEngine.embed_texts``'s text tower: on a card, up to 8 LRU
misses replay one captured CUDA graph of the tower at a padded bucket
(tests marked ``gpu``, which skip without CUDA); more misses, and the
CPU, run it eagerly. The padding rows never reach a real row.

This file imports no JAX: ``python -m pytest tests/test_torch_text_graph.py
--noconftest -q``.
"""

import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from avede_tpu_torch.models.clip import (init_clip, tiny_test_config,
                                         vit_b32)
from avede_tpu_torch.models.tokenizer import Tokenizer
from avede_tpu_torch.parallel.embed import TEXT_GRAPH_BUCKETS, ClipEngine
from avede_tpu_torch.utils import trace
from avede_tpu_torch.utils.config import settings
from avede_tpu_torch.utils.platform import with_compute_dtype

TEXTS = [f"clip {i} of a dog running on a beach at dusk" for i in range(9)]


@pytest.fixture
def ring(monkeypatch):
    """A fresh span ring in the recorder's place → it."""
    r = trace.SpanRing()
    monkeypatch.setattr(trace, "RING", r)
    return r


def _encode_spans():
    return [s for s in trace.spans_between(0, time.perf_counter_ns())
            if s[4] == "clip.encode_text"]


@torch.inference_mode()
def _eager(engine, texts, rows=None):
    """The engine's tower run eagerly on ``texts``' ids, padded with
    all-zero rows to ``rows`` → the real rows, f32 numpy."""
    ids = engine.tokenizer(texts)
    padded = np.zeros((rows or len(texts), ids.shape[1]), ids.dtype)
    padded[: len(ids)] = ids
    out = engine.model.encode_text(torch.from_numpy(padded).to(engine.device))
    return out[: len(texts)].float().cpu().numpy()


# -- the CPU (tier 1) ------------------------------------------------------
@pytest.fixture(scope="module")
def cpu_engine():
    return ClipEngine(cfg=tiny_test_config(), device="cpu", seed=0)


@pytest.mark.parametrize("n,bucket", [(1, 1), (2, 2), (3, 4), (4, 4),
                                      (5, 8), (8, 8), (9, 0), (64, 0)])
def test_a_cards_bucket_by_the_number_of_misses(n, bucket):
    card = SimpleNamespace(device=torch.device("cuda", 0))
    assert ClipEngine._text_bucket(card, n) == bucket
    assert bucket == 0 or bucket in TEXT_GRAPH_BUCKETS


@pytest.mark.parametrize("n", [1, 8])
def test_the_cpu_has_no_bucket(n):
    assert ClipEngine._text_bucket(
        SimpleNamespace(device=torch.device("cpu")), n) == 0


def test_a_cpu_engine_never_captures(cpu_engine, ring, monkeypatch):
    monkeypatch.setattr(settings, "TEXT_EMBED_CACHE", 0)
    before = (cpu_engine.text_graph_replays, cpu_engine.text_eager_runs)
    texts = TEXTS[:3]
    with profile(activities=[ProfilerActivity.CPU]):
        got = cpu_engine.embed_texts(texts)
    np.testing.assert_array_equal(got, _eager(cpu_engine, texts))
    assert cpu_engine._text_graphs is None
    assert (cpu_engine.text_graph_replays, cpu_engine.text_eager_runs) \
        == (before[0], before[1] + 1)
    (s,) = _encode_spans()
    assert s[7] == {"graph": 0}


@pytest.mark.parametrize("rows", [4, 8])
def test_padding_rows_do_not_change_a_real_row(rows):
    """The tiny f32 tower on three texts padded with all-zero id rows
    gives the unpadded batch's rows."""
    model = init_clip(tiny_test_config(), seed=1).eval()
    tok = Tokenizer(vocab_size=tiny_test_config().vocab_size,
                    context_len=tiny_test_config().max_text_len)
    ids = torch.from_numpy(tok(TEXTS[:3]))
    padded = torch.zeros((rows, ids.shape[1]), dtype=ids.dtype)
    padded[:3] = ids
    with torch.inference_mode():
        ref = model.encode_text(ids)
        got = model.encode_text(padded)[:3]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def _stress(engine, monkeypatch, counter, threads=12, calls=20):
    """``threads`` threads (more than an 8-core host has cores) each
    embed a text of their own ``calls`` times at once, the interpreter
    switching threads often: each always reads back its own row, and
    ``counter`` counts every call."""
    monkeypatch.setattr(settings, "TEXT_EMBED_CACHE", 0)
    texts = [f"thread {i}: {TEXTS[i % len(TEXTS)]}" for i in range(threads)]
    want = [engine.embed_texts([t]) for t in texts]
    before = getattr(engine, counter)
    start = threading.Barrier(threads)
    wrong = []

    def client(i):
        start.wait()
        for _ in range(calls):
            if not np.array_equal(engine.embed_texts([texts[i]]), want[i]):
                wrong.append(i)

    workers = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert wrong == []
    assert getattr(engine, counter) == before + threads * calls


def test_threads_get_their_own_embeddings_on_the_cpu(cpu_engine,
                                                     monkeypatch):
    _stress(cpu_engine, monkeypatch, "text_eager_runs")


# -- the card (marked gpu) ------------------------------------------------
@pytest.fixture(scope="module")
def engines():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device("cuda")
    return {name: ClipEngine(cfg=with_compute_dtype(cfg(), cuda),
                             device=cuda, seed=0)
            for name, cfg in (("tiny", tiny_test_config),
                              ("vit_b32", vit_b32))}


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny", "vit_b32"])
@pytest.mark.parametrize("q", [1, 3, 8])
def test_graph_equals_the_eager_tower_at_its_bucket(engines, name, q,
                                                    monkeypatch):
    engine = engines[name]
    assert engine.cfg.torch_dtype == torch.bfloat16
    monkeypatch.setattr(settings, "TEXT_EMBED_CACHE", 0)
    texts = [f"{name} {q} {t}" for t in TEXTS[:q]]
    before = (engine.text_graph_replays, engine.text_eager_runs)
    got = engine.embed_texts(texts)
    assert (engine.text_graph_replays, engine.text_eager_runs) \
        == (before[0] + 1, before[1])
    bucket = ClipEngine._text_bucket(engine, q)
    np.testing.assert_array_equal(got, _eager(engine, texts, bucket))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny", "vit_b32"])
def test_nine_misses_run_eagerly(engines, name, monkeypatch):
    engine = engines[name]
    monkeypatch.setattr(settings, "TEXT_EMBED_CACHE", 0)
    before = (engine.text_graph_replays, engine.text_eager_runs)
    got = engine.embed_texts(TEXTS)
    assert (engine.text_graph_replays, engine.text_eager_runs) \
        == (before[0], before[1] + 1)
    np.testing.assert_array_equal(got, _eager(engine, TEXTS))


@pytest.mark.gpu
def test_threads_get_their_own_embeddings_on_the_card(engines, monkeypatch):
    """Twelve threads replay the same bucket's graph over and over with
    texts of their own."""
    _stress(engines["vit_b32"], monkeypatch, "text_graph_replays")


@pytest.mark.gpu
def test_the_encode_span_names_its_bucket(engines, ring, monkeypatch):
    engine = engines["tiny"]
    monkeypatch.setattr(settings, "TEXT_EMBED_CACHE", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        engine.embed_texts(TEXTS[:1])
        engine.embed_texts(TEXTS[:3])
        engine.embed_texts(TEXTS)
    assert [s[7]["graph"] for s in sorted(_encode_spans(),
                                          key=lambda s: s[5])] == [1, 4, 0]
