"""The port's whole-library search against the JAX package's: the
``DeviceLibraryIndex`` fed the same sequence of adds, replaces, removes
and growth in each tier, and ``LibrarySearch`` over the same mp4s on
the same tiny CLIP weights. On the CPU the index runs the plain
versions of its kernels (cosine entries, ``quantize_rows``).

Index confidences agree to 1e-5 in every tier: the table values and the
bf16-rounded query are bit-identical, and only the order of the f32 sum
differs. So does ``LibrarySearch`` when both packages search the same
tables (the JAX scan's). Through the whole path each package embeds
with its own engine and host pack; the packs are byte-equal, so the
tables agree to 1e-5 except where the two f32 embeddings straddle an
int8 rounding boundary of the embedding cache, where a component is off
by one int8 step of its row (``test_engine_tables_within_bar``).
Confidences there are held to ENGINE_TOL. Against the port's own host
path they agree to 1e-5 in the f32 tier and 2e-3 in the bf16 and int8
tiers.
"""

import os
import threading
from types import SimpleNamespace

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from avede_tpu.services import library_index as jli
from avede_tpu.utils.config import settings as jsettings
from avede_tpu_torch.ops import kernels as tk
from avede_tpu_torch.services import library_index as tli
from avede_tpu_torch.utils.config import settings as tsettings

DTYPES = ["float32", "bfloat16", "int8"]
CONF_TOL = 1e-5
# whole-path confidences: one int8 step of the cache (about 3e-3 at the
# tiny model's 32 dims) times the query's component; measured at most
# 1.61e-3 (one row with one such step), every other hit within 2e-7
ENGINE_TOL = 2e-3
TIER_TOL = {"float32": 1e-5, "bfloat16": 2e-3, "int8": 2e-3}


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _hits(hits):
    return [(h["video_id"], h["frame_index"], h["timestamp"]) for h in hits]


def _table_bits(arr):
    """Device table → comparable numpy bits (bf16 as uint16)."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype == torch.bfloat16:
            return arr.view(torch.int16).numpy().view(np.uint16)
        return arr.numpy()
    a = np.asarray(arr)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


class _Pair:
    """The JAX index and the port's, fed the same calls."""

    def __init__(self, dim, dtype):
        self.j = jli.DeviceLibraryIndex(dim, dtype=dtype)
        self.t = tli.DeviceLibraryIndex(dim, dtype=dtype, device="cpu")

    def add(self, vid, emb, ts):
        self.j.add(vid, emb, ts)
        self.t.add(vid, emb, ts)

    def remove(self, vid):
        self.j.remove(vid)
        self.t.remove(vid)

    def check(self, queries, k):
        assert (self.t.n_rows, self.t.capacity, self.t.n_videos) \
            == (self.j.n_rows, self.j.capacity, self.j.n_videos)
        for q in queries:
            a, b = self.t.search(q, k), self.j.search(q, k)
            assert _hits(a) == _hits(b)
            np.testing.assert_allclose([h["confidence"] for h in a],
                                       [h["confidence"] for h in b],
                                       atol=CONF_TOL, rtol=0)

    def check_tables(self):
        np.testing.assert_array_equal(_table_bits(self.t._table),
                                      _table_bits(self.j._table))
        np.testing.assert_array_equal(self.t._valid.numpy(),
                                      np.asarray(self.j._valid))
        if self.t.dtype == "int8":
            np.testing.assert_array_equal(self.t._scales.numpy(),
                                          np.asarray(self.j._scales))


class TestIndexMatchesJax:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_add_replace_remove_grow(self, dtype, monkeypatch):
        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, "LIBRARY_INDEX_DEDUP", True)
        rng = np.random.default_rng(7)
        d = 32
        pair = _Pair(d, dtype)
        queries = _unit(rng, 3, d)
        pair.add("v0", _unit(rng, 300, d), np.arange(300.0))
        uniq = _unit(rng, 5, d)
        runs = np.repeat(uniq, [4, 1, 6, 2, 3], axis=0)   # collapses to 5
        pair.add("v1", runs, np.arange(16.0) * 0.5)
        pair.add("v2", _unit(rng, 200, d), np.arange(200.0) / 3)
        pair.check(queries, 16)
        pair.check_tables()
        pair.add("v2", _unit(rng, 90, d), np.arange(90.0))   # replace
        pair.remove("v0")                                    # hole
        pair.check(queries, 16)
        pair.check_tables()
        # an oversize add grows the table and compacts the hole
        pair.add("big", _unit(rng, tli._MIN_CAPACITY, d),
                 np.arange(float(tli._MIN_CAPACITY)))
        assert pair.t.capacity > tli._MIN_CAPACITY
        pair.check(queries, 64)
        pair.check_tables()
        # replacing a video when the add also grows skips the hole write
        pair.add("v1", _unit(rng, 2 * tli._MIN_CAPACITY, d),
                 np.arange(2.0 * tli._MIN_CAPACITY))
        pair.check(queries, 8)
        pair.check_tables()

    def test_int8_writes_through_the_fused_entry(self, monkeypatch):
        """The int8 tier's adds and removes are one ``quantize_rows_into``
        each (the mask written with the block), growth quantizes through
        ``quantize_rows``, and table, scales and valid stay equal to the
        JAX index's after adds, a replace, a remove and two growths."""
        from avede_tpu_torch.ops import quant as tq

        calls = []

        def spy(name, fn):
            def run(*args, **kw):
                rows = args[0].shape[0]
                calls.append((name, rows) + ((args[4],) if len(args) > 4
                                             else ()))
                return fn(*args, **kw)
            return run

        monkeypatch.setattr(tq, "quantize_rows_into",
                            spy("into", tq.quantize_rows_into))
        monkeypatch.setattr(tq, "quantize_rows",
                            spy("rows", tq.quantize_rows))
        rng = np.random.default_rng(9)
        d = 48
        pair = _Pair(d, "int8")
        pair.add("a", _unit(rng, 300, d), np.arange(300.0))
        pair.add("b", _unit(rng, 70, d), np.arange(70.0))
        pair.add("a", _unit(rng, 20, d), np.arange(20.0))      # replace
        pair.remove("b")
        pair.check_tables()
        assert calls == [("into", 512, 300), ("into", 256, 70),
                         ("into", 512, 0), ("into", 256, 20),
                         ("into", 256, 0)]
        calls.clear()
        pair.add("c", _unit(rng, 1500, d), np.arange(1500.0))  # grows
        pair.add("d", _unit(rng, 2000, d), np.arange(2000.0))  # grows
        pair.check_tables()
        pair.check(_unit(rng, 2, d), 10)
        assert calls == [("rows", 256), ("into", 1536, 1500),
                         ("rows", 1792), ("into", 2048, 2000)]

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_zero_row_blocks_and_wide_rows(self, dtype):
        """A removal writes an all-zero block (scale 1e-12 in int8); a
        width that is no multiple of the kernels' vector width."""
        rng = np.random.default_rng(8)
        pair = _Pair(24, dtype)
        pair.add("a", _unit(rng, 10, 24), np.arange(10.0))
        pair.add("b", _unit(rng, 7, 24), np.arange(7.0))
        pair.remove("a")
        pair.check(_unit(rng, 2, 24), 9)
        pair.check_tables()


class TestFusedSearchMatchesJax:
    """Each tier's fused score + top-k entry (its plain composition on
    the CPU) against the JAX index's search program on the same table:
    row indices exactly equal, scores to CONF_TOL (the f32 sum's
    order), -inf rows (padding, a removed video) ranked last in row
    order."""

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("k", [1, 16, 1024])
    def test_entry_matches_jax_search(self, dtype, k):
        rng = np.random.default_rng(31)
        pair = _Pair(32, dtype)
        for i, n in enumerate((300, 40, 200)):
            pair.add(f"v{i}", _unit(rng, n, 32), np.arange(float(n)))
        pair.remove("v1")                                   # a hole
        pair.check_tables()
        q = _unit(rng, 1, 32)[0]
        j, t = pair.j, pair.t
        kk = min(k, j.capacity)
        if dtype == "int8":
            rv, ri = jli._search_fn(kk, True)(j._table, j._scales, j._valid,
                                              jax.numpy.asarray(q))
            gv, gi = tk.cosine_topk_int8(t._table, t._scales,
                                         torch.from_numpy(q), t._valid, k)
        else:
            rv, ri = jli._search_fn(kk)(j._table, j._valid,
                                        jax.numpy.asarray(q))
            if dtype == "bfloat16":
                gv, gi = tk.cosine_topk_bf16(t._table, torch.from_numpy(q),
                                             t._valid, k)
            else:
                gv, gi = tk.cosine_topk_f32(t._table, torch.from_numpy(q),
                                            t._valid, k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv),
                                   atol=CONF_TOL, rtol=0)
        assert np.isneginf(gv.numpy()).sum() == max(0, kk - t.n_rows)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_search_takes_the_fused_entry(self, dtype, monkeypatch):
        """``DeviceLibraryIndex.search`` calls its tier's fused entry
        (and not the contract entry) with the rounded-up k."""
        calls = []
        name = {"float32": "cosine_topk_f32", "bfloat16":
                "cosine_topk_bf16", "int8": "cosine_topk_int8"}[dtype]
        real = getattr(tk, name)

        def spy(*args):
            calls.append(args[-1])
            return real(*args)

        monkeypatch.setattr(tk, name, spy)
        for contract in ("cosine_scores", "cosine_scores_bf16",
                         "cosine_scores_int8"):
            monkeypatch.setattr(tk, contract, None)     # must not be called
        idx = tli.DeviceLibraryIndex(32, dtype=dtype, device="cpu")
        idx.add("v", _unit(np.random.default_rng(4), 50, 32),
                np.arange(50.0))
        assert len(idx.search(_unit(np.random.default_rng(5), 1, 32)[0],
                              10)) == 10
        assert calls == [16]


class TestDeviceLibraryIndex:
    """The cases of ``tests/test_library_index.py`` that apply to one
    device, on the port's index."""

    def _index(self, dim=32, dtype="float32"):
        return tli.DeviceLibraryIndex(dim, dtype=dtype, device="cpu")

    def test_search_matches_numpy(self):
        rng = np.random.default_rng(0)
        idx = self._index()
        tables = {}
        for i, n in enumerate((10, 25, 7)):
            emb = _unit(rng, n, 32)
            tables[f"v{i}"] = emb
            idx.add(f"v{i}", emb, np.arange(n, dtype=np.float32))
        q = _unit(rng, 1, 32)[0]
        all_emb = np.concatenate(list(tables.values()))
        expect = np.sort(all_emb @ q)[::-1][:5]
        got = idx.search(q, 5)
        np.testing.assert_allclose([r["confidence"] for r in got], expect,
                                   atol=1e-5)
        for r in got:
            emb = tables[r["video_id"]]
            np.testing.assert_allclose(float(emb[r["frame_index"]] @ q),
                                       r["confidence"], atol=1e-5)
            assert r["timestamp"] == float(r["frame_index"])

    def test_replace_and_remove(self):
        rng = np.random.default_rng(1)
        idx = self._index()
        idx.add("a", _unit(rng, 8, 32), np.arange(8.0))
        idx.add("b", _unit(rng, 6, 32), np.arange(6.0))
        assert idx.n_videos == 2 and idx.n_rows == 14
        idx.add("a", _unit(rng, 4, 32), np.arange(4.0))
        assert idx.n_videos == 2 and idx.n_rows == 10
        q = _unit(rng, 1, 32)[0]
        hits = idx.search(q, 10)
        assert {h["video_id"] for h in hits} == {"a", "b"}
        assert max(h["frame_index"] for h in hits
                   if h["video_id"] == "a") < 4
        idx.remove("b")
        hits = idx.search(q, 10)
        assert {h["video_id"] for h in hits} == {"a"} and len(hits) == 4

    def test_add_collapses_identical_runs(self, monkeypatch):
        monkeypatch.setattr(tsettings, "LIBRARY_INDEX_DEDUP", True)
        rng = np.random.default_rng(13)
        uniq = _unit(rng, 4, 32)
        emb = np.repeat(uniq, [4, 2, 4, 1], axis=0)     # AAAA BB CCCC D
        ts = np.arange(11.0)
        idx = self._index()
        idx.add("v", emb, ts)
        assert idx.n_rows == 4
        hits = idx.search(uniq[2], 2)
        assert hits[0]["timestamp"] == 6.0      # run C starts at frame 6
        assert hits[0]["frame_index"] == 6      # original frame index
        np.testing.assert_allclose(hits[0]["confidence"], 1.0, atol=1e-5)
        monkeypatch.setattr(tsettings, "LIBRARY_INDEX_DEDUP", False)
        idx2 = self._index()
        idx2.add("v", emb, ts)
        assert idx2.n_rows == 11

    @pytest.mark.parametrize("dtype,budget", [("bfloat16", 5e-3),
                                              ("int8", 6e-3)])
    def test_tier_drift_after_growth(self, dtype, budget):
        """Growth with compaction re-uploads (int8: re-quantizes) from
        the host shadow; scores stay within the tier's one-rounding
        budget of exact f32 scores afterwards, as in the JAX tests."""
        rng = np.random.default_rng(23)
        tier, f32 = self._index(64, dtype), self._index(64, "float32")
        for i, n in enumerate((200, 300)):
            emb = _unit(rng, n, 64)
            for idx in (tier, f32):
                idx.add(f"v{i}", emb, np.arange(float(n)))
        big = _unit(rng, tli._MIN_CAPACITY, 64)
        for idx in (tier, f32):
            idx.remove("v0")
            idx.add("big", big, np.arange(float(tli._MIN_CAPACITY)))
        assert tier.capacity == f32.capacity > tli._MIN_CAPACITY
        q = _unit(rng, 1, 64)[0]
        np.testing.assert_allclose(
            [r["confidence"] for r in tier.search(q, 16)],
            [r["confidence"] for r in f32.search(q, 16)], atol=budget)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_empty_and_zero_row_add(self, dtype):
        idx = self._index(dtype=dtype)
        assert idx.search(np.zeros(32, np.float32), 5) == []
        idx.add("empty", np.zeros((0, 32), np.float32), [])
        assert idx.n_videos == 0 and idx.capacity == 0

    @pytest.mark.parametrize("n_ts", [5, 11])
    def test_mismatched_timestamps_raise(self, n_ts):
        idx = self._index()
        emb = _unit(np.random.default_rng(21), 8, 32)
        with pytest.raises(ValueError, match="timestamps length"):
            idx.add("v", emb, np.arange(float(n_ts)))
        assert idx.n_videos == 0

    def test_unknown_dtype_raises(self):
        with pytest.raises(ValueError, match="dtype"):
            self._index(dtype="float16")

    def test_entry_point_needs_a_card(self, monkeypatch):
        from avede_tpu_torch.utils.errors import ConfigurationError

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(ConfigurationError):
            tli.DeviceLibraryIndex(32)

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_search_launches_its_entry_only_on_a_card(self, dtype):
        """On the CPU the index runs plain versions: no launch counted."""
        before = (tk.cosine_scores.launches, tk.cosine_scores_bf16.launches,
                  tk.cosine_scores_int8.launches)
        idx = self._index(dtype=dtype)
        idx.add("v", _unit(np.random.default_rng(2), 5, 32), np.arange(5.0))
        assert idx.search(_unit(np.random.default_rng(3), 1, 32)[0], 3)
        assert (tk.cosine_scores.launches, tk.cosine_scores_bf16.launches,
                tk.cosine_scores_int8.launches) == before

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_concurrent_adds_and_searches(self, dtype):
        """Searches racing adds, removes and growth never crash or return
        rows that fail to map back to a live span."""
        import sys

        rng = np.random.default_rng(9)
        idx = self._index(dim=16, dtype=dtype)
        idx.add("seed", _unit(rng, 12, 16), np.arange(12.0))
        q = _unit(rng, 1, 16)[0]
        errors = []
        stop = threading.Event()
        remaining = [3]
        rlock = threading.Lock()

        def writer(tid):
            r = np.random.default_rng(tid)
            try:
                for i in range(8):
                    vid = f"w{tid}_{i % 3}"
                    n = 5 + i + (300 if i == 4 else 0)   # one grows
                    idx.add(vid, _unit(r, n, 16), np.arange(float(n)))
                    if i % 3 == 2:
                        idx.remove(vid)
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)
            finally:
                with rlock:
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        stop.set()

        def reader():
            try:
                while not stop.is_set():
                    for r in idx.search(q, 8):
                        assert isinstance(r["video_id"], str)
                        assert np.isfinite(r["confidence"])
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=writer, args=(t,))
                       for t in range(3)] + [threading.Thread(target=reader)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert idx.search(q, 4)


# ---------------------------------------------------------------------------
# LibrarySearch through the whole path
# ---------------------------------------------------------------------------

def _write_noise_video(path, seed, n=24):
    import cv2

    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                        (64, 64))
    for _ in range(n):
        w.write(rng.integers(0, 255, (64, 64, 3), np.uint8))
    w.release()
    return str(path)


@pytest.fixture(scope="module")
def weights():
    from avede_tpu.models.clip import init_clip, tiny_test_config

    from avede_tpu_torch.models.convert import params_from_jax

    _, params = init_clip(tiny_test_config(), seed=0)
    return params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture()
def library(weights, tmp_data_dirs, tmp_path, monkeypatch):
    """Both packages over ONE videos directory (three noise mp4s, one
    of them scanned sparse first so ingest takes the backfill), each
    with its own embedding cache."""
    from avede_tpu.models.clip import tiny_test_config as jtiny
    from avede_tpu.parallel.embed import ClipEngine as JEngine
    from avede_tpu.parallel.mesh import build_mesh
    from avede_tpu.pipelines.phase1 import Phase1Scan as JScan

    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan

    videos = tmp_data_dirs / "videos"
    for attr, value in [("DATA_DIR", tmp_path / "port"),
                        ("VIDEO_DIR", videos),
                        ("EMBEDDING_DIR", tmp_path / "port" / "embeddings")]:
        os.makedirs(value, exist_ok=True)
        monkeypatch.setattr(tsettings, attr, str(value))
    paths = {name: _write_noise_video(videos / f"{name}.mp4", seed)
             for seed, name in enumerate(("lib-a", "lib-b", "lib-c"))}
    params, sd = weights
    jscan = JScan(JEngine(cfg=jtiny(), params=params, mesh=build_mesh()))
    tscan = Phase1Scan(ClipEngine(cfg=tiny_test_config(), state_dict=sd,
                                  device="cpu"))
    for scan in (jscan, tscan):
        scan.process_video(paths["lib-a"], "noise", threshold=-1.0,
                           video_id="lib-a")
    return jscan, tscan


def _same_results(got, ref, tol):
    assert [(r["video_id"], r["frame_index"]) for r in got] \
        == [(r["video_id"], r["frame_index"]) for r in ref]
    np.testing.assert_allclose([r["confidence"] for r in got],
                               [r["confidence"] for r in ref],
                               atol=tol, rtol=0)


class _JaxTables:
    """The JAX scan's tables and text embeddings behind the interface
    ``LibrarySearch`` reads from a ``Phase1Scan``."""

    def __init__(self, jscan, tscan):
        self.engine = SimpleNamespace(cfg=tscan.engine.cfg,
                                      device=tscan.engine.device,
                                      embed_texts=jscan.engine.embed_texts)
        self.frame_embeddings = jscan.frame_embeddings


class TestLibrarySearchMatchesJax:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_indexed_search(self, library, monkeypatch, dtype):
        from avede_tpu.services.library_search import \
            LibrarySearch as JSearch

        from avede_tpu_torch.services.library_search import LibrarySearch

        jscan, tscan = library
        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, "LIBRARY_INDEX_DTYPE", dtype)
        jsearch, tsearch = JSearch(jscan), LibrarySearch(tscan)
        same_tables = LibrarySearch(_JaxTables(jscan, tscan))
        for query in ("static noise", "a bright frame"):
            ref = jsearch.search(query, top_k=6, threshold=-1.0)
            got = tsearch.search(query, top_k=6, threshold=-1.0)
            assert got["metadata"]["index"] == ref["metadata"]["index"]
            assert got["metadata"]["videos_searched"] == 3
            _same_results(got["results"], ref["results"], ENGINE_TOL)
            _same_results(same_tables.search(query, top_k=6,
                                             threshold=-1.0)["results"],
                          ref["results"], CONF_TOL)
            # the host per-table path over the same library
            host = tsearch.search(query, top_k=6, threshold=-1.0,
                                  video_ids=["lib-a", "lib-b", "lib-c"])
            _same_results(got["results"], host["results"], TIER_TOL[dtype])
            assert "index" not in host["metadata"]

    def test_engine_tables_within_bar(self, library):
        """The two packages' full tables of the same clips (the JAX
        engine's and the port's, each through its int8 cache): equal to
        1e-5 but where the cache rounded the two f32 embeddings to
        neighbouring int8 levels, there one step of the row's scale —
        the reason the whole-path hits are held to ENGINE_TOL and not to
        1e-5."""
        jscan, tscan = library
        for vid in ("lib-a", "lib-b", "lib-c"):
            path = os.path.join(tsettings.VIDEO_DIR, f"{vid}.mp4")
            ej, tj = jscan.frame_embeddings(path, vid)
            et, tt = tscan.frame_embeddings(path, vid)
            assert ej.shape == et.shape and np.allclose(tj, tt)
            diff = np.abs(ej - et)
            step = np.broadcast_to(np.abs(et).max(axis=1, keepdims=True)
                                   / 127.0, diff.shape)
            off = diff > 1e-5
            assert off.sum(axis=1).max() <= 1       # rare: one at most a row
            np.testing.assert_allclose(diff[off], step[off], rtol=1e-2)

    def test_host_path_matches_jax(self, library, monkeypatch):
        from avede_tpu.services.library_search import \
            LibrarySearch as JSearch

        from avede_tpu_torch.services.library_search import LibrarySearch

        jscan, tscan = library
        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, "LIBRARY_INDEX_ENABLED", False)
        ref = JSearch(jscan).search("noise", top_k=5, threshold=-1.0,
                                    per_video_k=2)
        got = LibrarySearch(tscan).search("noise", top_k=5, threshold=-1.0,
                                          per_video_k=2)
        _same_results(got["results"], ref["results"], ENGINE_TOL)
        assert got["metadata"]["frames_scored"] \
            == ref["metadata"]["frames_scored"]

    def test_deleted_video_evicted(self, library):
        from avede_tpu_torch.services.library_search import LibrarySearch

        _, tscan = library
        search = LibrarySearch(tscan)
        out = search.search("anything", top_k=9, threshold=-1.0)
        assert {r["video_id"] for r in out["results"]} \
            == {"lib-a", "lib-b", "lib-c"}
        os.remove(search._resolve("lib-c"))
        out = search.search("anything", top_k=9, threshold=-1.0)
        assert {r["video_id"] for r in out["results"]} == {"lib-a", "lib-b"}
        assert not search._index.has("lib-c")

    def test_prewarm_populates_before_first_search(self, library):
        from avede_tpu_torch.services.library_search import LibrarySearch

        _, tscan = library
        search = LibrarySearch(tscan)
        assert search.prewarm() == 3
        rows = search._index.n_rows
        assert rows > 0
        calls = {"n": 0}
        orig = tscan.frame_embeddings

        def counting(*a, **k):
            calls["n"] += 1
            return orig(*a, **k)

        tscan.frame_embeddings = counting
        out = search.search("anything", top_k=4, threshold=-1.0)
        assert out["results"] and calls["n"] == 0
        assert search._index.n_rows == rows


def test_per_video_cap():
    """per_video_k caps hits per video even when one video owns the
    global top scores."""
    from avede_tpu_torch.services.library_search import LibrarySearch

    rng = np.random.default_rng(3)
    search = LibrarySearch.__new__(LibrarySearch)
    search._index = tli.DeviceLibraryIndex(16, dtype="float32",
                                           device="cpu")
    search._populate_lock = threading.Lock()
    q = _unit(rng, 1, 16)[0]
    hot = np.tile(q, (20, 1)) + 0.01 * rng.normal(size=(20, 16))
    hot /= np.linalg.norm(hot, axis=-1, keepdims=True)
    search._index.add("hot", hot.astype(np.float32), np.arange(20.0))
    search._index.add("cold", _unit(rng, 20, 16), np.arange(20.0))

    class FakeEngine:
        def embed_texts(self, _):
            return q[None]

    class FakePhase1:
        engine = FakeEngine()

    search.phase1 = FakePhase1()
    search.list_videos = lambda: ["hot", "cold"]
    search._resolve = lambda vid: vid        # never reached (has() True)
    out = search._search_indexed("q", top_k=6, threshold=-1.0,
                                 per_video_k=3, t0=0.0)
    per_vid = {}
    for r in out["results"]:
        per_vid[r["video_id"]] = per_vid.get(r["video_id"], 0) + 1
    assert per_vid == {"hot": 3, "cold": 3}
