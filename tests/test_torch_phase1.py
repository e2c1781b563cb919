"""The ported ``mvp`` slice as a whole against the JAX package: a real
mp4 through both ``VideoProcessor.process_query(mode="mvp")`` on the
same tiny weights.

The JAX engine runs its conv path in f32 and the port its fused patch
embed + flash path in f32 (plain versions on the CPU); both store the
table through the int8 embedding cache. Window indices must agree; a
confidence may differ by the int8 round trip of a row (one step of
amax/127 per element, ≲3e-3 on a unit vector) plus f32 rounding, so
the bar is 5e-3.
"""

import jax
import numpy as np
import pytest
import torch

from avede_tpu.utils.config import settings as jsettings
from avede_tpu_torch.utils.config import settings as tsettings
from tests.conftest import make_test_video

CONF_TOL = 5e-3


@pytest.fixture(scope="module")
def weights():
    from avede_tpu.models.clip import init_clip, tiny_test_config

    from avede_tpu_torch.models.convert import params_from_jax

    _, params = init_clip(tiny_test_config(), seed=0)
    return params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.fixture()
def port_dirs(tmp_path, monkeypatch):
    """Point the port's settings at their own temp data tree."""
    root = tmp_path / "port"
    for attr, sub in [("DATA_DIR", ""), ("VIDEO_DIR", "videos"),
                      ("CLIP_DIR", "clips"), ("FRAME_DIR", "frames"),
                      ("EMBEDDING_DIR", "embeddings"), ("IMAGE_DIR", "images"),
                      ("LOG_DIR", "logs")]:
        p = root / sub if sub else root
        p.mkdir(parents=True, exist_ok=True)
        monkeypatch.setattr(tsettings, attr, str(p))
    return root


@pytest.fixture()
def engines(weights):
    from avede_tpu.models.clip import tiny_test_config as jtiny
    from avede_tpu.parallel.embed import ClipEngine as JEngine
    from avede_tpu.parallel.mesh import build_mesh

    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine

    params, sd = weights
    jeng = JEngine(cfg=jtiny(), params=params, mesh=build_mesh())
    teng = ClipEngine(cfg=tiny_test_config(), state_dict=sd, device="cpu")
    return jeng, teng


@pytest.fixture()
def processors(engines, tmp_data_dirs, port_dirs):
    from avede_tpu.services.video_processor import \
        VideoProcessor as JProcessor

    from avede_tpu_torch.services.video_processor import VideoProcessor

    jeng, teng = engines
    return JProcessor(engine=jeng), VideoProcessor(engine=teng)


def _assert_same(port, ref):
    assert [r["window_index"] for r in port] \
        == [r["window_index"] for r in ref]
    for a, b in zip(port, ref):
        assert a["phase"] == b["phase"] == "phase1_mvp"
        assert a["timestamp"] == b["timestamp"]
        assert abs(a["confidence"] - b["confidence"]) <= CONF_TOL


class TestMvpSlice:
    def test_process_query_matches_jax(self, processors, tmp_data_dirs):
        jproc, tproc = processors
        video = make_test_video(tmp_data_dirs / "videos" / "vid1.mp4",
                                n_frames=120)
        ref = jproc.process_query(video, "a white square moving",
                                  mode="mvp", top_k=6, threshold=-1.0,
                                  extract_clips=False, video_id="vid1")
        cold = tproc.process_query(video, "a white square moving",
                                   mode="mvp", top_k=6, threshold=-1.0,
                                   extract_clips=False, video_id="vid1")
        warm = tproc.process_query(video, "a white square moving",
                                   mode="mvp", top_k=6, threshold=-1.0,
                                   extract_clips=False, video_id="vid1")
        assert ref["status"] == cold["status"] == "completed"
        assert cold["total_found"] == len(cold["results"]) == 6
        assert cold["metadata"]["preprocessed_query"] \
            == ref["metadata"]["preprocessed_query"]
        _assert_same(cold["results"], ref["results"])
        assert warm["results"] == cold["results"]

    def test_process_queries_matches_jax(self, engines, tmp_path,
                                         port_dirs):
        from avede_tpu.io.embedding_cache import EmbeddingCache as JCache
        from avede_tpu.pipelines.phase1 import Phase1Scan as JScan

        from avede_tpu_torch.io.embedding_cache import EmbeddingCache
        from avede_tpu_torch.pipelines.phase1 import Phase1Scan

        jeng, teng = engines
        video = make_test_video(tmp_path / "multi.mp4", n_frames=100)
        queries = ["white square", "dark background", "a person"]
        ref = JScan(jeng, cache=JCache(str(tmp_path / "je"))
                    ).process_queries(video, queries, top_k=4,
                                      threshold=-1.0)
        got = Phase1Scan(teng, cache=EmbeddingCache(str(tmp_path / "te"))
                         ).process_queries(video, queries, top_k=4,
                                           threshold=-1.0)
        for q in queries:
            _assert_same(got[q], ref[q])

    def test_dense_scan_with_dedup_matches_jax(self, engines, tmp_path,
                                               port_dirs, monkeypatch):
        from avede_tpu.io.embedding_cache import EmbeddingCache as JCache
        from avede_tpu.pipelines.phase1 import Phase1Scan as JScan

        from avede_tpu_torch.io.embedding_cache import EmbeddingCache
        from avede_tpu_torch.pipelines.phase1 import Phase1Scan

        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, "SCAN_SPARSE_COLD", False)
        jeng, teng = engines
        video = make_test_video(tmp_path / "dense.mp4", n_frames=90)
        jscan = JScan(jeng, cache=JCache(str(tmp_path / "je")))
        tscan = Phase1Scan(teng, cache=EmbeddingCache(str(tmp_path / "te")))
        ref_emb, ref_ts = jscan.frame_embeddings(video, "dense")
        emb, ts = tscan.frame_embeddings(video, "dense")
        assert ts == ref_ts and emb.shape == ref_emb.shape
        assert np.abs(emb - ref_emb).max() <= CONF_TOL

    def test_sparse_entry_backfills_to_full_table(self, engines, tmp_path,
                                                  port_dirs, monkeypatch):
        """Cold sparse scan, then a full-table read completes the entry
        from retention; the result equals an exact (ungated) dense JAX
        scan's table."""
        from avede_tpu.io.embedding_cache import EmbeddingCache as JCache
        from avede_tpu.pipelines.phase1 import Phase1Scan as JScan

        from avede_tpu_torch.io.embedding_cache import EmbeddingCache
        from avede_tpu_torch.pipelines.phase1 import Phase1Scan

        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, "SCAN_DEDUP_EPS", 0.0)
        jeng, teng = engines
        video = make_test_video(tmp_path / "sp.mp4", n_frames=80)
        cache = EmbeddingCache(str(tmp_path / "te"))
        tscan = Phase1Scan(teng, cache=cache)
        tscan.process_video(video, "white square", threshold=-1.0,
                            video_id="sp")
        assert cache.get("sp", tscan.cache_tag(), 1) is None     # sparse
        full, _ = tscan.frame_embeddings(video, "sp", rows="full")
        assert cache.get("sp", tscan.cache_tag(), 1) is not None
        ref, _ = JScan(jeng, cache=JCache(str(tmp_path / "je"))
                       ).frame_embeddings(video, "sp", rows="full")
        assert np.abs(full - ref).max() <= CONF_TOL

    def test_blip2_modes_served_and_unknown_mode_is_error_envelope(
            self, processors, tmp_data_dirs, tmp_path, monkeypatch):
        """Every query mode is served: with ``BLIP_MODEL`` naming BLIP-2,
        ``reranked`` ranks the candidates as JAX's does by ITC scores and
        ``advanced`` completes with them; an unknown mode answers with
        an error envelope."""
        from tests.test_torch_qformer import use_tiny_blip2

        jproc, tproc = processors
        use_tiny_blip2(monkeypatch, tmp_path)
        video = make_test_video(tmp_data_dirs / "videos" / "v2.mp4")
        outs = {}
        for mode in ("reranked", "advanced"):
            out = tproc.process_query(video, "q", mode=mode, top_k=3,
                                      threshold=-1.0, extract_clips=False,
                                      video_id="v2")
            assert out["status"] == "completed", out
            assert out["total_found"] == len(out["results"]) > 0
            assert all(np.isfinite(r["itc_score"]) for r in out["results"])
            outs[mode] = out["results"]
        ref = jproc.process_query(video, "q", mode="reranked", top_k=3,
                                  threshold=-1.0, extract_clips=False,
                                  video_id="v2")["results"]
        assert [r["timestamp"] for r in outs["reranked"]] \
            == [r["timestamp"] for r in ref]
        for r, want in zip(outs["reranked"], ref):
            assert abs(r["itc_score"] - want["itc_score"]) <= 1e-4
        out = tproc.process_query(video, "q", mode="bogus")
        assert out["status"] == "error" and "bogus" in out["error"]

    def test_clips_attached(self, processors, tmp_data_dirs):
        _, tproc = processors
        video = make_test_video(tmp_data_dirs / "videos" / "v3.mp4")
        out = tproc.process_query(video, "white square", top_k=2,
                                  threshold=-1.0)
        assert out["status"] == "completed" and out["total_found"] == 2
        for r in out["results"]:
            assert r["clip_filename"].endswith(".mp4")

    def test_model_tag_keeps_backends_apart(self, engines):
        jeng, teng = engines
        assert "|torch|" in teng.model_tag
        assert teng.model_tag != jeng.model_tag

    def test_embed_frames_matches_stream(self, engines):
        _, teng = engines
        rng = np.random.default_rng(0)
        frames = rng.integers(0, 255, (40, 48, 64, 3), dtype=np.uint8)
        a = teng.embed_frames(frames)
        b = teng.embed_stream(iter([frames[:7], frames[7:]]))
        assert a.shape == (40, teng.cfg.projection_dim)
        np.testing.assert_allclose(a, b, atol=1e-6)
        emb, valid = teng.embed_frames_device(frames[:5])
        assert int(valid.sum()) == 5
        np.testing.assert_allclose(emb[:5].numpy(), a[:5], atol=1e-6)
        np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1, atol=1e-5)

    def test_text_embeddings_match_jax(self, engines):
        jeng, teng = engines
        texts = ["a white square", "night street", "a white square"]
        np.testing.assert_allclose(teng.embed_texts(texts),
                                   jeng.embed_texts(texts), atol=2e-4)
        assert torch.is_tensor(teng.resident_table(
            np.zeros((3, teng.cfg.projection_dim), np.float32),
            np.array([1]))[0])
