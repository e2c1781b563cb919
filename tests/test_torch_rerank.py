"""The ported ``reranked`` and ``advanced`` slice as a whole against the
JAX package: a real mp4 through both ``VideoProcessor.process_query``
on the same tiny CLIP, BLIP and grounding weights, plus the pieces the
slice adds around them (``FrameReprCache``, ``read_frames_at``, the
metrics spans, the BLIP-2 reranker that the setting selects).

Both packages store the CLIP table through the int8 embedding cache, so
a CLIP score may differ by one int8 step (the mvp slice's 5e-3 bar);
captions, being tokens of the same weights, must be equal, and so must
the candidate set. Grounded boundaries come from the head on those
tables: within 5e-3 frame steps.
"""

import numpy as np
import pytest
import torch

from avede_tpu_torch.utils.config import settings as tsettings
from tests.conftest import make_test_video

CONF_TOL = 5e-3


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


@pytest.fixture(scope="module")
def weights():
    import jax

    from avede_tpu.models.blip import init_blip, tiny_blip_config
    from avede_tpu.models.clip import init_clip, tiny_test_config
    from avede_tpu.models.univtg import init_grounding, tiny_grounding_config

    from avede_tpu_torch.models.convert import params_from_jax

    out = {}
    for name, (_, params) in (
            ("clip", init_clip(tiny_test_config(), seed=0)),
            ("blip", init_blip(tiny_blip_config(), seed=0)),
            ("ground", init_grounding(tiny_grounding_config(32), seed=1))):
        out[name] = (params, params_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    return out


def _processors(weights):
    """(JAX, port) ``VideoProcessor``s wired with the tiny models."""
    from avede_tpu.models.blip import tiny_blip_config as jblip
    from avede_tpu.models.clip import tiny_test_config as jclip
    from avede_tpu.models.univtg import tiny_grounding_config as jground
    from avede_tpu.parallel.embed import ClipEngine as JEngine
    from avede_tpu.parallel.mesh import build_mesh
    from avede_tpu.pipelines.phase2 import Phase2Rerank as JPhase2
    from avede_tpu.pipelines.phase3 import Phase3Temporal as JPhase3
    from avede_tpu.services.captioner import CaptionService as JCaption
    from avede_tpu.services.video_processor import VideoProcessor as JProc

    from avede_tpu_torch.models.blip import tiny_blip_config
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.models.univtg import tiny_grounding_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.pipelines.phase2 import Phase2Rerank
    from avede_tpu_torch.pipelines.phase3 import Phase3Temporal
    from avede_tpu_torch.services.captioner import CaptionService
    from avede_tpu_torch.services.video_processor import VideoProcessor

    jeng = JEngine(cfg=jclip(), params=weights["clip"][0], mesh=build_mesh())
    jproc = JProc(engine=jeng)
    jproc._phase2 = JPhase2(jproc.phase1, captioner=JCaption(
        jeng, cfg=jblip(), params=weights["blip"][0]))
    jproc._phase3 = JPhase3(jproc._phase2, cfg=jground(32),
                            params=weights["ground"][0])

    teng = ClipEngine(cfg=tiny_test_config(), state_dict=weights["clip"][1],
                      device="cpu")
    tproc = VideoProcessor(engine=teng)
    tproc._phase2 = Phase2Rerank(tproc.phase1, captioner=CaptionService(
        teng, cfg=tiny_blip_config(), state_dict=weights["blip"][1]))
    tproc._phase3 = Phase3Temporal(tproc._phase2,
                                   cfg=tiny_grounding_config(32),
                                   state_dict=weights["ground"][1])
    return jproc, tproc


@pytest.fixture()
def processors(weights, tmp_data_dirs, port_dirs):
    return _processors(weights)


def _query(proc, video, mode, vid):
    out = proc.process_query(video, "a white square moving", mode=mode,
                             top_k=4, threshold=-1.0, extract_clips=False,
                             video_id=vid)
    assert out["status"] == "completed", out
    return out["results"]


def _check_confidences(results, phase):
    confs = [r["confidence"] for r in results]
    assert confs == sorted(confs, reverse=True)
    for r in results:
        assert r["phase"] == phase
        if phase == "phase2_reranked":
            want = 0.7 * r["clip_score"] + 0.3 * r["caption_similarity"]
            assert abs(r["confidence"] - want) <= 1e-5


class TestRerankSlice:
    def test_reranked_matches_jax(self, processors, tmp_data_dirs):
        jproc, tproc = processors
        video = make_test_video(tmp_data_dirs / "videos" / "r.mp4",
                                n_frames=120)
        ref = _query(jproc, video, "reranked", "r")
        got = _query(tproc, video, "reranked", "r")
        for res in (ref, got):
            _check_confidences(res, "phase2_reranked")
        assert len(got) == len(ref) == 4
        by_ts = {r["timestamp"]: r for r in ref}
        assert set(by_ts) == {r["timestamp"] for r in got}
        for r in got:
            want = by_ts[r["timestamp"]]
            assert r["caption"] == want["caption"]
            assert r["window_index"] == want["window_index"]
            assert abs(r["caption_similarity"]
                       - want["caption_similarity"]) <= 1e-5
            assert abs(r["clip_score"] - want["clip_score"]) <= CONF_TOL
            assert abs(r["confidence"] - want["confidence"]) <= CONF_TOL

    def test_advanced_matches_jax(self, processors, tmp_data_dirs):
        jproc, tproc = processors
        video = make_test_video(tmp_data_dirs / "videos" / "a.mp4",
                                n_frames=120)
        ref = _query(jproc, video, "advanced", "a")
        got = _query(tproc, video, "advanced", "a")
        for res in (ref, got):
            _check_confidences(res, "phase3_univtg")
        dt = 1.0 / 25.0                          # the clip's frame step
        assert [r["timestamp"] for r in got] == [r["timestamp"] for r in ref]
        for r, want in zip(got, ref):
            assert r["caption"] == want["caption"]
            assert r["refinement_method"] == "grounding_head"
            assert r["start_time"] <= r["timestamp"] <= r["end_time"]
            assert abs(r["start_time"] - want["start_time"]) <= CONF_TOL * dt
            assert abs(r["end_time"] - want["end_time"]) <= CONF_TOL * dt
            assert abs(r["saliency"] - want["saliency"]) <= CONF_TOL
            assert abs(r["confidence"] - want["confidence"]) <= CONF_TOL
        # direct query → segments grounding on the same tables
        ref = jproc.phase3.ground_query(video, "white square", top_k=3,
                                        video_id="a")
        got = tproc.phase3.ground_query(video, "white square", top_k=3,
                                        video_id="a")
        assert [s["timestamp"] for s in got] == [s["timestamp"] for s in ref]
        for s, want in zip(got, ref):
            for key in ("start_time", "end_time"):
                assert abs(s[key] - want[key]) <= CONF_TOL * dt

    def test_warm_rerank_reads_no_frames_and_runs_no_blip(
            self, processors, tmp_data_dirs):
        _, tproc = processors
        video = make_test_video(tmp_data_dirs / "videos" / "w.mp4",
                                n_frames=90)
        first = _query(tproc, video, "reranked", "w")
        p1, cap = tproc.phase1, tproc.phase2.captioner
        calls = {"read": 0, "blip": 0}
        read, ids = p1.reader.read_frames_at, cap.caption_ids

        def counting_read(*a, **k):
            calls["read"] += 1
            return read(*a, **k)

        def counting_ids(frames):
            calls["blip"] += 1
            return ids(frames)

        p1.reader.read_frames_at = counting_read
        cap.caption_ids = counting_ids
        second = _query(tproc, video, "reranked", "w")
        assert calls == {"read": 0, "blip": 0}
        assert second == first

    def test_candidates_missing_from_retention_are_read(
            self, processors, tmp_data_dirs):
        """A rerank whose captions are not cached and whose scan frames
        are gone reads the candidates with container seeks, and gets
        the captions retention would have given."""
        _, tproc = processors
        video = make_test_video(tmp_data_dirs / "videos" / "s.mp4",
                                n_frames=90)
        first = _query(tproc, video, "reranked", "s")
        tproc.phase2._repr_cache.invalidate("s")
        second = _query(tproc, video, "reranked", "s")
        assert [r["caption"] for r in second] \
            == [r["caption"] for r in first]

    def test_blip2_setting_serves_itc_rerank_as_jax(
            self, processors, weights, tmp_data_dirs, tmp_path, monkeypatch):
        """``BLIP_MODEL`` naming BLIP-2 serves ``reranked`` and
        ``advanced`` with ITC scores: both packages load one ``.npz`` of
        tiny Q-Former weights; the candidates, their order and their
        ``itc_score`` details are JAX's."""
        from avede_tpu.models.univtg import tiny_grounding_config as jground
        from avede_tpu.pipelines.phase2 import Phase2Rerank as JPhase2
        from avede_tpu.pipelines.phase3 import Phase3Temporal as JPhase3

        from avede_tpu_torch.models.univtg import tiny_grounding_config
        from avede_tpu_torch.pipelines.phase2 import Phase2Rerank
        from avede_tpu_torch.pipelines.phase3 import Phase3Temporal
        from avede_tpu_torch.services.captioner import Blip2RerankService
        from tests.test_torch_qformer import use_tiny_blip2

        jproc, tproc = processors
        use_tiny_blip2(monkeypatch, tmp_path)
        # the default reranker by the setting; the tiny grounding head
        jproc._phase2 = JPhase2(jproc.phase1)
        jproc._phase3 = JPhase3(jproc._phase2, cfg=jground(32),
                                params=weights["ground"][0])
        tproc._phase2 = Phase2Rerank(tproc.phase1)
        tproc._phase3 = Phase3Temporal(tproc._phase2,
                                       cfg=tiny_grounding_config(32),
                                       state_dict=weights["ground"][1])
        video = make_test_video(tmp_data_dirs / "videos" / "b.mp4",
                                n_frames=120)
        for mode in ("reranked", "advanced"):
            ref = _query(jproc, video, mode, "b")
            got = _query(tproc, video, mode, "b")
            assert isinstance(tproc.phase2.captioner, Blip2RerankService)
            assert len(got) == len(ref) == 4
            assert [r["timestamp"] for r in got] \
                == [r["timestamp"] for r in ref]
            for r, want in zip(got, ref):
                assert "caption" not in r
                assert abs(r["itc_score"] - want["itc_score"]) <= 1e-4
                assert r["caption_similarity"] == r["itc_score"]
                assert abs(r["confidence"] - want["confidence"]) <= CONF_TOL


def test_spans_reach_the_metrics_monitor(weights, tmp_data_dirs, port_dirs):
    """One cold mvp query in each package records the same phase1.*
    operations in its monitor; the port's advanced query adds
    phase2.rerank and phase3.ground, as JAX's does."""
    from avede_tpu.utils.metrics import get_monitor as jmonitor

    from avede_tpu_torch.utils.metrics import get_monitor

    jproc, tproc = _processors(weights)
    video = make_test_video(tmp_data_dirs / "videos" / "m.mp4", n_frames=60)

    def counts(monitor):
        return {k: v["count_total"]
                for k, v in monitor().summary()["operations"].items()}

    def grown(monitor, before):
        return {k for k, v in counts(monitor).items()
                if v > before.get(k, 0)}

    jb, tb = counts(jmonitor), counts(get_monitor)
    _query(jproc, video, "mvp", "m")
    _query(tproc, video, "mvp", "m")
    ref, got = grown(jmonitor, jb), grown(get_monitor, tb)
    assert got == ref and "phase1.score_topk" in got
    assert "phase1.decode_embed" in got
    tb = counts(get_monitor)
    _query(tproc, video, "advanced", "m")
    assert {"phase2.rerank", "phase3.ground",
            "phase1.backfill"} <= grown(get_monitor, tb)


class TestFrameReprCache:
    def test_round_trip_and_tag_invalidation(self, tmp_path):
        from avede_tpu.io.embedding_cache import FrameReprCache as JCache

        from avede_tpu_torch.io.embedding_cache import FrameReprCache

        cache = FrameReprCache("blipcap", cache_dir=str(tmp_path))
        ts = [0.0, 0.04, 1.2345]
        cache.put_many("v", "tag1", {cache.key(t): np.str_(f"cap {t}")
                                     for t in ts})
        assert (tmp_path / "v.blipcap.npz").exists()
        assert cache.key(1.2345) == "r1234" == JCache.key(1.2345)
        fresh = FrameReprCache("blipcap", cache_dir=str(tmp_path))
        hit = fresh.get_many("v", "tag1", ts + [9.0])
        assert {k: str(v) for k, v in hit.items()} \
            == {cache.key(t): f"cap {t}" for t in ts}
        # the JAX package reads the same file
        assert set(JCache("blipcap", cache_dir=str(tmp_path)).get_many(
            "v", "tag1", ts)) == set(hit)
        assert fresh.get_many("v", "tag2", ts) == {}      # tag changed
        fresh.invalidate("v")
        assert not (tmp_path / "v.blipcap.npz").exists()

    def test_persist_false_writes_nothing(self, tmp_path):
        from avede_tpu_torch.io.embedding_cache import FrameReprCache

        cache = FrameReprCache("blipcap", cache_dir=str(tmp_path / "c"),
                               persist=False)
        cache.put_many("v", "t", {"r0": np.str_("a")})
        assert str(cache.get_many("v", "t", [0.0])["r0"]) == "a"
        assert not (tmp_path / "c").exists()

    def test_memory_tier_counts_what_it_holds(self, tmp_path):
        from avede_tpu_torch.io.embedding_cache import FrameReprCache

        cache = FrameReprCache("blipcap", cache_dir=str(tmp_path),
                               persist=False)
        for vid, n in (("v", 3), ("v", 5), ("w", 2), ("v", 4)):
            cache.put_many(vid, "t", {f"r{i}": np.str_("x" * (i + 1))
                                      for i in range(n)})
        assert cache._mem_bytes == sum(cache._nbytes(entries)
                                       for _, entries in cache._mem.values())
        cache.invalidate("v")
        assert cache._mem_bytes == cache._nbytes(cache._mem["w"][1])


def test_read_frames_at_matches_jax(tmp_path):
    from avede_tpu.io.video_reader import VideoReader as JReader

    from avede_tpu_torch.io.video_reader import VideoReader

    video = make_test_video(tmp_path / "f.mp4", n_frames=40)
    ts = [0.0, 0.52, 1.56, 99.0]
    got, ok = VideoReader().read_frames_at(video, ts, return_ok=True)
    ref, ref_ok = JReader().read_frames_at(video, ts, return_ok=True)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ok, ref_ok)
    np.testing.assert_array_equal(VideoReader().read_frame_at(video, 0.52),
                                  JReader().read_frame_at(video, 0.52))


def test_rerank_models_live_on_the_engine_device():
    from avede_tpu_torch.models.blip import tiny_blip_config
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.captioner import CaptionService

    engine = ClipEngine(cfg=tiny_test_config(), device="cpu")
    cap = CaptionService(engine, cfg=tiny_blip_config())
    assert cap.device == engine.device and cap._param_src == "rand0"
    caps = cap.caption_frames(np.random.default_rng(0).integers(
        0, 255, (2, 48, 64, 3), dtype=np.uint8))
    assert len(caps) == 2 and all(isinstance(c, str) and c for c in caps)
    assert next(cap.model.parameters()).dtype == torch.float32
