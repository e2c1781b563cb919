"""The port's REST app through aiohttp's test client: a real tiny-CLIP
processor on the CPU over a real mp4, no route mocking."""

import asyncio

import numpy as np
import pytest
from aiohttp import FormData
from aiohttp.test_utils import TestClient, TestServer

from avede_tpu_torch.utils.config import settings
from tests.conftest import make_test_video


@pytest.fixture()
def client(tmp_path, monkeypatch):
    from avede_tpu_torch.api.app import create_app
    from avede_tpu_torch.models.blip import tiny_blip_config
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.models.univtg import tiny_grounding_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.pipelines.phase2 import Phase2Rerank
    from avede_tpu_torch.pipelines.phase3 import Phase3Temporal
    from avede_tpu_torch.services.captioner import CaptionService
    from avede_tpu_torch.services.video_processor import VideoProcessor

    for attr, sub in [("DATA_DIR", ""), ("VIDEO_DIR", "videos"),
                      ("CLIP_DIR", "clips"), ("FRAME_DIR", "frames"),
                      ("EMBEDDING_DIR", "embeddings"), ("IMAGE_DIR", "images"),
                      ("LOG_DIR", "logs")]:
        monkeypatch.setattr(settings, attr, str(tmp_path / sub))
    engine = ClipEngine(cfg=tiny_test_config(), device="cpu")
    processor = VideoProcessor(engine=engine)
    # tiny BLIP and grounding head behind reranked / advanced
    processor._phase2 = Phase2Rerank(processor.phase1, captioner=CaptionService(
        engine, cfg=tiny_blip_config()))
    processor._phase3 = Phase3Temporal(processor._phase2,
                                       cfg=tiny_grounding_config(32))
    app = create_app(processor)
    loop = asyncio.new_event_loop()
    tc = TestClient(TestServer(app, loop=loop), loop=loop)
    loop.run_until_complete(tc.start_server())

    def call(method, path, **kw):
        async def go():
            resp = await tc.request(method, path, **kw)
            return resp.status, await resp.json()
        return loop.run_until_complete(go())

    call.processor = processor
    yield call
    loop.run_until_complete(tc.close())
    loop.close()


def _upload(call, path):
    form = FormData()
    form.add_field("file", open(path, "rb"), filename="clip.mp4",
                   content_type="video/mp4")
    return call("POST", "/api/upload", data=form)


class TestPortApi:
    def test_health(self, client):
        status, body = client("GET", "/api/health")
        assert status == 200 and body["status"] == "healthy"

    def test_upload_list_query(self, client, tmp_path):
        video = make_test_video(tmp_path / "src.mp4", n_frames=60)
        status, body = _upload(client, video)
        assert status == 200 and body["status"] == "uploaded"
        vid = body["video_id"]
        status, listing = client("GET", "/api/videos")
        assert any(v["video_id"] == vid for v in listing["videos"])
        payload = {"video_id": vid, "query": "white square",
                   "mode": "mvp", "top_k": 3, "threshold": -1.0}
        status, out = client("POST", "/api/query", json=payload)
        assert status == 200 and out["status"] == "completed"
        assert out["total_found"] == len(out["results"]) == 3
        confs = [r["confidence"] for r in out["results"]]
        assert confs == sorted(confs, reverse=True)
        assert np.all(np.isfinite(confs))
        status, warm = client("POST", "/api/query", json=payload)
        assert [r["window_index"] for r in warm["results"]] \
            == [r["window_index"] for r in out["results"]]

    @pytest.mark.parametrize("mode", ["reranked", "advanced"])
    def test_rerank_modes_complete(self, client, tmp_path, mode):
        video = make_test_video(tmp_path / "src.mp4", n_frames=60)
        _, body = _upload(client, video)
        payload = {"video_id": body["video_id"], "query": "white square",
                   "mode": mode, "top_k": 3, "threshold": -1.0}
        status, out = client("POST", "/api/query", json=payload)
        assert status == 200 and out["status"] == "completed"
        assert out["total_found"] == len(out["results"]) > 0
        for r in out["results"]:
            assert isinstance(r["caption"], str)
            if mode == "advanced":
                assert r["start_time"] <= r["timestamp"] <= r["end_time"]
        status, warm = client("POST", "/api/query", json=payload)

        def answer(res):       # each call cuts its clips to new files
            return [{k: v for k, v in r.items() if not k.startswith("clip_")}
                    for r in res["results"]]

        assert status == 200 and answer(warm) == answer(out)
        ops = client("GET", "/api/metrics")[1]["operations"]
        assert "phase2.rerank" in ops and "phase1.score_topk" in ops

    def test_unported_mode_is_500_envelope(self, client, tmp_path,
                                           monkeypatch):
        """The BLIP-2 reranker is not ported: selecting it answers an
        advanced query with a 500 error envelope."""
        monkeypatch.setattr(settings, "BLIP_MODEL", "blip2-opt-2.7b")
        client.processor._phase2 = client.processor._phase3 = None
        video = make_test_video(tmp_path / "src.mp4", n_frames=30)
        _, body = _upload(client, video)
        status, out = client("POST", "/api/query", json={
            "video_id": body["video_id"], "query": "q", "mode": "advanced",
            "threshold": -1.0})
        assert status == 500 and out["status"] == "error"
        assert "not ported" in out["error"]

    def test_query_unknown_video_404(self, client):
        status, _ = client("POST", "/api/query",
                           json={"video_id": "nope", "query": "q"})
        assert status == 404

    @pytest.mark.parametrize("body", [{"query": "q"},
                                      {"video_id": "v", "query": 3},
                                      {"video_id": "v", "query": "q",
                                       "top_k": "five"}])
    def test_query_validation_422(self, client, body):
        status, _ = client("POST", "/api/query", json=body)
        assert status == 422

    def test_query_invalid_json_422(self, client):
        status, _ = client("POST", "/api/query", data=b"{not json",
                           headers={"Content-Type": "application/json"})
        assert status == 422

    def test_upload_rejects_format(self, client, tmp_path):
        form = FormData()
        form.add_field("file", b"abc", filename="x.txt")
        status, _ = client("POST", "/api/upload", data=form)
        assert status == 400


class TestLibraryRoute:
    def test_search_library_fields_and_metrics(self, client, tmp_path):
        video = make_test_video(tmp_path / "src.mp4", n_frames=60)
        vids = [_upload(client, video)[1]["video_id"] for _ in range(2)]

        def searches():
            ops = client("GET", "/api/metrics")[1]["operations"]
            return ops.get("library_search", {}).get("count_total", 0)

        before = searches()
        status, out = client("POST", "/api/search-library", json={
            "query": "white square", "top_k": 4, "threshold": -1.0,
            "per_video_k": 2})
        assert status == 200 and out["status"] == "completed"
        assert out["total_found"] == len(out["results"]) == 4
        for r in out["results"]:
            assert set(r) == {"video_id", "timestamp", "confidence",
                              "frame_index"}
            assert r["video_id"] in vids
        confs = [r["confidence"] for r in out["results"]]
        assert confs == sorted(confs, reverse=True)
        meta = out["metadata"]
        assert meta["videos_searched"] == 2
        assert meta["index"]["device_resident"]
        assert meta["index"]["dtype"] == settings.LIBRARY_INDEX_DTYPE
        status, sub = client("POST", "/api/search-library", json={
            "query": "white square", "video_ids": vids[:1],
            "threshold": -1.0})
        assert status == 200
        assert {r["video_id"] for r in sub["results"]} == {vids[0]}
        assert searches() == before + 2

    @pytest.mark.parametrize("body", [{}, {"query": ""}, {"query": 3},
                                      {"query": "q", "top_k": "five"},
                                      {"query": "q", "video_ids": "v"},
                                      {"query": "q", "threshold": True}])
    def test_search_library_validation_422(self, client, body):
        status, _ = client("POST", "/api/search-library", json=body)
        assert status == 422

    def test_search_library_invalid_json_422(self, client):
        status, _ = client("POST", "/api/search-library", data=b"{x",
                           headers={"Content-Type": "application/json"})
        assert status == 422


def test_library_prewarm_thread_indexes_videos(tmp_path, monkeypatch):
    """With LIBRARY_PREWARM the app indexes the videos already uploaded
    on a daemon thread, before any search."""
    import time

    from avede_tpu_torch.api.app import create_app
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.video_processor import VideoProcessor

    for attr in ("DATA_DIR", "VIDEO_DIR", "EMBEDDING_DIR"):
        monkeypatch.setattr(settings, attr, str(tmp_path / attr.lower()))
    (tmp_path / "video_dir").mkdir()
    make_test_video(tmp_path / "video_dir" / "v1.mp4", n_frames=30)
    monkeypatch.setattr(settings, "LIBRARY_PREWARM", True)
    engine = ClipEngine(cfg=tiny_test_config(), device="cpu")
    state = create_app(VideoProcessor(engine=engine))["state"]
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not (
            state._library is not None and state._library._index.has("v1")):
        time.sleep(0.05)
    assert state._library is not None and state._library._index.has("v1")
