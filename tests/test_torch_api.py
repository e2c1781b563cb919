"""The port's REST app through aiohttp's test client: a real tiny-CLIP
processor on the CPU over a real mp4, no route mocking."""

import asyncio
import json

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

    def test_blip2_setting_serves_advanced_query(self, client, tmp_path,
                                                 monkeypatch):
        """``BLIP_MODEL`` naming BLIP-2 serves an advanced query (200,
        ITC scores in every result) in the order the facade gives."""
        from tests.test_torch_qformer import use_tiny_blip2

        use_tiny_blip2(monkeypatch, tmp_path)
        client.processor._phase2 = client.processor._phase3 = None
        video = make_test_video(tmp_path / "src.mp4", n_frames=30)
        _, body = _upload(client, video)
        status, out = client("POST", "/api/query", json={
            "video_id": body["video_id"], "query": "q", "mode": "advanced",
            "threshold": -1.0})
        assert status == 200 and out["status"] == "completed"
        assert out["total_found"] == len(out["results"]) > 0
        assert all(np.isfinite(r["itc_score"]) for r in out["results"])
        direct = client.processor.process_query(
            client.processor.resolve_video(body["video_id"]), "q",
            mode="advanced", threshold=-1.0, extract_clips=False,
            video_id=body["video_id"])
        assert [r["timestamp"] for r in out["results"]] \
            == [r["timestamp"] for r in direct["results"]]

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


# ---------------------------------------------------------------------------
# the same requests to the JAX app and the port's
# ---------------------------------------------------------------------------

class _Recorder:
    """A processor stand-in answering with the arguments it was given, so
    two apps' parses of one body can be compared."""

    def resolve_video(self, video_id):
        if video_id == "missing":
            raise FileNotFoundError(video_id)
        return f"videos/{video_id}.mp4"

    def process_query(self, video, query, **kw):
        return {"status": "completed", "call": "query", "video": video,
                "query": query, **kw}

    def process_unlimited_detection(self, video, queries, **kw):
        return {"status": "completed", "call": "detection", "video": video,
                "object_queries": queries, **kw}

    def process_small_object_detection(self, video, queries, **kw):
        return {"status": "completed", "call": "small_object",
                "video": video, "object_queries": queries, **kw}

    def process_background_independence(self, video, queries, **kw):
        return {"status": "completed", "call": "background",
                "video": video, "object_queries": queries, **kw}

    def process_image_matching(self, video, image, **kw):
        return {"status": "error" if kw["matching_mode"] == "bogus"
                else "completed", "call": "image_matching", "video": video,
                "image": [list(image.shape), int(image.astype(int).sum())],
                **kw}


    def process_person_search(self, video, image, **kw):
        return {"status": "completed", "call": "person", "video": video,
                "image": [list(image.shape), int(image.astype(int).sum())],
                **kw}


class _LibraryRecorder:
    def search(self, query, **kw):
        return {"results": [], "query": query, **kw}


@pytest.fixture()
def both_apps(tmp_path, tmp_data_dirs, monkeypatch):
    """(call, jax_app, port_app): both apps over recorders, sharing one
    data tree; ``call(app, method, path, ...)`` → (status, body,
    headers), the body JSON where it is JSON."""
    from avede_tpu.api.app import create_app as jax_create_app

    from avede_tpu_torch.api.app import create_app

    for attr, sub in [("DATA_DIR", ""), ("VIDEO_DIR", "videos"),
                      ("CLIP_DIR", "clips"), ("FRAME_DIR", "frames"),
                      ("EMBEDDING_DIR", "embeddings"), ("IMAGE_DIR", "images"),
                      ("LOG_DIR", "logs")]:
        monkeypatch.setattr(settings, attr, str(tmp_data_dirs / sub))
    apps = [jax_create_app(_Recorder()), create_app(_Recorder())]
    for app in apps:
        app["state"]._library = _LibraryRecorder()
    loop = asyncio.new_event_loop()
    clients = [TestClient(TestServer(app, loop=loop), loop=loop)
               for app in apps]
    for tc in clients:
        loop.run_until_complete(tc.start_server())

    def call(which, method, path, **kw):
        async def go():
            resp = await clients[which].request(method, path, **kw)
            raw = await resp.read()
            try:
                body = json.loads(raw)
            except ValueError:
                body = raw
            return resp.status, body, resp.headers
        return loop.run_until_complete(go())

    yield call
    for tc in clients:
        loop.run_until_complete(tc.close())
    loop.close()


_BODIES = [
    # /api/query: pydantic 2's lax coercion
    ("/api/query", {"top_k": "5"}), ("/api/query", {"top_k": 5.0}),
    ("/api/query", {"top_k": True}), ("/api/query", {"threshold": "0.3"}),
    ("/api/query", {"top_k": " +7 ", "threshold": 1}),
    ("/api/query", {"top_k": "1_0", "mode": "reranked", "extra": [1]}),
    ("/api/query", {"top_k": None, "threshold": None}),
    ("/api/query", {"threshold": True}), ("/api/query", {"top_k": "5.00"}),
    ("/api/query", {"threshold": " 1e-1 "}),
    ("/api/query", {"top_k": "5.5"}), ("/api/query", {"top_k": "true"}),
    ("/api/query", {"top_k": 5.5}), ("/api/query", {"threshold": "abc"}),
    ("/api/query", {"mode": 3}), ("/api/query", {"query": None}),
    ("/api/query", {"video_id": 1}), ("/api/query", {"video_id": "missing"}),
    # /api/unlimited-detection: UnlimitedDetectionRequest
    ("/api/unlimited-detection", {}),
    ("/api/unlimited-detection", {"object_queries": ["a", "b"]}),
    ("/api/unlimited-detection", {"top_k": "3",
                                  "confidence_threshold": "0.25"}),
    ("/api/unlimited-detection", {"debug_mode": "yes", "top_k": None,
                                  "detection_mode": "clip"}),
    ("/api/unlimited-detection", {"confidence_threshold": None,
                                  "matching_precision": "precise"}),
    ("/api/unlimited-detection", {"object_queries": ["a", 1]}),
    ("/api/unlimited-detection", {"object_queries": 3}),
    ("/api/unlimited-detection", {"debug_mode": 2}),
    ("/api/unlimited-detection", {"detection_mode": None}),
    ("/api/unlimited-detection", {"video_id": "missing"}),
    # /api/small-object-detection: SmallObjectDetectionRequest
    ("/api/small-object-detection", {}),
    ("/api/small-object-detection", {"object_queries": ["a", "b"],
                                     "enable_rpn": "true", "top_k": "3"}),
    ("/api/small-object-detection", {"enable_background_independence": "yes",
                                     "min_object_size": "8",
                                     "max_object_size": 64.0}),
    ("/api/small-object-detection", {"enable_adaptive_thresholds": 1,
                                     "confidence_threshold": "0.1",
                                     "detection_mode": "owlvit"}),
    ("/api/small-object-detection", {"min_object_size": None, "top_k": None,
                                     "debug_mode": "off"}),
    ("/api/small-object-detection", {"enable_rpn": 0.0,
                                     "confidence_threshold": None}),
    ("/api/small-object-detection", {"enable_rpn": 2}),
    ("/api/small-object-detection", {"enable_rpn": "maybe"}),
    ("/api/small-object-detection", {"enable_rpn": None}),
    ("/api/small-object-detection", {"max_object_size": "64.5"}),
    ("/api/small-object-detection", {"object_queries": None}),
    ("/api/small-object-detection", {"video_id": "missing"}),
    # /api/background-independence: BackgroundIndependenceRequest
    ("/api/background-independence", {}),
    ("/api/background-independence", {"background_removal_strength": "0.5",
                                      "top_k": "4"}),
    ("/api/background-independence", {"contrastive_learning_enabled": "no",
                                      "shape_descriptor_enabled": 0,
                                      "confidence_threshold": None,
                                      "top_k": 7.0}),
    ("/api/background-independence", {"background_removal_strength": True}),
    ("/api/background-independence", {"background_removal_strength": 1}),
    ("/api/background-independence", {"background_removal_strength": None}),
    ("/api/background-independence", {"background_removal_strength": "x"}),
    ("/api/background-independence", {"shape_descriptor_enabled": "2"}),
    ("/api/background-independence", {"object_queries": 3}),
    ("/api/background-independence", {"video_id": "missing"}),
    # /api/search-library: the JAX route's int()
    ("/api/search-library", {"top_k": "5"}),
    ("/api/search-library", {"top_k": 5.7, "per_video_k": True}),
    ("/api/search-library", {"per_video_k": " 2 ", "threshold": 0.1}),
]
_BASE = {"/api/query": {"video_id": "v", "query": "a dog"},
         "/api/unlimited-detection": {"video_id": "v",
                                      "object_queries": "a dog"},
         "/api/small-object-detection": {"video_id": "v",
                                         "object_queries": "a dog"},
         "/api/background-independence": {"video_id": "v",
                                          "object_queries": "a dog"},
         "/api/search-library": {"query": "a dog"}}


@pytest.mark.parametrize("path,body", _BODIES)
def test_bodies_parse_as_the_jax_app(both_apps, path, body):
    """Accepted bodies reach the processor with the same arguments in
    both apps; refused ones are 422 (or 404) in both."""
    payload = {**_BASE[path], **body}
    ref = both_apps(0, "POST", path, json=payload)
    got = both_apps(1, "POST", path, json=payload)
    assert got[0] == ref[0]
    if ref[0] == 200:
        assert got[1] == ref[1]


def test_non_object_body_is_422_in_both(both_apps):
    for path in ("/api/query", "/api/unlimited-detection",
                 "/api/small-object-detection",
                 "/api/background-independence"):
        for which in (0, 1):
            assert both_apps(which, "POST", path, json=["v", "q"])[0] == 422


def test_query_and_detection_tracked_as_the_jax_app(both_apps):
    """One query and one detection in each app add the same operations,
    with the same labels, to its metrics monitor."""
    from avede_tpu.utils.metrics import get_monitor as jax_monitor

    from avede_tpu_torch.utils.metrics import get_monitor

    def ops(which):
        out = both_apps(which, "GET", "/api/metrics")[1]["operations"]
        return {k: v["count_total"] for k, v in out.items()}

    before = [ops(0), ops(1)]
    for which in (0, 1):
        both_apps(which, "POST", "/api/query", json={
            "video_id": "v", "query": "q", "mode": "reranked"})
        both_apps(which, "POST", "/api/unlimited-detection", json={
            "video_id": "v", "object_queries": "q",
            "detection_mode": "owlvit"})
    grown = [{k for k, v in ops(w).items() if v > before[w].get(k, 0)}
             for w in (0, 1)]
    assert grown[1] == grown[0] == {"query", "unlimited_detection"}

    def labels(monitor, op):
        rec = monitor()._records[op][-1]
        return {k: v for k, v in rec.items() if k not in ("t", "seconds")}

    for op in ("query", "unlimited_detection"):
        assert labels(get_monitor, op) == labels(jax_monitor, op)
    assert labels(get_monitor, "query")["mode"] == "reranked"


def test_small_object_routes_tracked_as_the_jax_app(both_apps):
    """One small-object and one background-independence call in each app
    add the same operations to its metrics monitor."""
    def ops(which):
        out = both_apps(which, "GET", "/api/metrics")[1]["operations"]
        return {k: v["count_total"] for k, v in out.items()}

    before = [ops(0), ops(1)]
    for which in (0, 1):
        for path in ("/api/small-object-detection",
                     "/api/background-independence"):
            assert both_apps(which, "POST", path, json={
                "video_id": "v", "object_queries": "q"})[0] == 200
    grown = [{k for k, v in ops(w).items() if v > before[w].get(k, 0)}
             for w in (0, 1)]
    assert grown[1] == grown[0] == {"small_object_detection",
                                    "background_independence"}


def test_image_upload_listing_and_capabilities_as_the_jax_app(
        both_apps, tmp_data_dirs):
    """``POST /api/upload-image`` (accepted and refused files) into the
    shared images directory, then ``GET /api/images`` and
    ``GET /api/small-object-capabilities`` answer alike."""
    def upload(which, name, data=b"\x89PNG fake", field="file"):
        form = FormData()
        form.add_field(field, data, filename=name,
                       content_type="application/octet-stream")
        return both_apps(which, "POST", "/api/upload-image", data=form)

    for name, field in (("a.png", "file"), ("b.JPG", "file"),
                        ("c.gif", "file"), ("d.png", "other")):
        ref, got = upload(0, name, field=field), upload(1, name, field=field)
        assert got[0] == ref[0]
        if ref[0] == 200:
            for key in ("status", "filename", "size"):
                assert got[1][key] == ref[1][key]
            assert got[1]["path"].startswith(str(tmp_data_dirs / "images"))
        else:
            assert got[1] == ref[1]
    for path in ("/api/images", "/api/small-object-capabilities"):
        ref, got = (both_apps(w, "GET", path) for w in (0, 1))
        assert got[0] == ref[0] == 200 and got[1] == ref[1]
    assert len(ref[1]) and len(both_apps(1, "GET", "/api/images")[1][
        "images"]) == 4


def test_cors_headers_as_the_jax_app(both_apps):
    cors = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
            "Access-Control-Allow-Headers")
    for method, path in (("OPTIONS", "/api/query"),
                         ("OPTIONS", "/api/unlimited-detection"),
                         ("GET", "/api/health")):
        ref, got = (both_apps(w, method, path) for w in (0, 1))
        assert got[0] == ref[0] == 200
        assert {h: got[2].get(h) for h in cors} \
            == {h: ref[2].get(h) for h in cors}
        assert got[2]["Access-Control-Allow-Origin"] == "*"


def test_clip_download_and_listings_as_the_jax_app(both_apps, tmp_data_dirs):
    clips = tmp_data_dirs / "clips"
    (clips / "c1.mp4").write_bytes(b"\x00\x01clip")
    (tmp_data_dirs / "secret.mp4").write_bytes(b"secret")
    for name in ("c1.mp4", "..%2Fsecret.mp4", "..secret.mp4", "nope.mp4",
                 "%2E%2E%2Fsecret.mp4"):
        ref, got = (both_apps(w, "GET", f"/api/download/{name}")
                    for w in (0, 1))
        assert got[0] == ref[0] and got[1] == ref[1]
        if name == "c1.mp4":
            assert got[0] == 200 and got[1] == b"\x00\x01clip"
            for h in ("Content-Type", "Content-Disposition"):
                assert got[2][h] == ref[2][h]
        else:
            assert got[0] == 404
    for path in ("/api/clips", "/api/detection-modes"):
        ref, got = (both_apps(w, "GET", path) for w in (0, 1))
        assert got[0] == ref[0] == 200 and got[1] == ref[1]


class TestDetectionRoute:
    def test_unlimited_detection_completes(self, client, tmp_path):
        """The route over a real mp4 with tiny OWL-ViT and YOLO models."""
        from avede_tpu_torch.models.owlvit import tiny_owlvit_config
        from avede_tpu_torch.models.yolo import tiny_yolo_config
        from avede_tpu_torch.services.detector import YoloService
        from avede_tpu_torch.services.universal_detector import \
            UniversalDetector

        proc = client.processor
        proc._universal_detector = UniversalDetector(
            proc.engine, owlvit_cfg=tiny_owlvit_config(),
            yolo=YoloService(cfg=tiny_yolo_config(), device="cpu"))
        video = make_test_video(tmp_path / "src.mp4", n_frames=20)
        vid = _upload(client, video)[1]["video_id"]

        def tracked():
            ops = client("GET", "/api/metrics")[1]["operations"]
            return ops.get("unlimited_detection", {}).get("count_total", 0)

        before = tracked()
        for mode in ("hybrid", "yolo_enhanced"):
            status, out = client("POST", "/api/unlimited-detection", json={
                "video_id": vid, "object_queries": ["white square", "car"],
                "detection_mode": mode, "top_k": "4",
                "confidence_threshold": 0.0})
            assert status == 200 and out["status"] == "completed"
            assert out["queries"] == ["white square", "car"]
            assert out["total_found"] == len(out["results"]) <= 4
            assert out["metadata"]["frames_processed"] == 20
            for r in out["results"]:
                assert np.isfinite(r["composite_score"])
        status, out = client("POST", "/api/unlimited-detection", json={
            "video_id": vid, "object_queries": "x",
            "detection_mode": "bogus"})
        assert status == 500 and out["status"] == "error"
        assert tracked() == before + 3

    def test_small_object_and_background_routes_complete(self, client,
                                                         tmp_path):
        """Both routes over a real mp4 with tiny CLIP and OWL-ViT models,
        64 px tiles; the route defaults (``clip`` mode, RPN, adaptive
        thresholds, background independence) and an ``owlvit`` body."""
        from avede_tpu_torch.models.owlvit import tiny_owlvit_config
        from avede_tpu_torch.services.small_object import SmallObjectService
        from avede_tpu_torch.services.universal_detector import \
            UniversalDetector

        proc = client.processor
        proc._universal_detector = UniversalDetector(
            proc.engine, owlvit_cfg=tiny_owlvit_config())
        proc._small_object = SmallObjectService(
            proc.engine, detector=proc._universal_detector, tile=64,
            overlap=16)
        video = make_test_video(tmp_path / "src.mp4", n_frames=6,
                                size=(160, 96))
        vid = _upload(client, video)[1]["video_id"]
        for body in ({}, {"detection_mode": "owlvit", "min_object_size": 4,
                          "confidence_threshold": "0.5", "top_k": 5}):
            status, out = client("POST", "/api/small-object-detection",
                                 json={"video_id": vid,
                                       "object_queries": "white square",
                                       **body})
            assert status == 200 and out["status"] == "completed"
            assert out["queries"] == ["white square"]
            assert out["enhancement_stats"]["tiles_processed"] == 6 * 6
            assert out["total_found"] == len(out["results"])
            assert out["metadata"]["frames_processed"] == 6
        assert out["total_found"] > 0 \
            and out["enhancement_stats"]["bg_features"] > 0
        status, out = client("POST", "/api/background-independence", json={
            "video_id": vid, "object_queries": ["white square", "car"],
            "confidence_threshold": -1.0, "top_k": 3})
        assert status == 200 and out["status"] == "completed"
        assert out["total_found"] == len(out["results"]) <= 3
        assert out["background_independence_stats"]["candidates"] > 0
        assert proc.background._detector is proc.universal_detector


# ---------------------------------------------------------------------------
# image query: POST /api/image-matching, /api/image-matching-by-id and
# GET /api/matching-modes in both apps
# ---------------------------------------------------------------------------

def _png(seed: int = 0) -> bytes:
    import cv2

    img = np.random.default_rng(seed).integers(0, 255, (24, 32, 3),
                                               dtype=np.uint8)
    return cv2.imencode(".png", img)[1].tobytes()


def _image_form(fields, image=b"png"):
    """A multipart form of string ``fields`` and a ``reference_image``
    (a PNG by default; None leaves it out and adds another file, so the
    body stays multipart)."""
    form = FormData()
    for k, v in fields.items():
        form.add_field(k, v)
    if image is None:
        form.add_field("notes", b"no image here", filename="notes.txt")
    else:
        form.add_field("reference_image", _png() if image == b"png"
                       else image, filename="ref.png",
                       content_type="image/png")
    return form


_IMAGE_FIELDS = [
    ({}, 200), ({"top_k": "5"}, 200), ({"top_k": "5.0"}, 200),
    ({"top_k": " +7 "}, 200), ({"top_k": "5.5"}, 422), ({"top_k": ""}, 422),
    ({"top_k": "five"}, 422), ({"similarity_threshold": "0.3"}, 200),
    ({"similarity_threshold": "1e-1"}, 200),
    ({"similarity_threshold": "abc"}, 422), ({"debug_mode": "true"}, 200),
    ({"debug_mode": "1"}, 200), ({"debug_mode": "off"}, 200),
    ({"debug_mode": "maybe"}, 422),
    ({"matching_mode": "smart_match", "target_class": "person"}, 200),
    ({"matching_mode": "bogus"}, 500), ({"extra": "ignored"}, 200),
    ({"video_id": "missing"}, 404), ({"video_id": None}, 422),
]


@pytest.mark.parametrize("fields,status", _IMAGE_FIELDS)
def test_image_matching_fields_parse_as_the_jax_app(both_apps, fields,
                                                    status):
    """Multipart fields arrive as strings: both apps coerce them as
    pydantic 2's lax mode does and answer with the same status (422 for
    a field that does not coerce, 404 for an unknown video, 500 for an
    error envelope); accepted ones reach the processor alike."""
    body = {k: v for k, v in {"video_id": "v", **fields}.items()
            if v is not None}
    ref = both_apps(0, "POST", "/api/image-matching",
                    data=_image_form(body))
    got = both_apps(1, "POST", "/api/image-matching",
                    data=_image_form(body))
    assert got[0] == ref[0] == status
    if status in (200, 500):
        assert got[1] == ref[1]


@pytest.mark.parametrize("image", [None, b"not an image"])
def test_image_matching_without_a_decodable_image_is_422(both_apps, image):
    for which in (0, 1):
        status, body, _ = both_apps(which, "POST", "/api/image-matching",
                                    data=_image_form({"video_id": "v"},
                                                     image))
        assert status == 422 and "reference_image" in body["detail"]


def test_image_matching_by_id_as_the_jax_app(both_apps, tmp_data_dirs):
    """``image_id`` in the body or the query string; 404 for an unknown
    image or video, 400 for an image that does not decode, 422 without
    an ``image_id`` or valid fields."""
    images = tmp_data_dirs / "images"
    images.mkdir(exist_ok=True)
    (images / "img1.png").write_bytes(_png(1))
    (images / "bad.png").write_bytes(b"not an image")
    path = "/api/image-matching-by-id"
    cases = [
        ({"video_id": "v", "image_id": "img1"}, ""),
        ({"video_id": "v", "matching_mode": "fast_match", "top_k": "3",
          "similarity_threshold": "0.25", "debug_mode": "yes"},
         "?image_id=img1"),
        ({"video_id": "v", "image_id": "img1", "target_class": "car"},
         "?image_id=ignored"),
        ({"video_id": "v", "image_id": "nope"}, ""),
        ({"video_id": "v", "image_id": "bad"}, ""),
        ({"video_id": "v"}, ""),
        ({"image_id": "img1"}, ""),
        ({"video_id": "v", "image_id": "img1", "top_k": "5.5"}, ""),
        ({"video_id": "missing", "image_id": "img1"}, ""),
        ({"video_id": "v", "image_id": "img1", "matching_mode": "bogus"},
         ""),
    ]
    statuses = []
    for body, query in cases:
        ref = both_apps(0, "POST", path + query, json=body)
        got = both_apps(1, "POST", path + query, json=body)
        assert got[0] == ref[0], (body, query)
        if ref[0] in (200, 500):
            assert got[1] == ref[1]
        statuses.append(got[0])
    assert statuses == [200, 200, 200, 404, 400, 422, 422, 422, 404, 500]
    for which in (0, 1):
        assert both_apps(which, "POST", path, data=b"{x", headers={
            "Content-Type": "application/json"})[0] == 422


def test_image_matching_tracked_as_the_jax_app(both_apps, tmp_data_dirs):
    from avede_tpu.utils.metrics import get_monitor as jax_monitor

    from avede_tpu_torch.utils.metrics import get_monitor

    images = tmp_data_dirs / "images"
    images.mkdir(exist_ok=True)
    (images / "img1.png").write_bytes(_png(1))

    def count(which):
        ops = both_apps(which, "GET", "/api/metrics")[1]["operations"]
        return ops.get("image_matching", {}).get("count_total", 0)

    before = [count(0), count(1)]
    for which in (0, 1):
        assert both_apps(which, "POST", "/api/image-matching",
                         data=_image_form({"video_id": "v"}))[0] == 200
        assert both_apps(which, "POST", "/api/image-matching-by-id", json={
            "video_id": "v", "image_id": "img1",
            "matching_mode": "hybrid"})[0] == 200
    assert [count(0) - before[0], count(1) - before[1]] == [2, 2]
    for monitor in (jax_monitor, get_monitor):
        recs = list(monitor()._records["image_matching"])[-2:]
        assert [r["mode"] for r in recs] == ["traditional", "hybrid"]


def test_matching_modes_as_the_jax_app(both_apps, monkeypatch):
    """Each app reads ``MATCHING_THRESHOLDS`` when it answers."""
    from avede_tpu.utils.config import settings as jsettings

    ref, got = (both_apps(w, "GET", "/api/matching-modes") for w in (0, 1))
    assert got[0] == ref[0] == 200 and got[1] == ref[1]
    assert [m["mode"] for m in got[1]["matching_modes"]] \
        == settings.MATCHING_MODES
    for s in (jsettings, settings):
        monkeypatch.setitem(s.MATCHING_THRESHOLDS, "hybrid", 0.42)
    ref, got = (both_apps(w, "GET", "/api/matching-modes") for w in (0, 1))
    assert got[1] == ref[1]
    assert {m["mode"]: m["default_threshold"]
            for m in got[1]["matching_modes"]}["hybrid"] == 0.42


class TestImageMatchingRoute:
    def test_routes_complete_over_a_real_video(self, client, tmp_path):
        """Both routes over a real mp4 with the tiny CLIP on the CPU:
        ``fast_match`` from a multipart image, ``traditional`` by the id
        of an uploaded image, each with its clips cut."""
        import cv2

        video = make_test_video(tmp_path / "src.mp4", n_frames=30)
        vid = _upload(client, video)[1]["video_id"]
        cap = cv2.VideoCapture(video)
        cap.set(cv2.CAP_PROP_POS_FRAMES, 12)
        frame = cap.read()[1]
        cap.release()
        png = cv2.imencode(".png", frame)[1].tobytes()
        status, out = client("POST", "/api/image-matching", data=_image_form(
            {"video_id": vid, "matching_mode": "fast_match", "top_k": "3",
             "similarity_threshold": "-1"}, png))
        assert status == 200 and out["status"] == "completed"
        assert out["total_found"] == len(out["results"]) == 3
        form = FormData()
        form.add_field("file", png, filename="ref.png",
                       content_type="image/png")
        image_id = client("POST", "/api/upload-image", data=form)[1][
            "image_id"]
        status, out = client("POST", "/api/image-matching-by-id", json={
            "video_id": vid, "image_id": image_id, "top_k": 2,
            "similarity_threshold": 0.0})
        assert status == 200 and out["status"] == "completed"
        assert out["metadata"]["matching_mode"] == "traditional"
        assert out["total_found"] == len(out["clips"]) == 2
        assert abs(out["results"][0]["timestamp"] - 12 / 25) < 0.5
        clips = {c["filename"] for c in client("GET", "/api/clips")[1][
            "clips"]}
        assert {r["clip_filename"] for r in out["results"]} <= clips


# ---------------------------------------------------------------------------
# person search, the root and the built-in UI
# ---------------------------------------------------------------------------

_PERSON_BODIES = [
    ({}, 200), ({"similarity_threshold": "0.5"}, 200),
    ({"similarity_threshold": None, "frame_skip": None}, 200),
    ({"frame_skip": "3"}, 200), ({"frame_skip": 4.0}, 200),
    ({"frame_skip": " +2 "}, 200), ({"frame_skip": True}, 200),
    ({"temporal_consistency": "no", "save_annotated_frames": "yes"}, 200),
    ({"temporal_consistency": 0, "save_annotated_frames": 1.0}, 200),
    ({"similarity_threshold": 1, "extra": [1]}, 200),
    ({"frame_skip": "3.5"}, 422), ({"frame_skip": 2.5}, 422),
    ({"similarity_threshold": "abc"}, 422),
    ({"temporal_consistency": "maybe"}, 422),
    ({"save_annotated_frames": None}, 422),
    ({"image_id": None}, 422), ({"video_id": 7}, 422),
    ({"video_id": "missing"}, 404), ({"image_id": "nope"}, 404),
    ({"image_id": "bad"}, 400),
]


@pytest.fixture()
def person_images(tmp_data_dirs):
    images = tmp_data_dirs / "images"
    images.mkdir(exist_ok=True)
    (images / "img1.png").write_bytes(_png(1))
    (images / "bad.png").write_bytes(b"not an image")
    return images


@pytest.mark.parametrize("body,status", _PERSON_BODIES)
def test_person_bodies_parse_as_the_jax_app(both_apps, person_images, body,
                                            status):
    """JSON bodies coerced as pydantic 2's lax mode does; 404 for an
    unknown video or image, 400 for an image that does not decode;
    accepted ones reach the processor with the same arguments and the
    same decoded image."""
    payload = {"video_id": "v", "image_id": "img1", **body}
    ref = both_apps(0, "POST", "/api/enhanced-person-detection",
                    json=payload)
    got = both_apps(1, "POST", "/api/enhanced-person-detection",
                    json=payload)
    assert got[0] == ref[0] == status
    if status == 200:
        assert got[1] == ref[1] and got[1]["call"] == "person"


def test_person_route_refuses_bad_json_as_the_jax_app(both_apps):
    for which in (0, 1):
        path = "/api/enhanced-person-detection"
        assert both_apps(which, "POST", path, data=b"{x", headers={
            "Content-Type": "application/json"})[0] == 422
        assert both_apps(which, "POST", path, json=["v", "img1"])[0] == 422
        assert both_apps(which, "POST", path, json={"video_id": "v"})[0] \
            == 422


def test_person_detection_tracked_as_the_jax_app(both_apps, person_images):
    from avede_tpu.utils.metrics import get_monitor as jax_monitor

    from avede_tpu_torch.utils.metrics import get_monitor

    def count(which):
        ops = both_apps(which, "GET", "/api/metrics")[1]["operations"]
        return ops.get("person_detection", {}).get("count_total", 0)

    before = [count(0), count(1)]
    for which in (0, 1):
        assert both_apps(which, "POST", "/api/enhanced-person-detection",
                         json={"video_id": "v", "image_id": "img1"}
                         )[0] == 200
        assert both_apps(which, "POST", "/api/enhanced-person-detection",
                         json={"video_id": "v", "image_id": "nope"}
                         )[0] == 404
    assert [count(0) - before[0], count(1) - before[1]] == [1, 1]
    for monitor in (jax_monitor, get_monitor):
        assert len(monitor()._records["person_detection"]) >= 1


def test_root_and_ui_as_the_jax_app(both_apps):
    ref, got = (both_apps(w, "GET", "/") for w in (0, 1))
    assert got[0] == ref[0] == 200 and got[1] == ref[1]
    assert "/api/enhanced-person-detection" in got[1]["endpoints"]
    ref, got = (both_apps(w, "GET", "/ui") for w in (0, 1))
    assert got[0] == ref[0] == 200 and got[1] == ref[1]
    assert got[2]["Content-Type"] == ref[2]["Content-Type"]
    assert got[2]["Content-Type"].startswith("text/html")
    assert b"enhanced-person-detection" in got[1]


def test_person_route_completes_over_a_real_video(client, tmp_path):
    """The route over a real mp4 of drawn people with tiny CLIP and YOLO
    on the CPU: an uploaded reference image, every person box a match
    at threshold 0."""
    import cv2

    from avede_tpu_torch.models.yolo import tiny_yolo_config
    from avede_tpu_torch.services.detector import YoloService
    from avede_tpu_torch.services.person_detector import (
        PersonDetector, PersonSearchService)
    from avede_tpu_torch.utils.synthetic import (draw_people, draw_person,
                                                 make_identity)

    proc = client.processor
    proc._person = PersonSearchService(proc.engine, detector=PersonDetector(
        proc.engine, yolo=YoloService(cfg=tiny_yolo_config(),
                                      device="cpu")))
    rng = np.random.default_rng(0)
    ids = [make_identity(rng) for _ in range(2)]
    video = str(tmp_path / "people.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                             (128, 96))
    for _ in range(20):
        frame, _ = draw_people(ids, rng, frame_hw=(96, 128),
                               person_h_range=(40, 60))
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    vid = _upload(client, video)[1]["video_id"]
    ref, _ = draw_person(ids[0], rng, frame_hw=(96, 64))
    form = FormData()
    form.add_field("file", cv2.imencode(".png", ref[..., ::-1])[1].tobytes(),
                   filename="ref.png", content_type="image/png")
    image_id = client("POST", "/api/upload-image", data=form)[1]["image_id"]
    status, out = client("POST", "/api/enhanced-person-detection", json={
        "video_id": vid, "image_id": image_id, "similarity_threshold": 0,
        "frame_skip": "4", "temporal_consistency": False})
    assert status == 200 and out["status"] == "completed"
    assert out["summary"]["frames_processed"] == 5
    assert out["total_found"] == len(out["matches"]) > 0
    for m in out["matches"]:
        assert m["detection_method"] == "yolo" and 0 <= m["similarity"] <= 1

