"""The ported image-query slice against the JAX package: the pHash of
``native/hostops``, the cross-domain matcher, the batching executor,
``ImageMatcher`` in its six modes, ``Phase4ImageMatching`` and
``VideoProcessor.process_image_matching``, on the same tiny CLIP and YOLO
weights (carried across with ``params_from_jax``) over a real mp4.

Tolerances: the pHash bit for bit; the cross-domain features within
1e-6; matches the same frames in the same order, similarities, quality
scores and every ``breakdown`` value within 1e-4. Exceptions, each for a
near tie the two packages' last-ulp differences may break either way:
matches whose similarities lie within 1e-5 of each other may swap; a
match within 1e-5 of the threshold may be kept by one package only and
is left out on both sides; where an ``object_focused`` match's best crop
ties (within 1e-5) with another crop of its frame, its box, class and
detector confidence may be any of the tied detections (tiny YOLO's boxes
cover the whole 96×64 frame, so most crops are the same image).
"""

import threading
import time

import cv2
import jax
import numpy as np
import pytest
import torch

from avede_tpu_torch.utils.config import settings as tsettings
from tests.conftest import make_test_video
from tests.test_torch_detection import (  # noqa: F401 — port_dirs: fixture
    _filled, _nms_per_class_left_of_zero, _np, _yolo_variables, port_dirs)

TOL = 1e-4
TIE = 1e-5
MODES = ["fast_match", "traditional", "cross_domain", "object_focused",
         "hybrid", "smart_match"]


# ---------------------------------------------------------------------------
# pHash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 288, 512), (6, 1080, 1920),
                                   (30, 100, 130), (30, 7, 9)])
def test_phash_matches_native_hostops(shape):
    """Seeded noise, flat frames whose cells all sit within one level of
    their mean, and seeded gradients, against the JAX package's C++
    library."""
    from avede_tpu.native import hostops as jhostops

    from avede_tpu_torch.ops import hostops

    assert jhostops.available(), "the C++ host library did not build"
    rng = np.random.default_rng(shape[1])
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    flat = np.full(shape, 128, np.uint8)
    flat[:, ::2] = 129
    n, h, w = shape
    slope = rng.uniform(-2, 2, (n, 2, 1, 1))
    grad = np.clip(128 + slope[:, 0] * np.arange(h)[:, None] * 256 / h
                   + slope[:, 1] * np.arange(w)[None, :] * 256 / w,
                   0, 255).astype(np.uint8)
    for gray in (noise, flat, grad):
        got, ref = hostops.phash_batch(gray), jhostops.phash_batch(gray)
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, ref)
        for q in (int(ref[0]), int(ref[-1]) ^ 0xF0F0):
            np.testing.assert_array_equal(hostops.hamming_batch(q, got),
                                          jhostops.hamming_batch(q, ref))


# ---------------------------------------------------------------------------
# cross-domain matcher
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
    noisy = np.clip(base.astype(int) + rng.integers(-10, 10, base.shape),
                    0, 255).astype(np.uint8)
    other = rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)
    gray = cv2.cvtColor(cv2.cvtColor(base, cv2.COLOR_RGB2GRAY),
                        cv2.COLOR_GRAY2RGB)
    return base, noisy, other, gray


def test_cross_domain_matches_jax(imgs):
    from avede_tpu.services.cross_domain_matcher import \
        CrossDomainMatcher as JMatcher

    from avede_tpu_torch.services.cross_domain_matcher import \
        CrossDomainMatcher

    base, noisy, other, gray = imgs
    jm, tm = JMatcher(), CrossDomainMatcher()
    for a, b in ((base, noisy), (base, other), (base, gray),
                 (gray[..., 0], noisy)):
        ref, got = jm.compute_similarity(a, b), tm.compute_similarity(a, b)
        assert set(got) == set(ref)
        for k in ref:
            assert abs(got[k] - ref[k]) <= 1e-6, k
    frames = np.stack([other, noisy, gray, base])
    for thr in (0.0, 0.5):
        ref = jm.match_against_frames(base, frames, threshold=thr)
        got = tm.match_against_frames(base, frames, threshold=thr)
        assert [h["frame_index"] for h in got] \
            == [h["frame_index"] for h in ref]
        for g, r in zip(got, ref):
            assert abs(g["similarity"] - r["similarity"]) <= 1e-6
            assert g["breakdown"].keys() == r["breakdown"].keys()
            for k in r["breakdown"]:
                assert abs(g["breakdown"][k] - r["breakdown"][k]) <= 1e-6


# ---------------------------------------------------------------------------
# batching executor
# ---------------------------------------------------------------------------

def _rows_fn(calls):
    """A batched function: row i → [sum of row i, batch size], after a
    short sleep so that concurrent requests pile up."""
    def fn(batch):
        calls.append(len(batch))
        time.sleep(0.02)
        flat = batch.reshape(len(batch), -1).double()
        return np.stack([flat.sum(1).numpy(),
                         np.full(len(batch), float(len(batch)))], 1)
    return fn


def _threads(n, target):
    ts = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)


def test_executor_coalesces_and_scatters():
    from avede_tpu_torch.parallel.scheduler import BatchingExecutor

    calls = []
    ex = BatchingExecutor(_rows_fn(calls), max_batch=1000, max_wait_ms=50)
    rng = np.random.default_rng(0)
    items = [torch.from_numpy(rng.standard_normal((int(n), 3, 2)))
             for n in rng.integers(1, 9, 8)]
    out, start = [None] * 8, threading.Barrier(8)

    def work(i):
        start.wait()
        out[i] = ex.submit(items[i]).result(timeout=30)

    _threads(8, work)
    stats = ex.stats
    assert stats["requests"] == 8 and stats["items"] == sum(map(len, items))
    assert stats["batches"] < stats["requests"] and sum(calls) == \
        stats["items"]
    for got, x in zip(out, items):
        assert got.shape == (len(x), 2)
        np.testing.assert_allclose(got[:, 0], x.reshape(len(x), -1).sum(1))
    # a lone request, and __call__, equal the direct call's rows
    direct = _rows_fn([])(items[0])
    np.testing.assert_array_equal(ex(items[0]), direct)
    ex.close()
    assert not ex._thread.is_alive()


def test_executor_delivers_exception_to_every_waiter():
    from avede_tpu_torch.parallel.scheduler import BatchingExecutor

    def boom(batch):
        time.sleep(0.02)
        raise RuntimeError(f"bad batch of {len(batch)}")

    ex = BatchingExecutor(boom, max_batch=1000, max_wait_ms=50)
    errors, start = [None] * 8, threading.Barrier(8)

    def work(i):
        start.wait()
        try:
            ex.submit(torch.zeros(2, 3)).result(timeout=30)
        except RuntimeError as exc:
            errors[i] = str(exc)

    _threads(8, work)
    assert all(e and e.startswith("bad batch of") for e in errors)
    # the thread survives a failed batch
    with pytest.raises(RuntimeError, match="bad batch of 1"):
        ex(torch.zeros(1, 3))
    ex.close()
    assert not ex._thread.is_alive()


def test_embed_images_through_executor_equals_direct(monkeypatch):
    """``embed_images`` goes through the engine's executor (built once);
    concurrent callers get their own rows; with the executor off the
    engine embeds directly, with the same rows."""
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine

    eng = ClipEngine(cfg=tiny_test_config(), device="cpu")
    rng = np.random.default_rng(1)
    crops = [[rng.integers(0, 255, (int(h), int(w), 3), dtype=np.uint8)
              for h, w in rng.integers(8, 40, (int(n), 2))]
             for n in rng.integers(1, 6, 8)]
    out = [None] * 8

    def work(i):
        out[i] = eng.embed_images(crops[i])

    _threads(8, work)
    batcher = eng._batcher
    assert batcher is not None and batcher.stats["requests"] == 8
    monkeypatch.setattr(tsettings, "BATCHING_EXECUTOR_ENABLED", False)
    for got, c in zip(out, crops):
        np.testing.assert_allclose(got, eng.embed_images(c), atol=1e-5)
    assert eng._batcher is batcher and batcher.stats["requests"] == 8


# ---------------------------------------------------------------------------
# ImageMatcher and phase 4, through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    from avede_tpu.models.clip import init_clip, tiny_test_config
    from avede_tpu.models.yolo import tiny_yolo_config

    from avede_tpu_torch.models.convert import params_from_jax

    clip = _filled(lambda: init_clip(tiny_test_config(), seed=0)[1])
    _, yolo = _yolo_variables(tiny_yolo_config())
    return {name: (tree, params_from_jax(_np(tree)))
            for name, tree in (("clip", clip), ("yolo", yolo))}


@pytest.fixture(scope="module")
def matchers(weights, tmp_path_factory):
    """(JAX, port) ``ImageMatcher``s with their own embedding caches. The
    JAX ``YoloService`` takes the port's NMS semantics for boxes left of
    x = 0, which tiny YOLO's boxes cross (``tests/test_torch_detection.py``,
    ROADMAP Queue 3)."""
    from avede_tpu.io.embedding_cache import EmbeddingCache as JCache
    from avede_tpu.models.clip import tiny_test_config as jclip
    from avede_tpu.models.yolo import tiny_yolo_config as jyolo
    from avede_tpu.parallel.embed import ClipEngine as JEngine
    from avede_tpu.parallel.mesh import build_mesh
    from avede_tpu.services import detector as jdetector
    from avede_tpu.services.image_matcher import ImageMatcher as JMatcher

    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.models.yolo import tiny_yolo_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.detector import YoloService
    from avede_tpu_torch.services.image_matcher import ImageMatcher

    root = tmp_path_factory.mktemp("image_matching")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdetector, "nms_per_class", _nms_per_class_left_of_zero)
        jeng = JEngine(cfg=jclip(), params=weights["clip"][0],
                       mesh=build_mesh(jax.devices()[:1]))
        jm = JMatcher(jeng, yolo=jdetector.YoloService(
            cfg=jyolo(), variables=weights["yolo"][0]),
            cache=JCache(str(root / "jax")))
        teng = ClipEngine(cfg=tiny_test_config(),
                          state_dict=weights["clip"][1], device="cpu")
        tm = ImageMatcher(teng, yolo=YoloService(
            cfg=tiny_yolo_config(), state_dict=weights["yolo"][1],
            device="cpu"), cache=EmbeddingCache(str(root / "port")))
        yield jm, tm


@pytest.fixture(scope="module")
def video_and_refs(tmp_path_factory):
    """The mp4 and references: frame 37 (its white square makes
    ``smart_match`` take the complex-background branch), frame 37 in
    grayscale (the grayscale branch) and a flat colour with seeded noise
    (the default branch)."""
    path = make_test_video(tmp_path_factory.mktemp("v") / "vid.mp4")
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, 37)
    ok, frame = cap.read()
    cap.release()
    assert ok
    ref = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    gray = cv2.cvtColor(cv2.cvtColor(ref, cv2.COLOR_RGB2GRAY),
                        cv2.COLOR_GRAY2RGB)
    flat = np.clip(np.array([90, 40, 30]) + np.random.default_rng(3).integers(
        -8, 8, (64, 96, 3)), 0, 255).astype(np.uint8)
    return path, {"frame37": ref, "gray": gray, "flat": flat}


@pytest.fixture(scope="module")
def object_choices(matchers, video_and_refs):
    """Per reference and frame, the JAX detections whose crop ties the
    best crop's similarity within TIE: (class, confidence, box) each."""
    from avede_tpu.services.detector import extract_object_embeddings

    jm = matchers[0]
    path, refs = video_and_refs
    frames, _ = jm.reader.extract_frames(path)
    dets = jm.yolo.detect(frames, conf_threshold=0.25)
    out = {}
    for name, ref in refs.items():
        ref_emb = jm.engine.embed_images([ref])[0]
        out[name] = {}
        for i, d in enumerate(dets):
            if d:
                sims = extract_object_embeddings(
                    jm.engine, frames[i], [x["bbox"] for x in d]) @ ref_emb
                out[name][i] = [(x["class_name"], x["confidence"], x["bbox"])
                                for x, s in zip(d, sims)
                                if s >= sims.max() - TIE]
    return out


def _same_object(got, choices) -> bool:
    return any(cls == got["object_class"]
               and abs(conf - got["breakdown"]["detector_conf"]) <= TOL
               and max(abs(a - b) for a, b in zip(box, got["bbox"])) <= 1e-3
               for cls, conf, box in choices)


def _same_match(got, want, choices) -> bool:
    if set(got) != set(want):
        return False
    obj = "object_class" in want
    for key, w in want.items():
        g = got[key]
        if key in ("bbox", "object_class") and obj:
            continue
        if key == "breakdown":
            if set(g) != set(w) or any(
                    abs(g[k] - w[k]) > TOL for k in w
                    if not (obj and k == "detector_conf")):
                return False
        elif key == "image_characteristics":
            if set(g) != set(w) or any(abs(g[k] - w[k]) > TOL for k in w):
                return False
        elif key == "clip_filename":
            continue
        elif isinstance(w, float):
            if abs(g - w) > TOL:
                return False
        elif g != w:
            return False
    return not obj or _same_object(got, choices.get(want["frame_index"], []))


def assert_same_matches(got, ref, threshold, choices):
    """Same matches in the same order, but for the near ties of the
    module docstring."""
    near = {m["frame_index"] for m in got + ref
            if abs(m["similarity"] - threshold) <= TIE}
    ids = [{m["frame_index"] for m in res} for res in (got, ref)]
    drop = near & (ids[0] ^ ids[1])
    got = [m for m in got if m["frame_index"] not in drop]
    ref = [m for m in ref if m["frame_index"] not in drop]
    assert len(got) == len(ref)
    for res in (got, ref):
        sims = [m["similarity"] for m in res]
        assert sims == sorted(sims, reverse=True)
    pos = 0
    while pos < len(ref):
        end = pos + 1
        while end < len(ref) and \
                ref[end - 1]["similarity"] - ref[end]["similarity"] <= TIE:
            end += 1
        mine = list(got[pos:end])
        for want in ref[pos:end]:
            hit = next((i for i, g in enumerate(mine)
                        if _same_match(g, want, choices)), None)
            assert hit is not None, f"no match for {want} in {mine}"
            mine.pop(hit)
        pos = end


@pytest.mark.parametrize("mode,ref_name", [
    *((m, "frame37") for m in MODES), ("smart_match", "gray"),
    ("smart_match", "flat")])
def test_match_image_to_video_matches_jax(matchers, video_and_refs,
                                          object_choices, mode, ref_name):
    """Threshold 0, then the median similarity of the JAX package's
    matches at 0, which gates the single-method modes (the ensembles'
    fused scores can rise with the threshold: their methods' own gates
    drop the weaker agreeing scores from a frame's mean). Every sampled
    frame is kept (top_k 100)."""
    jm, tm = matchers
    path, refs = video_and_refs
    ref_img = refs[ref_name]
    thr = 0.0
    for _ in range(2):
        kw = dict(mode=mode, threshold=thr, top_k=100, video_id="vid")
        want = jm.match_image_to_video(path, ref_img, **kw)
        got = tm.match_image_to_video(path, ref_img, **kw)
        assert want, f"{mode}: nothing to compare at threshold {thr}"
        assert_same_matches(got, want, thr, object_choices[ref_name])
        if mode == "smart_match":
            chars = want[0]["image_characteristics"]
            branch = ("grayscale" if chars["is_grayscale"] > 0.5 else
                      "complex" if chars["background_complexity"] > 0.5
                      else "default")
            assert branch == {"frame37": "complex", "gray": "grayscale",
                              "flat": "default"}[ref_name]
        if thr == 0.0:
            at_zero = [m["similarity"] for m in want]
        thr = float(np.median(at_zero))
    assert len(want) < len(at_zero) or mode in ("hybrid", "smart_match")
    runs = tm.stats["matches_run"]
    again = tm.match_image_to_video(path, ref_img, **kw)
    assert tm.stats["matches_run"] == runs and again == got


def test_unknown_mode_and_result_key(matchers, video_and_refs):
    jm, tm = matchers
    path, refs = video_and_refs
    for m in (jm, tm):
        with pytest.raises(ValueError, match="unknown matching mode"):
            m.match_image_to_video(path, refs["frame37"], mode="nope")
    img = refs["frame37"]
    assert tm._result_key("v", img, "hybrid", 0.5) \
        == jm._result_key("v", img, "hybrid", 0.5)
    assert tm.yolo is tm._yolo


def test_phase4_matches_jax(matchers, video_and_refs, tmp_path):
    from avede_tpu.io.clip_writer import ClipWriter as JWriter
    from avede_tpu.pipelines.phase4 import Phase4ImageMatching as JPhase4

    from avede_tpu_torch.io.clip_writer import ClipWriter
    from avede_tpu_torch.pipelines.phase4 import Phase4ImageMatching

    jm, tm = matchers
    path, refs = video_and_refs
    jp = JPhase4(jm.engine, matcher=jm,
                 clip_writer=JWriter(str(tmp_path / "jclips")))
    tp = Phase4ImageMatching(tm.engine, matcher=tm,
                             clip_writer=ClipWriter(str(tmp_path / "clips")))
    kw = dict(matching_mode="traditional", similarity_threshold=0.9,
              top_k=4, video_id="vid")
    want = jp.process_image_query(path, refs["frame37"], **kw)
    got = tp.process_image_query(path, refs["frame37"], **kw)
    assert set(got) == set(want)
    assert got["metadata"] == want["metadata"]
    assert got["total_found"] == want["total_found"] == len(got["results"])
    assert set(got["performance"]) == set(want["performance"])
    assert_same_matches(got["results"], want["results"], 0.9, {})
    assert got["results"] and len(got["clips"]) == len(got["results"])
    for m, clip in zip(got["results"], got["clips"]):
        assert 0.0 <= m["quality_score"] <= 1.0
        assert m["phase"] == "phase4_image_matching"
        assert m["clip_filename"] == clip["clip_filename"]
        cap = cv2.VideoCapture(clip["clip_path"])
        assert cap.read()[0]
        cap.release()
        assert set(clip) == set(want["clips"][0])
    # default threshold from MATCHING_THRESHOLDS, batch and mode comparison
    want = jp.process_image_query(path, refs["gray"], video_id="vid",
                                  matching_mode="fast_match",
                                  extract_clips=False)
    got = tp.process_image_query(path, refs["gray"], video_id="vid",
                                 matching_mode="fast_match",
                                 extract_clips=False)
    assert got["metadata"] == want["metadata"] and got["clips"] == []
    assert_same_matches(got["results"], want["results"], 0.75, {})
    batch = tp.process_batch(path, [refs["frame37"], refs["gray"]],
                             matching_mode="fast_match",
                             similarity_threshold=0.0, video_id="vid")
    assert [b["clips"] for b in batch] == [[], []]
    assert [b["total_found"] for b in batch] == [15, 15]
    cmp_want = jp.compare_modes(path, refs["frame37"],
                                modes=["fast_match", "traditional"],
                                video_id="vid")
    cmp_got = tp.compare_modes(path, refs["frame37"],
                               modes=["fast_match", "traditional"],
                               video_id="vid")
    assert set(cmp_got) == set(cmp_want)
    for mode, w in cmp_want.items():
        assert cmp_got[mode]["total_found"] == w["total_found"]
        assert abs(cmp_got[mode]["best_similarity"]
                   - w["best_similarity"]) <= TOL
    assert tp.stats["by_mode"].keys() == jp.stats["by_mode"].keys()


def test_process_image_matching_envelope_matches_jax(matchers, video_and_refs,
                                                     tmp_data_dirs,
                                                     port_dirs):
    from avede_tpu.services.video_processor import VideoProcessor as JProc

    from avede_tpu_torch.services.video_processor import VideoProcessor

    jm, tm = matchers
    path, refs = video_and_refs
    jproc, tproc = JProc(engine=jm.engine), VideoProcessor(engine=tm.engine)
    envs = [p.process_image_matching(path, refs["frame37"],
                                     matching_mode="bogus")
            for p in (jproc, tproc)]
    for env in envs:
        env.pop("task_id"), env.pop("timestamp", None)
    assert envs[1] == envs[0] and envs[1]["status"] == "error"
    assert "unknown matching mode" in envs[1]["error"]
    envs = [p.process_image_matching(str(port_dirs / "none.mp4"),
                                     refs["frame37"]) for p in (jproc, tproc)]
    assert envs[1]["status"] == envs[0]["status"] == "error"
    assert envs[1]["error_code"] == envs[0]["error_code"]


def test_image_query_upgrades_the_scans_sparse_entry(weights, video_and_refs,
                                                     port_dirs):
    """The facade's image query shares phase 1's cache instance under the
    same table tag: after a cold ``mvp`` scan (a sparse entry), a
    ``fast_match`` embeds only the missing rows and leaves the entry
    complete, the scan's rows unchanged."""
    import shutil

    from avede_tpu_torch.io.embedding_cache import table_tag
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.video_processor import VideoProcessor

    path, refs = video_and_refs
    video = shutil.copy(path, port_dirs / "videos" / "v.mp4")
    proc = VideoProcessor(engine=ClipEngine(
        cfg=tiny_test_config(), state_dict=weights["clip"][1], device="cpu"))
    matcher = proc.image_matching.matcher
    assert matcher.cache is proc.phase1.cache
    out = proc.process_query(video, "white square", threshold=-1.0,
                             extract_clips=False, video_id="v")
    assert out["status"] == "completed"
    tag = table_tag(proc.engine.model_tag)
    rate = matcher.reader.sample_rate
    sparse, _, valid = proc.phase1.cache.get_entry("v", tag, rate)
    assert valid is not None and 0 < valid.sum() < len(valid)
    embedded = []
    embed_frames = proc.engine.embed_frames
    proc.engine.embed_frames = lambda f: embedded.append(len(f)) \
        or embed_frames(f)
    out = proc.process_image_matching(video, refs["frame37"],
                                      matching_mode="fast_match",
                                      similarity_threshold=0.0,
                                      extract_clips=False, video_id="v")
    assert out["status"] == "completed" and out["total_found"] == 15
    assert embedded == [int((~valid).sum())]
    table, _, now_valid = proc.phase1.cache.get_entry("v", tag, rate)
    assert now_valid is None
    np.testing.assert_array_equal(table[valid], sparse[valid])
