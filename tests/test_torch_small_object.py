"""The ported small-object and background-independence slice against the
JAX package: tiling, the classical image features, region proposals,
GrabCut masks and shape descriptors, the background-independent
features (with and without EfficientNet-B0, whose model is
``tests/test_torch_effnet.py``'s), ``SmallObjectService.detect_in_video``,
``BackgroundIndependentService.match_in_video`` and both
``VideoProcessor`` entry points, on the same tiny weights (carried
across with ``params_from_jax``) and the same small inputs.

Tolerances: tiling exact; image features within 1e-12 (exact where
they are integers); proposals the same boxes, types and flags, scores
within 1e-12; GrabCut masks equal with cv2's RNG seeded before each
side (its GMM initialisation draws from it), descriptors within 1e-12;
background-independent features within 1e-5; detections the same, in
the same order, boxes within 1e-3 px, confidences within 1e-4.
"""

import cv2
import numpy as np
import pytest

from avede_tpu_torch.utils.config import settings as tsettings
from tests.conftest import make_test_video
from tests.test_torch_detection import (_detectors, _filled, _np,
                                        _owl_params, _yolo_variables,
                                        assert_same_detections)
from tests.test_torch_effnet import _effnet_variables

EXACT = 1e-12
FEAT_TOL = 1e-5
QUERIES = ["a white square", "grass"]
TILE, OVERLAP = 64, 16
VIDEO_SIZE = (160, 96)           # 3 × 2 tiles of 64 px at overlap 16


def _same(got, ref, tol: float = EXACT) -> None:
    """Equal structure; floats within ``tol``, everything else exact."""
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _same(got[k], ref[k], tol)
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _same(g, r, tol)
    elif isinstance(ref, np.ndarray) and ref.dtype.kind in "fc":
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.abs(got - ref).max(initial=0.0) <= tol
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    elif isinstance(ref, float):
        assert abs(got - ref) <= tol
    else:
        assert got == ref


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,tile,overlap", [
    (96, 160, 64, 16), (1080, 1920, 640, 128), (40, 50, 64, 16),
    (30, 100, 64, 8), (64, 200, 64, 0), (100, 64, 64, 0)])
def test_tiling_matches_jax(h, w, tile, overlap):
    from avede_tpu.ops import tiling as jtiling

    from avede_tpu_torch.ops import tiling

    rng = np.random.default_rng(h * w)
    assert tiling.tile_grid(h, w, tile, overlap) \
        == jtiling.tile_grid(h, w, tile, overlap)
    frame = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    got, got_off = tiling.tile_frame(frame, tile, overlap)
    ref, ref_off = jtiling.tile_frame(frame, tile, overlap)
    assert got_off == ref_off
    np.testing.assert_array_equal(got, ref)
    assert got.shape[1:] == (tile, tile, 3)
    boxes = rng.uniform(0, tile, (len(got_off), 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(tiling.untile_boxes(boxes, got_off),
                                  jtiling.untile_boxes(boxes, ref_off))


# ---------------------------------------------------------------------------
# classical image features
# ---------------------------------------------------------------------------

def _scene(shift: int = 0, seed: int = 0) -> np.ndarray:
    """RGB 96 × 128: a noisy gradient with a disc, a square and a
    triangle, all moved right by ``shift`` px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:96, 0:128]
    img = np.stack([40 + xx, 60 + yy, 120 + 0 * xx], -1).astype(np.float64)
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    cv2.circle(img, (30 + shift, 40), 14, (220, 40, 40), -1)
    cv2.rectangle(img, (60 + shift, 20), (84 + shift, 44), (30, 200, 60), -1)
    tri = np.array([[90 + shift, 80], [120 + shift, 80], [105 + shift, 55]])
    cv2.fillPoly(img, [tri.astype(np.int32)], (250, 250, 30))
    return img


def _images():
    noise = np.random.default_rng(7).integers(0, 255, (96, 128, 3),
                                              dtype=np.uint8)
    return noise, _scene(), _scene(shift=3, seed=1)


FEATURES = {
    "gray": lambda F, a, b, c: (F._gray(b), F._gray(F._gray(c))),
    "perceptual_hash": lambda F, a, b, c: F.perceptual_hash(b),
    "hamming_distance": lambda F, a, b, c: F.hamming_distance(
        F.perceptual_hash(a), F.perceptual_hash(c)),
    "phash_batch": lambda F, a, b, c: F.phash_batch(np.stack([a, b, c])),
    "hamming_batch": lambda F, a, b, c: F.hamming_batch(
        F.perceptual_hash(b), F.phash_batch(np.stack([a, b, c]))),
    "hsv_histogram": lambda F, a, b, c: (F.hsv_histogram(b),
                                         F.hsv_histogram(a, (4, 6, 5))),
    "histogram_correlation": lambda F, a, b, c: F.histogram_correlation(
        F.hsv_histogram(b), F.hsv_histogram(c)),
    "ssim": lambda F, a, b, c: (F.ssim(b, c), F.ssim(a, c[:48, :64])),
    "orb_match_score": lambda F, a, b, c: (F.orb_match_score(b, c),
                                           F.orb_match_score(a, b)),
    "hu_moments": lambda F, a, b, c: F.hu_moments(b),
    "lbp_histogram": lambda F, a, b, c: F.lbp_histogram(c),
    "hog_features": lambda F, a, b, c: (F.hog_features(b),
                                        F.hog_features(a, (32, 32))),
    "edge_stats": lambda F, a, b, c: F.edge_stats(b),
    "texture_stats": lambda F, a, b, c: F.texture_stats(c),
    "cosine_sim": lambda F, a, b, c: (
        F.cosine_sim(F.hu_moments(b), F.hu_moments(c)),
        F.cosine_sim(np.zeros(3), np.ones(3))),
    "analyze_image": lambda F, a, b, c: (F.analyze_image(b),
                                         F.analyze_image(F._gray(a))),
}


@pytest.mark.parametrize("name", sorted(FEATURES))
def test_image_feats_match_jax(name):
    from avede_tpu.ops import image_feats as jfeats

    from avede_tpu_torch.ops import image_feats

    images = _images()
    got = FEATURES[name](image_feats, *images)
    ref = FEATURES[name](jfeats, *images)
    _same(got, ref)
    if name == "orb_match_score":
        assert ref[0][1] > 0                 # the shifted scene matches


# ---------------------------------------------------------------------------
# region proposals, GrabCut, shape descriptors
# ---------------------------------------------------------------------------

def test_region_proposals_match_jax():
    """Three consecutive frames: saliency and edges on each, motion and
    the temporal boost from the second on; then a reset."""
    from avede_tpu.services.region_proposals import \
        RegionProposalService as JRps

    from avede_tpu_torch.services.region_proposals import \
        RegionProposalService

    jrps, trps = JRps(), RegionProposalService()
    frames = [_scene(shift=4 * i, seed=i) for i in range(3)]
    kinds, boosted = set(), 0
    for frame in frames + frames[:1]:
        ref = jrps.generate_proposals(frame)
        got = trps.generate_proposals(frame)
        _same(got, ref)
        kinds |= {p["type"] for p in ref}
        boosted += sum(bool(p.get("temporally_consistent")) for p in ref)
        if frame is frames[-1]:
            jrps.reset(), trps.reset()
    assert kinds == {"saliency", "motion", "edge"} and boosted > 0
    assert len(trps.generate_proposals(frames[0][..., 0])) > 0  # gray


@pytest.mark.parametrize("bbox", [[14, 24, 48, 58], [56, 14, 92, 50],
                                  [-6, -3, 50, 60], [85, 50, 140, 99],
                                  [10, 10, 13, 40]])
def test_grabcut_and_shape_descriptor_match_jax(bbox):
    from avede_tpu.services import background_independent as jbg

    from avede_tpu_torch.services import background_independent as bg

    image = _scene()
    cv2.setRNGSeed(0)
    ref = jbg.grabcut_mask(image, bbox)
    cv2.setRNGSeed(0)
    got = bg.grabcut_mask(image, bbox)
    if ref is None:                      # a box under 4 px a side
        assert got is None and bbox[2] - bbox[0] < 4
        return
    np.testing.assert_array_equal(got, ref)
    assert got.any() and not got.all()
    _same(bg.shape_descriptor(got), jbg.shape_descriptor(ref))
    _same(bg.shape_descriptor(np.zeros((8, 8), bool)),
          jbg.shape_descriptor(np.zeros((8, 8), bool)))


# ---------------------------------------------------------------------------
# background-independent features and the two services, both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    from avede_tpu.models.clip import init_clip, tiny_test_config
    from avede_tpu.models.effnet import tiny_effnet_config
    from avede_tpu.models.owlvit import tiny_owlvit_config
    from avede_tpu.models.yolo import tiny_yolo_config

    from avede_tpu_torch.models.convert import params_from_jax

    clip = _filled(lambda: init_clip(tiny_test_config(), seed=0)[1])
    owl = _owl_params(tiny_owlvit_config())
    _, yolo = _yolo_variables(tiny_yolo_config())
    _, eff = _effnet_variables(tiny_effnet_config(), 64)
    return {name: (tree, params_from_jax(_np(tree)))
            for name, tree in (("clip", clip), ("owl", owl),
                               ("yolo", yolo), ("effnet", eff))}


@pytest.fixture(scope="module")
def detectors(weights):
    return _detectors(weights)


def _extractors(weights):
    """(JAX, port) tiny EfficientNet extractors at 64 px."""
    from avede_tpu.models.effnet import tiny_effnet_config as jtiny
    from avede_tpu.services.background_independent import \
        EffNetExtractor as JExtractor

    from avede_tpu_torch.models.effnet import tiny_effnet_config
    from avede_tpu_torch.services.background_independent import \
        EffNetExtractor

    return (JExtractor(variables=weights["effnet"][0], cfg=jtiny(),
                       image_size=64),
            EffNetExtractor(state_dict=weights["effnet"][1],
                            cfg=tiny_effnet_config(), image_size=64,
                            device="cpu"))


@pytest.mark.parametrize("with_effnet", [False, True])
def test_extract_features_and_similarity_match_jax(detectors, weights,
                                                   with_effnet):
    from avede_tpu.services.background_independent import \
        BackgroundIndependentService as JBg

    from avede_tpu_torch.services.background_independent import \
        BackgroundIndependentService

    jdet, tdet = detectors
    jeff, teff = _extractors(weights) if with_effnet else (None, None)
    jbg, tbg = JBg(jdet.engine, effnet=jeff), \
        BackgroundIndependentService(tdet.engine, effnet=teff)
    assert (tbg.effnet is None) == (not with_effnet)
    feats = []
    for image, bbox, strength in ((_scene(), [14, 24, 48, 58], 0.8),
                                  (_scene(3, 1), [58, 14, 90, 50], 0.5),
                                  (_scene(3, 1), [-6, 60, 40, 99], 1.0),
                                  (_scene(), [10, 10, 13, 40], 0.8)):
        cv2.setRNGSeed(0)
        ref = jbg.extract_features(image, bbox, removal_strength=strength)
        cv2.setRNGSeed(0)
        got = tbg.extract_features(image, bbox, removal_strength=strength)
        if ref is None:
            assert got is None
            continue
        assert ("effnet" in got) == with_effnet
        _same(got, ref, FEAT_TOL)
        feats.append((got, ref))
    assert len(feats) == 3
    for (ga, ra) in feats:
        for (gb, rb) in feats:
            assert abs(BackgroundIndependentService.feature_similarity(ga, gb)
                       - JBg.feature_similarity(ra, rb)) <= FEAT_TOL


def _same_result(got, ref, stats_key: str) -> None:
    """Two services' answers: everything but the wall time equal, the
    detections as ``assert_same_detections`` holds them."""
    got, ref = dict(got), dict(ref)
    gs, rs = dict(got.pop(stats_key)), dict(ref.pop(stats_key))
    gs.pop("processing_time"), rs.pop("processing_time")
    assert gs == rs
    got.pop("task_id", None), ref.pop("task_id", None)
    gres, rres = got.pop("results"), ref.pop("results")
    assert got == ref
    assert len(rres) > 0, "no detections to compare"
    conf = [r["confidence"] for r in gres]
    assert conf == sorted(conf, reverse=True)
    assert_same_detections(gres, rres)


def _services(detectors, tile=TILE, overlap=OVERLAP):
    from avede_tpu.services.small_object import SmallObjectService as JSo

    from avede_tpu_torch.services.small_object import SmallObjectService

    jdet, tdet = detectors
    return (JSo(jdet.engine, detector=jdet, tile=tile, overlap=overlap),
            SmallObjectService(tdet.engine, detector=tdet, tile=tile,
                               overlap=overlap))


@pytest.fixture(scope="module")
def small_video(tmp_path_factory):
    return make_test_video(tmp_path_factory.mktemp("so") / "so.mp4",
                           n_frames=6, size=VIDEO_SIZE)


@pytest.mark.parametrize("mode,thr", [("clip", 0.0), ("owlvit", 0.5)])
@pytest.mark.parametrize("background", [False, True])
def test_detect_in_video_matches_jax(detectors, small_video, mode, thr,
                                     background):
    """Tiles of 64 px at overlap 16 (3 × 2 a frame) through the CLIP grid
    or OWL-ViT, region proposals, adaptive thresholds and the merge;
    background-independent re-scoring on or off."""
    jso, tso = _services(detectors)
    kw = dict(detection_mode=mode, confidence_threshold=thr,
              min_object_size=4, top_k=12,
              enable_background_independence=background)
    cv2.setRNGSeed(0)
    ref = jso.detect_in_video(small_video, QUERIES, **kw)
    cv2.setRNGSeed(0)
    got = tso.detect_in_video(small_video, QUERIES, **kw)
    _same_result(got, ref, "enhancement_stats")
    stats = got["enhancement_stats"]
    assert stats["tiles_processed"] == 6 * 6
    assert (stats["bg_features"] > 0) == background
    assert all(4 <= r["object_size"] <= 128 for r in got["results"])


def test_detect_in_frame_without_overlap_matches_jax(detectors):
    """``overlap=0`` and a frame smaller than a tile (zero-padded), no
    proposals, no adaptive thresholds."""
    jso, tso = _services(detectors, tile=TILE, overlap=0)
    frame = _scene()[:50, :100]
    for kw in (dict(enable_rpn=False, enable_adaptive_thresholds=False),
               dict(enable_rpn=True)):
        ref = jso.detect_in_frame(frame, QUERIES, conf_threshold=0.2,
                                  detection_mode="owlvit", **kw)
        got = tso.detect_in_frame(frame, QUERIES, conf_threshold=0.2,
                                  detection_mode="owlvit", **kw)
        assert len(ref) > 0
        assert_same_detections(got, ref)


def test_match_in_video_matches_jax(detectors, small_video):
    from avede_tpu.services.background_independent import \
        BackgroundIndependentService as JBg

    from avede_tpu_torch.services.background_independent import \
        BackgroundIndependentService

    jdet, tdet = detectors
    kw = dict(confidence_threshold=0.0, top_k=10,
              background_removal_strength=0.6)
    cv2.setRNGSeed(0)
    ref = JBg(jdet.engine, detector=jdet).match_in_video(small_video,
                                                         QUERIES, **kw)
    cv2.setRNGSeed(0)
    got = BackgroundIndependentService(tdet.engine).match_in_video(
        small_video, QUERIES, detector=tdet, **kw)
    _same_result(got, ref, "background_independence_stats")
    assert got["metadata"]["frames_processed"] == 6


@pytest.fixture()
def processors(detectors, tmp_data_dirs, monkeypatch):
    """(JAX, port) ``VideoProcessor``s on the tiny models, 64 px tiles."""
    from avede_tpu.services.video_processor import VideoProcessor as JProc

    from avede_tpu_torch.services.video_processor import VideoProcessor

    for attr, sub in [("DATA_DIR", ""), ("VIDEO_DIR", "videos"),
                      ("CLIP_DIR", "clips"), ("EMBEDDING_DIR", "embeddings"),
                      ("IMAGE_DIR", "images"), ("LOG_DIR", "logs")]:
        monkeypatch.setattr(tsettings, attr,
                            str(tmp_data_dirs / sub) if sub
                            else str(tmp_data_dirs))
    jdet, tdet = detectors
    jproc, tproc = JProc(engine=jdet.engine), VideoProcessor(
        engine=tdet.engine)
    jproc._universal_detector, tproc._universal_detector = jdet, tdet
    jproc._small_object, tproc._small_object = _services(detectors)
    return jproc, tproc


def test_video_processor_entry_points_match_jax(processors, small_video):
    """Both facades' answers and error envelopes, task ids aside."""
    jproc, tproc = processors
    kw = dict(detection_mode="owlvit", confidence_threshold=0.5, top_k=6,
              min_object_size=4, video_id="so")
    cv2.setRNGSeed(0)
    ref = jproc.process_small_object_detection(small_video, QUERIES, **kw)
    cv2.setRNGSeed(0)
    got = tproc.process_small_object_detection(small_video, QUERIES, **kw)
    assert got["status"] == ref["status"] == "completed"
    assert tproc.small_object.detector is tproc.universal_detector
    _same_result(got, ref, "enhancement_stats")
    kw = dict(confidence_threshold=0.0, top_k=5, video_id="so")
    cv2.setRNGSeed(0)
    ref = jproc.process_background_independence(small_video, "grass", **kw)
    cv2.setRNGSeed(0)
    got = tproc.process_background_independence(small_video, "grass", **kw)
    assert got["status"] == ref["status"] == "completed"
    assert got["queries"] == ["grass"]
    _same_result(got, ref, "background_independence_stats")
    for call, kw in (("process_small_object_detection",
                      dict(detection_mode="bogus")),
                     ("process_small_object_detection",
                      dict(min_object_size=None, detection_mode="owlvit")),
                     ("process_background_independence", {})):
        path = small_video if kw else str(small_video) + ".missing"
        ref = getattr(jproc, call)(path, ["x"], **kw)
        got = getattr(tproc, call)(path, ["x"], **kw)
        for env in (ref, got):
            env.pop("task_id"), env.pop("timestamp", None)
        assert got == ref and got["status"] == "error"
