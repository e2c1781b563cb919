"""The ported person search against the JAX package on the CPU: the
appearance encoder, the host feature helpers, the fusion, the detector
and ``PersonSearchService`` over a real mp4 of drawn people, on the same
tiny CLIP, YOLO, appearance and face weights (carried across with
``params_from_jax``, or written by JAX's ``save_params`` and read through
the settings).

Bars: the encoders within 1e-5; host features (head crops, lighting,
gray-crop and body vectors) exactly equal, cv2's RNG seeded before each
package's GrabCut calls (its GMM init draws from it); fusion weights and
similarities within 1e-6 on the same cues; CLIP crop rows, similarities
and whole-video matches within 1e-4 (f32 sums in another order), boxes
within 1e-3 px. Near ties are handled as the image-query test handles
them: matches within 1e-5 of the threshold may be kept by one package
only and are left out on both sides.
"""

import csv
import json

import cv2
import jax
import numpy as np
import pytest
import torch

from avede_tpu.utils.config import settings as jsettings
from avede_tpu_torch.models.convert import params_from_jax
from avede_tpu_torch.utils.config import settings as tsettings
from tests.test_torch_detection import (  # noqa: F401 — port_dirs: fixture
    _filled, _nms_per_class_left_of_zero, _np, _yolo_variables, port_dirs)

TOL = 1e-4
TIE = 1e-5


# ---------------------------------------------------------------------------
# appearance encoder
# ---------------------------------------------------------------------------

def _appearance_cfgs(face: bool):
    from avede_tpu.models.appearance import AppearanceConfig as JCfg

    from avede_tpu_torch.models.appearance import (AppearanceConfig,
                                                   face_embed_config)

    if face:
        return (JCfg(input_size=32, widths=(16, 32, 32, 64), embed_dim=64),
                face_embed_config())
    return JCfg(), AppearanceConfig()


@pytest.fixture(scope="module")
def appearance_weights():
    """JAX params of the default (64 px) and face (32 px) encoders."""
    from avede_tpu.models.appearance import init_appearance

    return {face: init_appearance(_appearance_cfgs(face)[0],
                                  seed=int(face))[1]
            for face in (False, True)}


@pytest.mark.parametrize("face", [False, True], ids=["default", "face"])
def test_appearance_encoder_matches_jax(appearance_weights, face):
    from avede_tpu.models.appearance import AppearanceEncoder as JEnc

    from avede_tpu_torch.models.appearance import AppearanceEncoder

    jcfg, cfg = _appearance_cfgs(face)
    assert cfg.input_size == jcfg.input_size and cfg.widths == jcfg.widths
    params = appearance_weights[face]
    model = AppearanceEncoder(cfg).eval()
    model.load_state_dict(params_from_jax(_np(params)))
    s = cfg.input_size
    for n, size in ((5, s), (2, s + 6)):        # odd sides pad (1, 1)
        x = np.random.default_rng(n).uniform(0, 1, (n, size, size, 3)
                                             ).astype(np.float32)
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        ref = np.asarray(JEnc(jcfg).apply({"params": params}, x))
        assert got.shape == (n, cfg.embed_dim)
        assert np.abs(got - ref).max() <= 1e-5


@pytest.mark.parametrize("face", [False, True], ids=["default", "face"])
def test_appearance_embedder_matches_jax(appearance_weights, face):
    """Ragged uint8 crops, resized on the host (cv2 INTER_AREA)."""
    from avede_tpu.models.appearance import AppearanceEmbedder as JEmb

    from avede_tpu_torch.models.appearance import AppearanceEmbedder

    jcfg, cfg = _appearance_cfgs(face)
    params = appearance_weights[face]
    tem = AppearanceEmbedder(cfg, state_dict=params_from_jax(_np(params)),
                             device="cpu")
    jem = JEmb(jcfg, params=params)
    rng = np.random.default_rng(3)
    crops = [rng.integers(0, 255, (int(h), int(w), 3), dtype=np.uint8)
             for h, w in ((10, 7), (cfg.input_size, cfg.input_size),
                          (90, 40), (5, 33))]
    got, ref = tem.embed(crops), jem.embed(crops)
    assert got.dtype == np.float32 and np.abs(got - ref).max() <= 1e-5
    assert tem.embed([]).shape == (0, cfg.embed_dim)


# ---------------------------------------------------------------------------
# host feature helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    """A crowd frame of three drawn people, their boxes and identities."""
    from avede_tpu_torch.utils.synthetic import (draw_people, make_identity,
                                                 with_outfit)

    rng = np.random.default_rng(0)
    ids = [with_outfit(make_identity(rng), rng) for _ in range(3)]
    frame, boxes = draw_people(ids, rng, frame_hw=(128, 160),
                               person_h_range=(50, 80))
    return frame, boxes, ids


def test_person_drawers_equal_jax():
    from avede_tpu.utils import synthetic as js

    from avede_tpu_torch.utils import synthetic as ts

    outs = []
    for mod in (js, ts):
        rng = np.random.default_rng(5)
        ids = [mod.with_outfit(mod.make_identity(rng), rng)
               for _ in range(3)]
        parts = {}
        one = mod.draw_person(ids[0], rng, frame_hw=(96, 80), parts=parts)
        crowd = mod.draw_people(ids, rng, frame_hw=(128, 160),
                                person_h_range=(40, 70))
        bare = mod.draw_person(mod.make_identity(rng), rng)
        outs.append((ids, one, parts, crowd, bare))
    (jids, jone, jparts, jcrowd, jbare), (ids, one, parts, crowd, bare) = outs
    assert ids == jids and parts == jparts
    for got, ref in ((one, jone), (crowd, jcrowd), (bare, jbare)):
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]


def test_head_crop_equals_jax(scene):
    from avede_tpu.utils.synthetic import head_crop as jhead

    from avede_tpu_torch.utils.synthetic import head_crop

    frame, boxes, _ = scene
    for box in boxes + [[-20.0, -5.0, 30.0, 60.0], [150.0, 120.0, 175.0,
                                                    160.0],
                        [10.0, 10.0, 10.5, 10.5]]:
        np.testing.assert_array_equal(head_crop(frame, box),
                                      jhead(frame, box))


def test_lighting_and_face_feature_equal_jax(scene):
    from avede_tpu.services import person_detector as jp

    from avede_tpu_torch.services import person_detector as tp

    frame, boxes, _ = scene
    rng = np.random.default_rng(1)
    dark = (frame * 0.2).astype(np.uint8)
    tinted = np.clip(frame * np.array([1.4, 0.9, 0.6]), 0, 255
                     ).astype(np.uint8)
    for img in (frame, dark, tinted,
                rng.integers(0, 255, (33, 21, 3), dtype=np.uint8)):
        np.testing.assert_array_equal(tp.normalize_lighting(img),
                                      jp.normalize_lighting(img))
    norm = tp.normalize_lighting(frame)
    flat = np.full((20, 20, 3), 77, np.uint8)
    for c in [tp.crop(norm, tp.face_region(b)) for b in boxes] \
            + [norm[:3, :3], flat, norm[:0]]:
        got, ref = tp.face_feature(c), jp.face_feature(c)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    for b in boxes + [[-3.0, 2.0, 500.0, 40.0]]:
        assert tp.face_region(b) == jp.face_region(b)
        np.testing.assert_array_equal(tp.crop(frame, b), jp.crop(frame, b))


def test_body_feature_equals_jax(scene):
    """GrabCut silhouettes (downscaled past 96 px), the border-colour
    fallback, and the empty feature of a crop too small to segment."""
    from avede_tpu.services import person_detector as jp

    from avede_tpu_torch.services import person_detector as tp

    frame, boxes, _ = scene
    big = cv2.resize(frame, (480, 384))
    cases = [(tp.crop(frame, b), b) for b in boxes]
    cases += [(tp.crop(big, [b * 3 for b in boxes[0]]),
               [b * 3 for b in boxes[0]]),
              (np.full((40, 20, 3), 90, np.uint8), [0, 0, 20, 40]),
              (frame[:6, :5], [0, 0, 5, 6]), (frame[:0], [0, 0, 1, 1])]
    for c, b in cases:
        cv2.setRNGSeed(0)
        got = tp.body_feature(c, b)
        cv2.setRNGSeed(0)
        ref = jp.body_feature(c, b)
        assert got.dtype == np.float32 and got.shape == (17,)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def _cue_rows(rng, n, keys):
    sims = [{k: float(v) for k, v in zip(keys, rng.uniform(-0.2, 1, 4))}
            for _ in range(n)]
    for s in sims[::5]:
        s[keys[-1]] = None                       # a missing cue
    return sims


@pytest.mark.parametrize("keys", [("face", "body", "visual"),
                                  ("identity", "face", "body", "visual")])
def test_fit_fusion_weights_matches_jax(keys):
    from avede_tpu.services.person_detector import \
        fit_fusion_weights as jfit

    from avede_tpu_torch.services.person_detector import fit_fusion_weights

    rng = np.random.default_rng(len(keys))
    sims = _cue_rows(rng, 60, keys)
    labels = [s[keys[0]] > 0.45 for s in sims]   # the first cue predicts
    got = fit_fusion_weights(sims, labels, keys=keys)
    ref = jfit(sims, labels, keys=keys)
    assert set(got) == set(ref) == set(keys)
    assert max(abs(got[k] - ref[k]) for k in keys) <= 1e-9
    assert abs(sum(got.values()) - 1.0) <= 1e-9
    fallback = {"face": 0.5, "body": 0.5}
    anti = [not x for x in labels]               # every cue predicts
    anti_sims = [{k: s[keys[0]] for k in keys} for s in sims]   # the reverse
    for args in (([], []), (sims, [True] * 60), (anti_sims, anti)):
        assert fit_fusion_weights(*args, keys=keys, fallback=fallback) \
            == jfit(*args, keys=keys, fallback=fallback) == fallback
    assert fit_fusion_weights([], []) == jsettings.PERSON_FEATURE_WEIGHTS \
        == tsettings.PERSON_FEATURE_WEIGHTS


def _feature_dicts(rng):
    def vec(n, none_rate):
        return None if rng.uniform() < none_rate else rng.normal(size=n)

    out = []
    for _ in range(12):
        out.append({"identity": vec(8, 0.3), "face": vec(16, 0.3),
                    "face_conf": float(rng.uniform()),
                    "body": (np.zeros(17) if rng.uniform() < 0.2
                             else rng.normal(size=17)),
                    "visual": vec(32, 0.1)})
    return out


@pytest.mark.parametrize("weights", [
    None, {"face": 0.5, "body": 0.2, "visual": 0.3},
    {"identity": 0.4, "face": 0.3, "body": 0.2, "visual": 0.1},
    {"identity": 0.0, "face": 0.0, "body": 0.0, "visual": 0.0}],
    ids=["settings", "3-way", "4-way", "zero"])
def test_similarity_matches_jax(weights):
    from avede_tpu.services.person_detector import PersonDetector as JDet

    from avede_tpu_torch.services.person_detector import PersonDetector

    jdet, tdet = JDet.__new__(JDet), PersonDetector.__new__(PersonDetector)
    for d in (jdet, tdet):
        d.fusion_weights = dict(weights or jsettings.PERSON_FEATURE_WEIGHTS)
    feats = _feature_dicts(np.random.default_rng(4))
    for ref in feats[:4]:
        for cand in feats:
            got, want = tdet.similarity(ref, cand), jdet.similarity(ref, cand)
            assert set(got) == set(want)
            for k in want:
                assert abs(got[k] - want[k]) <= 1e-6, k


# ---------------------------------------------------------------------------
# the detector and the video search, through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(appearance_weights):
    from avede_tpu.models.clip import init_clip, tiny_test_config
    from avede_tpu.models.yolo import YoloConfig, tiny_yolo_config

    clip = _filled(lambda: init_clip(tiny_test_config(), seed=0)[1])
    _, yolo = _yolo_variables(tiny_yolo_config())
    _, face_yolo = _yolo_variables(
        YoloConfig(num_classes=1, scale="n", img_size=64), seed=1)
    out = {name: (tree, params_from_jax(_np(tree)))
           for name, tree in (("clip", clip), ("yolo", yolo),
                              ("face_yolo", face_yolo))}
    for face, name in ((False, "appearance"), (True, "face")):
        tree = appearance_weights[face]
        out[name] = (tree, params_from_jax(_np(tree)))
    return out


def _detectors(weights, learned: bool):
    """(JAX, port) ``PersonDetector``s on the tiny models; ``learned``
    adds the appearance encoder, the face-region YOLO and the face
    embedder. The JAX ``YoloService`` takes the port's NMS semantics for
    boxes left of x = 0, which tiny YOLO's boxes cross
    (``tests/test_torch_detection.py``, ROADMAP Queue 3)."""
    from avede_tpu.models.appearance import AppearanceEmbedder as JEmb
    from avede_tpu.models.clip import tiny_test_config as jclip
    from avede_tpu.models.yolo import YoloConfig as JYoloCfg
    from avede_tpu.models.yolo import tiny_yolo_config as jyolo
    from avede_tpu.parallel.embed import ClipEngine as JEngine
    from avede_tpu.parallel.mesh import build_mesh
    from avede_tpu.services import detector as jdetector
    from avede_tpu.services.person_detector import PersonDetector as JDet

    from avede_tpu_torch.models.appearance import AppearanceEmbedder
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.models.yolo import YoloConfig, tiny_yolo_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.detector import YoloService
    from avede_tpu_torch.services.person_detector import PersonDetector

    jeng = JEngine(cfg=jclip(), params=weights["clip"][0],
                   mesh=build_mesh(jax.devices()[:1]))
    teng = ClipEngine(cfg=tiny_test_config(), state_dict=weights["clip"][1],
                      device="cpu")
    jkw, tkw = {}, {}
    if learned:
        jcfg, cfg = _appearance_cfgs(True)
        face_cfg = dict(num_classes=1, scale="n", img_size=64)
        jkw = dict(appearance=JEmb(params=weights["appearance"][0]),
                   face_yolo=jdetector.YoloService(
                       cfg=JYoloCfg(**face_cfg),
                       variables=weights["face_yolo"][0],
                       class_names=["face"]),
                   face_embedder=JEmb(jcfg, params=weights["face"][0]))
        tkw = dict(appearance=AppearanceEmbedder(
                       state_dict=weights["appearance"][1], device="cpu"),
                   face_yolo=YoloService(
                       cfg=YoloConfig(**face_cfg),
                       state_dict=weights["face_yolo"][1],
                       class_names=["face"], device="cpu"),
                   face_embedder=AppearanceEmbedder(
                       cfg, state_dict=weights["face"][1], device="cpu"))
    jdet = JDet(jeng, yolo=jdetector.YoloService(
        cfg=jyolo(), variables=weights["yolo"][0]), **jkw)
    tdet = PersonDetector(teng, yolo=YoloService(
        cfg=tiny_yolo_config(), state_dict=weights["yolo"][1],
        device="cpu"), **tkw)
    return jdet, tdet


@pytest.fixture()
def jax_nms(monkeypatch):
    from avede_tpu.services import detector as jdetector

    monkeypatch.setattr(jdetector, "nms_per_class",
                        _nms_per_class_left_of_zero)


def _same_features(got, ref):
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        assert max(abs(a - b) for a, b in zip(g["bbox"], r["bbox"])) <= 1e-3
        assert abs(g["face_conf"] - r["face_conf"]) <= TOL
        for k in ("identity", "face", "visual"):
            assert (g[k] is None) == (r[k] is None), k
            if r[k] is not None:
                assert np.abs(np.asarray(g[k]) - np.asarray(r[k])).max() \
                    <= TOL, k
        np.testing.assert_array_equal(g["body"], r["body"])
    assert len(got) == len(ref)


@pytest.mark.parametrize("learned", [False, True],
                         ids=["geometric", "learned"])
def test_detector_features_match_jax(weights, scene, jax_nms, learned):
    """``extract_features`` on the drawn boxes, ``process_reference`` and
    ``find_person_in_frame`` at threshold 0."""
    jdet, tdet = _detectors(weights, learned)
    frame, boxes, ids = scene
    cv2.setRNGSeed(0)
    got = tdet.extract_features(frame, boxes)
    cv2.setRNGSeed(0)
    ref = jdet.extract_features(frame, boxes)
    _same_features(got, ref)
    assert (got[0]["identity"] is not None) == learned
    from avede_tpu_torch.utils.synthetic import draw_person

    ref_img, _ = draw_person(ids[0], np.random.default_rng(9),
                             frame_hw=(128, 96))
    cv2.setRNGSeed(0)
    tref = tdet.process_reference(ref_img)
    cv2.setRNGSeed(0)
    jref = jdet.process_reference(ref_img)
    _same_features([tref], [jref])
    cv2.setRNGSeed(0)
    got = tdet.find_person_in_frame(frame, tref, threshold=0.0)
    cv2.setRNGSeed(0)
    want = jdet.find_person_in_frame(frame, jref, threshold=0.0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["method"] == w["method"] == "yolo"
        for k in ("confidence", "similarity", "face_similarity",
                  "body_similarity", "visual_similarity"):
            assert abs(g[k] - w[k]) <= TOL, k


def test_weights_from_settings_match_jax(weights, scene, tmp_path,
                                         monkeypatch):
    """``.npz`` files written by JAX's ``save_params`` and named by
    ``APPEARANCE_WEIGHTS``, ``FACE_DETECTOR_WEIGHTS`` and
    ``FACE_EMBED_WEIGHTS`` load in both packages and embed alike."""
    from avede_tpu.models.convert import save_params
    from avede_tpu.services.person_detector import PersonDetector as JDet

    from avede_tpu_torch.services.person_detector import PersonDetector

    names = {"APPEARANCE_WEIGHTS": "appearance",
             "FACE_DETECTOR_WEIGHTS": "face_yolo",
             "FACE_EMBED_WEIGHTS": "face"}
    for setting, name in names.items():
        path = tmp_path / f"{name}.npz"
        save_params(_np(weights[name][0]), str(path))
        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, setting, str(path))
    jdet, tdet = _detectors(weights, learned=False)
    jdet, tdet = JDet(jdet.engine, yolo=jdet.yolo), \
        PersonDetector(tdet.engine, yolo=tdet.yolo)
    assert tdet.appearance is not None and tdet._face_yolo is not None
    assert tdet.face_embedder is not None
    assert tdet._face_yolo.model.cfg.dtype == "float32"
    frame, boxes, _ = scene
    from avede_tpu_torch.utils.synthetic import head_crop

    heads = [head_crop(frame, b) for b in boxes]
    assert np.abs(tdet.appearance.embed(heads)
                  - jdet.appearance.embed(heads)).max() <= 1e-5
    assert np.abs(tdet.face_embedder.embed(heads)
                  - jdet.face_embedder.embed(heads)).max() <= 1e-5
    for b in boxes:
        (gb, gc), (rb, rc) = (tdet.find_faces_scored(frame, b),
                              jdet.find_faces_scored(frame, b))
        assert abs(gc - rc) <= TOL
        assert max(abs(x - y) for x, y in zip(gb, rb)) <= 1e-3


@pytest.mark.parametrize("name", ["appearance", "face_yolo"])
def test_port_save_params_reads_in_jax(weights, tmp_path, name):
    """``models.convert.save_params`` writes the JAX package's layout: its
    ``load_params`` gives back the tree the port's weights came from
    (YOLO's BatchNorm statistics under ``batch_stats``)."""
    from avede_tpu.models.convert import flatten_params
    from avede_tpu.models.convert import load_params as jload

    from avede_tpu_torch.models.appearance import init_appearance
    from avede_tpu_torch.models.convert import save_params
    from avede_tpu_torch.models.yolo import YoloConfig, init_yolo

    model = (init_appearance() if name == "appearance" else
             init_yolo(YoloConfig(num_classes=1, scale="n", img_size=64)))
    model.load_state_dict(weights[name][1])
    path = tmp_path / f"{name}.npz"
    save_params(model, str(path))
    got = flatten_params(jload(str(path)))
    want = flatten_params(_np(weights[name][0]))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def person_video(tmp_path_factory):
    """A 40-frame 160×128 mp4 of three drawn people (25 fps) and a
    reference image of the first alone."""
    from avede_tpu_torch.utils.synthetic import (draw_people, draw_person,
                                                 make_identity, with_outfit)

    rng = np.random.default_rng(11)
    ids = [with_outfit(make_identity(rng), rng) for _ in range(3)]
    path = str(tmp_path_factory.mktemp("person") / "people.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                             (160, 128))
    assert writer.isOpened()
    for _ in range(40):
        frame, _ = draw_people(ids, rng, frame_hw=(128, 160),
                               person_h_range=(50, 80))
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    ref, _ = draw_person(ids[0], rng, frame_hw=(128, 96))
    return path, ref


def _search(svc, path, ref, **kw):
    cv2.setRNGSeed(0)
    return svc.process_video_for_person(path, ref, **kw)


def _same_search(got, ref, thr):
    def kept(ms):
        return [m for m in ms if abs(m["similarity"] - thr) > TIE]

    g, r = kept(got["matches"]), kept(ref["matches"])
    assert [m["frame_index"] for m in g] == [m["frame_index"] for m in r]
    for a, b in zip(g, r):
        assert set(a) == set(b)
        assert a["timestamp"] == b["timestamp"]
        assert a["detection_method"] == b["detection_method"]
        assert max(abs(x - y) for x, y in zip(a["bbox"], b["bbox"])) <= 1e-3
        for k in ("similarity", "face_similarity", "body_similarity",
                  "visual_similarity"):
            assert abs(a[k] - b[k]) <= TOL, k
    assert got["results"] == got["matches"]
    assert got["total_found"] == len(got["matches"])
    gs, rs = got["summary"], ref["summary"]
    assert set(gs) == set(rs)
    for k in ("frames_processed", "frames_with_persons",
              "similarity_threshold"):
        assert gs[k] == rs[k], k
    if len(g) == len(got["matches"]) == len(ref["matches"]):
        assert gs["matches_found"] == rs["matches_found"]
        assert gs["presence_segments"] == rs["presence_segments"]
        for k in ("best_similarity", "mean_similarity"):
            assert abs(gs[k] - rs[k]) <= TOL


@pytest.mark.parametrize("learned", [False, True],
                         ids=["geometric", "learned"])
def test_process_video_for_person_matches_jax(weights, person_video,
                                              jax_nms, tmp_path, learned):
    """The whole search at threshold 0 (every person box a match, so the
    temporal filter decides) and at the median similarity, with
    annotated frames in the second."""
    from avede_tpu.services.person_detector import \
        PersonSearchService as JSvc

    from avede_tpu_torch.services.person_detector import \
        PersonSearchService

    jdet, tdet = _detectors(weights, learned)
    jsvc, tsvc = JSvc(jdet.engine, detector=jdet), \
        PersonSearchService(tdet.engine, detector=tdet)
    path, ref_img = person_video
    got = _search(tsvc, path, ref_img, similarity_threshold=0.0)
    ref = _search(jsvc, path, ref_img, similarity_threshold=0.0)
    assert ref["summary"]["frames_processed"] == 8
    assert len(ref["matches"]) > 2
    _same_search(got, ref, 0.0)
    thr = float(np.median([m["similarity"] for m in ref["matches"]]))
    progress = []
    got = _search(tsvc, path, ref_img, similarity_threshold=thr,
                  save_annotated_frames=True, batch_size=3,
                  output_dir=str(tmp_path / "port"),
                  progress_callback=progress.append)
    ref = _search(jsvc, path, ref_img, similarity_threshold=thr,
                  save_annotated_frames=True, batch_size=3,
                  output_dir=str(tmp_path / "jax"))
    _same_search(got, ref, thr)
    assert progress and progress[-1] == 1.0
    assert progress == sorted(progress)
    assert len(got["annotated_frames"]) == len(got["matches"])
    for p, m in zip(got["annotated_frames"], got["matches"]):
        assert p.endswith(f"match_{m['frame_index']:05d}.jpg")
        assert cv2.imread(p).shape == (128, 160, 3)


def _matches(sims):
    from avede_tpu_torch.services.person_detector import PersonMatch

    return [PersonMatch(timestamp=0.2 * ((i * 7) % len(sims)),
                        frame_index=i, bbox=[0.0, 0.0, 1.0, 1.0],
                        similarity=float(s), face_similarity=0.1,
                        body_similarity=0.2, visual_similarity=0.3,
                        detection_method="yolo")
            for i, s in enumerate(sims)]


def test_temporal_filter_and_report_match_jax(monkeypatch):
    from avede_tpu.services.person_detector import PersonMatch as JMatch
    from avede_tpu.services.person_detector import \
        PersonSearchService as JSvc

    from avede_tpu_torch.services.person_detector import \
        PersonSearchService

    sims = np.random.default_rng(2).uniform(0.2, 0.9, 23)
    for window, ratio in ((5, 0.8), (3, 1.0), (8, 0.5)):
        for s in (jsettings, tsettings):
            monkeypatch.setattr(s, "PERSON_TEMPORAL_WINDOW", window)
            monkeypatch.setattr(s, "PERSON_TEMPORAL_KEEP_RATIO", ratio)
        got = PersonSearchService._temporal_filter(_matches(sims))
        ref = JSvc._temporal_filter([JMatch(**m.to_dict())
                                     for m in _matches(sims)])
        assert [m.to_dict() for m in got] == [m.to_dict() for m in ref]
        assert 0 < len(got) < len(sims)
        args = (len(sims) * 2, 11, 3.5, 0.4)
        assert PersonSearchService._report(got, *args) \
            == JSvc._report(ref, *args)
    assert PersonSearchService._report([], 0, 0, 0.0, 0.6) \
        == JSvc._report([], 0, 0, 0.0, 0.6)


def test_export_results(tmp_path):
    from avede_tpu.services.person_detector import \
        PersonSearchService as JSvc

    from avede_tpu_torch.services.person_detector import \
        PersonSearchService

    results = {"matches": [m.to_dict() for m in _matches([0.7, 0.65])],
               "summary": {"matches_found": 2}}
    tsvc, jsvc = (PersonSearchService.__new__(PersonSearchService),
                  JSvc.__new__(JSvc))
    for fmt in ("json", "csv"):
        got = tsvc.export_results(results, str(tmp_path / "p" / f"r.{fmt}"),
                                  fmt)
        ref = jsvc.export_results(results, str(tmp_path / "j" / f"r.{fmt}"),
                                  fmt)
        with open(got) as a, open(ref) as b:
            assert a.read() == b.read()
    assert json.loads((tmp_path / "p" / "r.json").read_text()) == results
    with open(tmp_path / "p" / "r.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "timestamp" and len(rows) == 3
    with pytest.raises(ValueError, match="unknown export format"):
        tsvc.export_results(results, str(tmp_path / "x.txt"), "txt")


def test_video_processor_person_search(weights, person_video, port_dirs,
                                       tmp_path):
    """The facade: a completed answer with the service's keys, and an
    error envelope for a file that is not a video."""
    from avede_tpu_torch.services.person_detector import \
        PersonSearchService
    from avede_tpu_torch.services.video_processor import VideoProcessor

    _, tdet = _detectors(weights, learned=False)
    proc = VideoProcessor(engine=tdet.engine)
    proc._person = PersonSearchService(tdet.engine, detector=tdet)
    assert proc.person is proc._person
    path, ref = person_video
    out = proc.process_person_search(path, ref, similarity_threshold=0.0,
                                     temporal_consistency=False)
    assert out["status"] == "completed" and out["task_id"]
    assert {"matches", "results", "total_found", "summary",
            "annotated_frames"} <= set(out)
    assert out["total_found"] == out["summary"]["frames_with_persons"] > 0
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    err = proc.process_person_search(str(bad), ref)
    assert err["status"] == "error" and err["error"]


def test_segment_search_and_stop(weights, person_video):
    """``process_video_segment`` keeps the matches inside [start, end]
    and reports the segment; ``stop()`` from the progress callback ends
    the scan after the batch in flight, as in JAX."""
    from avede_tpu.services.person_detector import \
        PersonSearchService as JSvc

    from avede_tpu_torch.services.person_detector import \
        PersonSearchService

    jdet, tdet = _detectors(weights, learned=False)
    tsvc = PersonSearchService(tdet.engine, detector=tdet)
    path, ref = person_video
    whole = _search(tsvc, path, ref, similarity_threshold=0.0,
                    temporal_consistency=False)
    cv2.setRNGSeed(0)
    seg = tsvc.process_video_segment(path, ref, 0.3, 0.9,
                                     similarity_threshold=0.0,
                                     temporal_consistency=False)
    want = [m for m in whole["matches"] if 0.3 <= m["timestamp"] <= 0.9]
    assert seg["matches"] == seg["results"] == want and want
    assert seg["total_found"] == len(want)
    assert seg["summary"]["segment"] == [0.3, 0.9]

    def stopped(svc):
        return svc.process_video_for_person(
            path, ref, similarity_threshold=0.0, batch_size=3,
            temporal_consistency=False,
            progress_callback=lambda _: svc.stop())

    got = stopped(tsvc)
    with pytest.MonkeyPatch.context() as mp:
        from avede_tpu.services import detector as jdetector

        mp.setattr(jdetector, "nms_per_class", _nms_per_class_left_of_zero)
        ref_out = stopped(JSvc(jdet.engine, detector=jdet))
    assert got["summary"]["frames_with_persons"] \
        == ref_out["summary"]["frames_with_persons"] == 3
    assert [m["frame_index"] for m in got["matches"]] \
        == [m["frame_index"] for m in ref_out["matches"]]
