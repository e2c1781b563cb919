"""The port's eval modes (``avede_tpu_torch/eval.py``) against the JAX
package's (the repository's ``eval.py``), on the CPU at few steps.

Trainers: the tiny CLIP and the tiny BLIP start from JAX's init (carried
over by ``params_from_jax``) and take the same steps on the same batches;
the last loss must agree within 1e-5 relative and every parameter within
1e-4, but for the elements whose gradient is zero in exact arithmetic
(key-projection biases: softmax is shift invariant), where Adam steps
both packages by about lr on rounding noise, within 2 · steps · lr.

Modes: each JAX run body runs with a few training steps; its trained
weights are carried into the port, whose run body then sees the same
data (the same numpy draws, cv2 writes the same videos). Each must give
JAX's metric and JAX's per-query results: the same top hit (timestamp,
video, caption) and scores within 1e-4 (f32 against f32 on the CPU; the
library index's bf16 rows within 2e-3, one bf16 step).
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from avede_tpu_torch import eval as teval
from avede_tpu_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
STEPS = 4
LOSS_REL, PARAM_ABS, SCORE_ABS = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def jeval():
    """The repository's ``eval.py`` (the JAX package's harness)."""
    spec = importlib.util.spec_from_file_location("jax_eval",
                                                  ROOT / "eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lr(steps):
    """Largest learning rate of the first ``steps`` steps of the eval's
    warmup (peak 1.5e-3 over 50 steps)."""
    return 1.5e-3 * steps / 50


def _assert_params_close(got, ref, steps, lr=None):
    """``lr``: the largest learning rate of the steps (default: the CLIP
    and BLIP trainers' warmup, ``_lr``)."""
    lr = _lr(steps) if lr is None else lr
    assert set(got) == set(ref)
    worst = 0.0
    for k, v in ref.items():
        diff = (got[k].float() - v).abs()
        if k.endswith(("k_proj.bias", "attn.key.bias")):
            assert float(diff.max()) <= 2 * steps * lr, k
            continue
        if k.endswith("qkv.bias"):
            d = diff.shape[0] // 3
            assert float(diff[d:2 * d].max()) <= 2 * steps * lr, k
            diff = torch.cat([diff[:d], diff[2 * d:]])
        worst = max(worst, float(diff.max()))
    assert worst <= PARAM_ABS, worst


@pytest.fixture(scope="module")
def trained_clip(jeval):
    """JAX's ``_train_tiny_clip(0, STEPS)`` and the same training in the
    port from JAX's init → (JAX triple, port triple)."""
    from avede_tpu.models.clip import init_clip, tiny_test_config

    jax_triple = jeval._train_tiny_clip(0, STEPS)
    _, init = init_clip(tiny_test_config(), seed=0)
    port = teval._train_tiny_clip(0, STEPS, "cpu",
                                  init=params_from_jax(_np(init)))
    return jax_triple, port


def _carried(jax_triple):
    """JAX's trained CLIP served by the port on the CPU."""
    engine, pairs, loss = jax_triple
    sd = params_from_jax(_np(engine.params))
    return teval.tiny_clip_engine("cpu", sd), pairs, loss


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

def test_train_tiny_clip_matches_jax(trained_clip):
    (jengine, jpairs, jloss), (engine, pairs, loss) = trained_clip
    assert pairs == jpairs and len(pairs) == 16
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    _assert_params_close(engine.model.state_dict(),
                         params_from_jax(_np(jengine.params)), STEPS)
    # the served engine takes the device's compute dtype (f32 here)
    assert engine.cfg.dtype == "float32" and engine.cfg.use_flash


def _jax_caption_run(jeval, monkeypatch, seed):
    """JAX's ``_caption_run(seed, STEPS)`` → (result, trained params,
    its CLIP's params, every caption, every similarity asked for)."""
    from avede_tpu.services import captioner

    seen = {"sims": []}

    class Recording(captioner.CaptionService):
        def __init__(self, engine, **kw):
            super().__init__(engine, **kw)
            seen["params"], seen["clip"] = kw["params"], engine.params

        def caption_frames(self, frames):
            seen["caps"] = super().caption_frames(frames)
            return seen["caps"]

        def caption_query_similarity(self, captions, query):
            out = super().caption_query_similarity(captions, query)
            seen["sims"].append(float(out[0]))
            return out

    monkeypatch.setattr(captioner, "CaptionService", Recording)
    return jeval._caption_run(seed, STEPS), seen


def test_caption_trainer_and_mode_match_jax(jeval, monkeypatch, tmp_path):
    """The tiny BLIP's training from JAX's init, then the caption mode's
    scoring on JAX's trained weights and the same draws."""
    from avede_tpu.models.blip import init_blip, tiny_blip_config

    from avede_tpu_torch.models.blip import tiny_blip_config as ttiny
    from avede_tpu_torch.services.captioner import CaptionService

    ref, seen = _jax_caption_run(jeval, monkeypatch, 0)

    vocab = str(tmp_path / "vocab.txt")
    teval._shapes_wordpiece_vocab(vocab, ttiny())
    _, init = init_blip(tiny_blip_config(), seed=0)
    rng = np.random.default_rng(0)
    sd, loss = teval._train_tiny_blip(rng, vocab, 0, STEPS, "cpu",
                                      init=params_from_jax(_np(init)))
    assert abs(loss - ref["final_train_loss"]) \
        <= LOSS_REL * ref["final_train_loss"]
    _assert_params_close(sd, params_from_jax(_np(seen["params"])), STEPS)

    # the rng now stands where JAX's stood after training
    svc = CaptionService(teval.tiny_clip_engine(
        "cpu", params_from_jax(_np(seen["clip"]))), cfg=ttiny(),
        state_dict=params_from_jax(_np(seen["params"])), vocab_path=vocab)
    sims = []
    real = svc.caption_query_similarity

    def recording(captions, query):
        out = real(captions, query)
        sims.append(float(out[0]))
        return out

    svc.caption_query_similarity = recording
    caps = []
    real_caps = svc.caption_frames
    svc.caption_frames = lambda f: caps.extend(real_caps(f)) or caps
    got = teval._caption_scores(svc, rng, 0, STEPS, ref["final_train_loss"])
    assert caps == seen["caps"]
    assert got == ref
    np.testing.assert_allclose(sims, seen["sims"], atol=SCORE_ABS)


# ---------------------------------------------------------------------------
# the modes on the same weights
# ---------------------------------------------------------------------------

def _record(monkeypatch, cls, name, log):
    real = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        log.append(out)
        return out

    monkeypatch.setattr(cls, name, wrapper)


def test_image_mode_matches_jax(jeval, monkeypatch, tmp_path):
    """JAX's image run (untrained tiny CLIP from its seed 0) and the
    port's on the same weights: the same p@1 and recall@5, the same top
    matches with scores within 1e-4. Both read the frame table back from
    an int8 embedding cache (JAX's default one, pointed at a temporary
    directory here)."""
    from avede_tpu.models.clip import init_clip, tiny_test_config
    from avede_tpu.services import image_matcher as jim
    from avede_tpu.utils.config import settings as jsettings

    from avede_tpu_torch.services import image_matcher as tim

    monkeypatch.setattr(jsettings, "EMBEDDING_DIR", str(tmp_path))
    jlog, tlog = [], []
    _record(monkeypatch, jim.ImageMatcher, "match_image_to_video", jlog)
    _record(monkeypatch, tim.ImageMatcher, "match_image_to_video", tlog)
    ref = jeval._image_retrieval_run(3, 4)
    _, params = init_clip(tiny_test_config(), seed=0)
    engine = teval.tiny_clip_engine("cpu", params_from_jax(_np(params)))
    got = teval._image_retrieval_run(3, 4, engine)
    assert got == ref
    assert len(tlog) == len(jlog) == 4
    for t, j in zip(tlog, jlog):
        assert [m["timestamp"] for m in t] == [m["timestamp"] for m in j]
        np.testing.assert_allclose([m["similarity"] for m in t],
                                   [m["similarity"] for m in j],
                                   atol=SCORE_ABS)


def _top_hits(log):
    return [(r[0]["timestamp"], r[0]["confidence"]) for r in log]


def test_text_mode_matches_jax(jeval, trained_clip, monkeypatch):
    from avede_tpu.pipelines import phase1 as jp1

    from avede_tpu_torch.pipelines import phase1 as tp1

    jtrip = trained_clip[0]
    monkeypatch.setattr(jeval, "_train_tiny_clip", lambda *a, **k: jtrip)
    jlog, tlog = [], []
    _record(monkeypatch, jp1.Phase1Scan, "process_video", jlog)
    _record(monkeypatch, tp1.Phase1Scan, "process_video", tlog)
    ref = jeval._text_trained_run(0, STEPS)
    got = teval._text_trained_run(0, STEPS, "cpu",
                                  trained=_carried(jtrip))
    assert got == ref
    assert len(tlog) == len(jlog) == 16
    for (tt, tc), (jt, jc) in zip(_top_hits(tlog), _top_hits(jlog)):
        assert tt == jt and abs(tc - jc) <= SCORE_ABS


def test_library_mode_matches_jax(jeval, trained_clip, monkeypatch,
                                  tmp_path):
    from avede_tpu.services import library_search as jls
    from avede_tpu.utils.config import settings as jsettings

    from avede_tpu_torch.services import library_search as tls

    jtrip = trained_clip[0]
    monkeypatch.setattr(jeval, "_train_tiny_clip", lambda *a, **k: jtrip)
    for attr in ("VIDEO_DIR", "EMBEDDING_DIR"):
        monkeypatch.setattr(jsettings, attr, str(tmp_path / attr))
    jlog, tlog = [], []
    _record(monkeypatch, jls.LibrarySearch, "search", jlog)
    _record(monkeypatch, tls.LibrarySearch, "search", tlog)
    ref = jeval._library_run(0, STEPS, 4)
    got = teval._library_run(0, STEPS, 4, "cpu", trained=_carried(jtrip))
    assert got == ref
    assert got["index_dtype"] == "bfloat16" and got["frames_indexed"] == 128
    assert len(tlog) == len(jlog) == 16
    for t, j in zip(tlog, jlog):
        t, j = t["results"][0], j["results"][0]
        assert (t["video_id"], t["timestamp"]) == (j["video_id"],
                                                   j["timestamp"])
        assert abs(t["confidence"] - j["confidence"]) <= 2e-3


def test_background_mode_matches_jax(jeval, trained_clip, monkeypatch):
    """GrabCut draws its GMM init from cv2's global RNG: seeded once
    before each package's run, both draw the same sequence."""
    import cv2

    from avede_tpu.services import background_independent as jbg

    from avede_tpu_torch.services import background_independent as tbg

    jtrip = trained_clip[0]
    monkeypatch.setattr(jeval, "_train_tiny_clip", lambda *a, **k: jtrip)
    jlog, tlog = [], []
    for mod, log in ((jbg, jlog), (tbg, tlog)):
        real = mod.BackgroundIndependentService.feature_similarity

        def recording(a, b, real=real, log=log):
            out = real(a, b)
            log.append(out)
            return out

        monkeypatch.setattr(mod.BackgroundIndependentService,
                            "feature_similarity", staticmethod(recording))
    cv2.setRNGSeed(0)
    ref = jeval.eval_background(0, STEPS, n_trials=24)
    cv2.setRNGSeed(0)
    got = teval.eval_background(0, STEPS, n_trials=24, device="cpu",
                                trained=_carried(jtrip))
    assert got == ref
    assert len(tlog) == len(jlog) > 0
    np.testing.assert_allclose(tlog, jlog, atol=SCORE_ABS)


# ---------------------------------------------------------------------------
# the detector modes (YOLO and OWL-ViT trained from JAX's seeded weights)
# ---------------------------------------------------------------------------

# detections a frame (and person boxes) in both packages' settings: a
# detector a few steps from random weights keeps boxes everywhere, and
# each box is a CLIP crop (and a GrabCut and a face search in the person
# search)
MAX_OBJECTS = 1


def _close(got, ref, path="", tol=SCORE_ABS):
    """Equal structure and values: numbers within ``tol``, the rest
    exactly."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _close(got[k], ref[k], f"{path}.{k}", tol)
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, f"{path}[{i}]", tol)
    elif isinstance(ref, float) and not isinstance(got, bool):
        assert abs(got - ref) <= tol, (path, got, ref)
    else:
        assert got == ref, (path, got, ref)


@pytest.fixture(scope="module")
def det_weights(jeval):
    """JAX's ``_train_tiny_yolo`` (the ``detection`` mode's 64 px YOLO)
    and ``_train_tiny_owl`` (its OWL-ViT), STEPS steps each from seeded
    weights (their inits swapped in: flax's eager init takes seconds),
    and the port's trainers from the same weights → {name: (JAX triple,
    port triple)}."""
    from avede_tpu.models import yolo as jyolo
    from avede_tpu.models.owlvit import OwlViTConfig, OwlViTDetector
    from avede_tpu.parallel import train_owl as jtrain_owl
    from avede_tpu.utils.synthetic import draw_shape_scene
    import jax.numpy as jnp

    from tests.test_torch_detection import _filled, _yolo_variables

    def jscene(r):
        import cv2

        img, gb, gl, gm = draw_shape_scene(r, hw=(128, 128), max_boxes=5,
                                           min_r=10, max_r=22,
                                           non_overlapping=True)
        return (cv2.resize(img, (64, 64), interpolation=cv2.INTER_AREA),
                gb / 2.0, gl, gm)

    yvars = _yolo_variables(jyolo.YoloConfig(num_classes=4, img_size=64),
                            seed=5)
    owl = OwlViTDetector(OwlViTConfig(**teval.DETECTION_OWL))
    oparams = _filled(lambda: owl.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((4, 8), jnp.int32)), seed=6)["params"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jyolo, "init_yolo", lambda cfg, seed: yvars)
        mp.setattr(jtrain_owl, "init_owlvit", lambda cfg, seed: (owl,
                                                                 oparams))
        jy = jeval._train_tiny_yolo(STEPS, 0, scene_fn=jscene, max_boxes=5)
        jo = jeval._train_tiny_owl(STEPS, 0, scene_fn=lambda r:
                                   draw_shape_scene(r, hw=(128, 128),
                                                    max_boxes=5, min_r=10,
                                                    max_r=22,
                                                    non_overlapping=True))
    from avede_tpu_torch.parallel import train_det, train_owl

    def carried_init(init, sd):
        def build(cfg, seed):
            model = init(cfg, seed)
            model.load_state_dict(sd)
            return model
        return build

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_det, "init_yolo", carried_init(
            train_det.init_yolo, params_from_jax(_np(yvars[1]))))
        mp.setattr(train_owl, "init_owlvit", carried_init(
            train_owl.init_owlvit, params_from_jax(_np(oparams))))
        ty = teval._train_tiny_yolo(STEPS, 0, scene_fn=teval._yolo_scene64,
                                    device="cpu")
        to = teval._train_tiny_owl(STEPS, 0,
                                   scene_fn=teval._shape_scene128,
                                   device="cpu")
    return {"yolo": (jy, ty), "owl": (jo, to)}


def test_detector_trainers_match_jax(det_weights):
    """The eval's two detector trainers from JAX's weights: the last loss
    within 1e-5, the parameters within 1e-4 (the YOLO's BatchNorm
    statistics exactly: frozen in both), key biases within 2 · steps ·
    lr (the OWL-ViT's warmup reaches 2e-3 · STEPS / 100)."""
    (jcfg, jvars, jloss), (cfg, sd, loss) = det_weights["yolo"]
    assert (cfg.num_classes, cfg.img_size) == (jcfg.num_classes,
                                               jcfg.img_size)
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    ref = params_from_jax(_np(jvars))
    _assert_params_close(sd, ref, STEPS, lr=3e-3)
    for k in ref:
        if "running" in k:
            assert torch.equal(sd[k], ref[k]), k
    (jcfg, jparams, jloss), (cfg, sd, loss) = det_weights["owl"]
    assert cfg.grid == jcfg.grid == 8 and cfg.vision_dim == 96
    assert abs(loss - jloss) <= LOSS_REL * abs(jloss)
    _assert_params_close(sd, params_from_jax(_np(jparams)), STEPS,
                         lr=2e-3 * STEPS / 100)


@pytest.fixture()
def carried_clip(jeval, monkeypatch):
    """Both packages' eval on one seeded tiny CLIP (JAX's ``init_clip``
    swapped for it, the port's engine by ``params_from_jax``), at most
    ``MAX_OBJECTS`` detections a frame, and JAX's ``YoloService`` on the
    port's NMS for boxes left of x = 0 (``tests/test_torch_detection.py``)
    → the port's engine."""
    from avede_tpu.models import clip as jclip
    from avede_tpu.services import detector as jdetector
    from avede_tpu.utils.config import settings as jsettings

    from avede_tpu_torch.utils.config import settings as tsettings
    from tests.test_torch_detection import _filled, _nms_per_class_left_of_zero

    clip = _filled(lambda: jclip.init_clip(jclip.tiny_test_config(),
                                           seed=0)[1])
    monkeypatch.setattr(jclip, "init_clip", lambda cfg, seed: (None, clip))
    monkeypatch.setattr(jdetector, "nms_per_class",
                        _nms_per_class_left_of_zero)
    engine = teval.tiny_clip_engine("cpu", params_from_jax(_np(clip)))
    monkeypatch.setattr(teval, "tiny_clip_engine",
                        lambda dev, dtype=None: engine)
    for s in (jsettings, tsettings):
        monkeypatch.setattr(s, "DETECTION_MAX_OBJECTS", MAX_OBJECTS)
        # crops embed at once rather than through the batching thread
        monkeypatch.setattr(s, "BATCHING_EXECUTOR_ENABLED", False)
    return engine


@pytest.fixture()
def carried(det_weights, jeval, carried_clip, monkeypatch):
    """``carried_clip``, and both packages' detector trainers returning
    ``det_weights``' (JAX's trained YOLO and OWL-ViT, carried over)."""
    jy, ty = det_weights["yolo"]
    jo, to = det_weights["owl"]
    monkeypatch.setattr(jeval, "_train_tiny_yolo", lambda *a, **k: jy)
    monkeypatch.setattr(jeval, "_train_tiny_owl", lambda *a, **k: jo)
    monkeypatch.setattr(teval, "_train_tiny_yolo", lambda *a, **k: ty)
    monkeypatch.setattr(teval, "_train_tiny_owl", lambda *a, **k: to)
    return carried_clip


def _record_calls(monkeypatch, pairs):
    """Wrap each (JAX class, port class, method) → (JAX log, port log)
    of every call's output."""
    jlog, tlog = [], []
    for jcls, tcls, name in pairs:
        _record(monkeypatch, jcls, name, jlog)
        _record(monkeypatch, tcls, name, tlog)
    return jlog, tlog


def _same_detections(got, ref):
    """Per frame the same detections in the same order: boxes within
    1e-3 px, confidences within 1e-4, the same label."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert len(g) == len(r)
        for a, b in zip(g, r):
            assert max(abs(x - y) for x, y in zip(a["bbox"], b["bbox"])) \
                <= 1e-3
            assert abs(a["confidence"] - b["confidence"]) <= SCORE_ABS
            assert a.get("query", a.get("class_id")) \
                == b.get("query", b.get("class_id"))


def test_detection_metrics_match_jax(jeval):
    """``_match_detections``, ``_iou_xyxy`` and ``_average_precision`` on
    seeded detections around seeded ground truth (hits, misses, wrong
    classes, duplicates): JAX's counts and mAP exactly."""
    rng = np.random.default_rng(8)
    all_dets, all_gts = [], []
    for _ in range(6):
        gb = rng.uniform(0, 80, (4, 2))
        gb = np.concatenate([gb, gb + rng.uniform(10, 40, (4, 2))], -1)
        gl = rng.integers(0, 3, 4)
        dets = [{"bbox": list(gb[j] + rng.normal(0, 3, 4)),
                 "confidence": float(rng.uniform()),
                 "class_id": int(gl[j] if rng.uniform() < 0.8
                                 else rng.integers(0, 3))}
                for j in rng.integers(0, 4, 5)]
        assert teval._match_detections(dets, gb, gl) \
            == jeval._match_detections(dets, gb, gl)
        assert teval._iou_xyxy(dets[0]["bbox"], gb[0]) \
            == jeval._iou_xyxy(dets[0]["bbox"], gb[0])
        all_dets.append(dets)
        all_gts.append((gb, gl))
    ap = teval._average_precision(all_dets, all_gts)
    assert ap == jeval._average_precision(all_dets, all_gts)
    assert 0 < ap < 1


def test_detection_mode_matches_jax(jeval, carried, monkeypatch):
    """JAX's ``eval_detection`` and the port's on the same trained YOLO
    and OWL-ViT (both seeds' runs on the one OWL-ViT) and tiny CLIP:
    every metric, count and threshold choice equal, and every call's
    detections the same (frame-level YOLO, the 576 ``owlvit`` and
    ``hybrid`` calls, the video path)."""
    from avede_tpu.services import detector as jdet
    from avede_tpu.services import small_object as jso
    from avede_tpu.services import universal_detector as jud

    from avede_tpu_torch.services import detector as tdet
    from avede_tpu_torch.services import small_object as tso
    from avede_tpu_torch.services import universal_detector as tud

    jlog, tlog = _record_calls(monkeypatch, [
        (jdet.YoloService, tdet.YoloService, "detect"),
        (jud.UniversalDetector, tud.UniversalDetector,
         "detect_unlimited_objects")])
    jvid, tvid = _record_calls(monkeypatch, [
        (jso.SmallObjectService, tso.SmallObjectService,
         "detect_in_video")])
    ref = jeval.eval_detection(0, STEPS, STEPS)
    got = teval.eval_detection(0, STEPS, STEPS, device="cpu")
    _close(got, ref)
    # 32 frame-level calls, 2 seeds × 2 modes × (10 × 12 + 24), and the
    # video path's YOLO calls
    assert len(jlog) >= 32 + 576
    assert len(tlog) == len(jlog)
    for g, r in zip(tlog, jlog):
        _same_detections(g, r)
    assert sum(len(f) for call in jlog for f in call) > 0
    assert len(tvid) == len(jvid) == 1
    _same_detections([tvid[0]["results"]], [jvid[0]["results"]])


def test_detection_4k_mode_matches_jax(jeval, carried, monkeypatch):
    """One 3840 × 2160 frame of 220 tiles through both packages'
    ``SmallObjectService.detect_in_frame`` (the mode's own ``n_frames``
    and ``n_seeds``): the same mAP@0.5, counts and detections."""
    from avede_tpu.services import small_object as jso

    from avede_tpu_torch.services import small_object as tso

    jlog, tlog = _record_calls(monkeypatch, [
        (jso.SmallObjectService, tso.SmallObjectService, "detect_in_frame")])
    ref = jeval.eval_detection_4k(0, STEPS, n_frames=1, n_seeds=1)
    got = teval.eval_detection_4k(0, STEPS, n_frames=1, n_seeds=1,
                                  device="cpu")
    _close(got, ref)
    assert ref["tiles_per_frame"] == 220
    assert len(tlog) == len(jlog) == 1
    _same_detections(tlog, jlog)


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_modes_and_sections():
    """Every mode of the JAX package's ``main``, in its order, under its
    section names; nothing is left for later."""
    assert teval.MODES == ("image", "grounding", "text", "detection",
                           "detection4k", "person", "caption", "library",
                           "background")
    assert not hasattr(teval, "LATER_MODES")
    assert set(teval.SECTIONS) == set(teval.MODES)
    ref = json.loads((ROOT / "EVAL.json").read_text())
    assert set(teval.SECTIONS.values()) <= set(ref)


@pytest.mark.parametrize("mode", ["image", "text", "library", "caption",
                                  "background", "detection", "detection4k",
                                  "person", "all"])
def test_mode_needs_a_card_unless_asked_for_the_cpu(mode, monkeypatch):
    from avede_tpu_torch.utils.errors import ConfigurationError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError, match="device='cpu'"):
        teval.main(["--mode", mode])


def test_main_runs_a_mode_on_the_cpu(monkeypatch, tmp_path):
    """``--mode text --device cpu`` through ``main``, its steps cut by
    the test, writes its section with the device under ``meta``."""
    real = teval.eval_text_trained
    monkeypatch.setattr(teval, "eval_text_trained",
                        lambda seed, device: real(seed, steps=2, n_seeds=1,
                                                  device=device))
    out_file = tmp_path / "text.json"
    out = teval.main(["--mode", "text", "--device", "cpu",
                      "--out", str(out_file)])
    saved = json.loads(out_file.read_text())
    assert saved["meta"]["device"] == "cpu"
    # the CPU runs the kernels' plain versions: no launch is counted
    assert saved["meta"]["kernel_launches"] == {"text": {}}
    sec = saved["text_retrieval_trained"]
    assert sec == out["text_retrieval_trained"]
    ref = json.loads((ROOT / "EVAL.json").read_text())[
        "text_retrieval_trained"]
    assert set(sec) == set(ref) and sec["train_steps"] == 2
