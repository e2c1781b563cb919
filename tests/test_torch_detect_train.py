"""The port's detector trainers and synthetic builders against the JAX
package's, on the CPU.

- The synthetic builders (``utils/synthetic.py``): byte-equal outputs on
  the same ``np.random.Generator``, which ends in the same state (the
  same draws in the same order, the JPEG round trips included).
- ``cosine_decay_schedule``: optax's within 1e-6 relative.
- ``yolo_detection_loss`` and ``owl_detection_loss`` on seeded head
  outputs: loss and parts within 1e-6 relative, the gradient of every
  input within 1e-5 of its largest element (f32 sums in another order).
  The cases hold padded ground-truth rows (garbage boxes under a False
  mask), an image with no box, overlapping boxes and, for OWL-ViT, a box
  smaller than one grid cell (the forced-nearest branch).
- The ``person`` eval mode's scoring (``eval_person``) on carried
  weights, both packages' trainers and training batches stubbed alike
  (``tests/test_torch_eval.py`` holds the other modes): margins, the
  face detector's IoU, fusion weights and rank metrics within 1e-4, the
  same matches in every search.
- The train steps: four steps of each package's step from one set of
  weights (JAX's, carried by ``params_from_jax``) on the same batches:
  each loss within 1e-5 relative and every parameter within 1e-4, but
  for elements whose gradient is zero in exact arithmetic (OWL-ViT's key
  biases: softmax is shift invariant), where Adam steps both packages by
  about lr on rounding noise: within 2 · steps · lr. YOLO's BatchNorm
  statistics stay bit-equal to their start (they are frozen in both).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avede_tpu_torch.models.convert import params_from_jax
from tests.test_torch_detection import _filled, _np, _yolo_variables
from tests.test_torch_eval import (  # noqa: F401 — fixtures
    SCORE_ABS, _close, _record_calls, carried_clip, jeval)

LOSS_REL, GRAD_REL, PARAM_ABS = 1e-6, 1e-5, 1e-4
STEPS = 4


# ---------------------------------------------------------------------------
# synthetic builders
# ---------------------------------------------------------------------------

def _identities(mod, n=3):
    rng = np.random.default_rng(7)
    return [mod.make_identity(rng) for _ in range(n)]


_BUILDERS = {
    "shape_default": lambda m, r: m.draw_shape_scene(r),
    "shape_128_non_overlapping": lambda m, r: m.draw_shape_scene(
        r, hw=(128, 128), max_boxes=5, min_r=10, max_r=22,
        non_overlapping=True),
    "shape_tile_256": lambda m, r: m.draw_shape_scene(
        r, hw=(256, 256), max_boxes=3, min_r=12, max_r=48,
        non_overlapping=True),
    "shape_4k": lambda m, r: m.draw_shape_scene(
        r, hw=(2160, 3840), max_boxes=24, min_r=12, max_r=48,
        non_overlapping=True),
    "jitter_bbox": lambda m, r: np.asarray(
        m.jitter_bbox([10.0, 20.0, 50.0, 90.0], r, 0.06)),
    "identity_batch": lambda m, r: m.identity_batch(
        _identities(m), r, crop_size=64, codec_aug=True, box_jitter=0.08),
    "identity_batch_easy": lambda m, r: m.identity_batch(
        _identities(m), r, crop_size=32, codec_aug=False, box_jitter=0.0),
    "crop_bbox": lambda m, r: m.crop_bbox(
        r.integers(0, 255, (40, 30, 3)).astype(np.uint8),
        [-3.5, 12.2, 40.0, 17.9]),
    "face_detector_scene": lambda m, r: m.face_detector_scene(r),
    "face_batch": lambda m, r: m.face_batch(
        _identities(m), r, crop_size=32, codec_aug=True, box_jitter=0.10),
}


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_synthetic_builder_is_byte_equal(name):
    from avede_tpu.utils import synthetic as jsyn

    from avede_tpu_torch.utils import synthetic as tsyn

    assert tsyn.SHAPE_CLASSES == jsyn.SHAPE_CLASSES
    assert tsyn.SHAPE_COLORS == jsyn.SHAPE_COLORS
    seeds = (0,) if name == "shape_4k" else (0, 1, 2)
    for seed in seeds:
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        ref = _BUILDERS[name](jsyn, rj)
        got = _BUILDERS[name](tsyn, rt)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        # the same number of draws
        assert rt.integers(0, 2 ** 62) == rj.integers(0, 2 ** 62)


# ---------------------------------------------------------------------------
# schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("init,steps,alpha", [(3e-3, 700, 0.05),
                                              (1.0, 7, 0.0)])
def test_cosine_decay_schedule_matches_optax(init, steps, alpha):
    from avede_tpu_torch.parallel.optim import cosine_decay_schedule

    ref = optax.cosine_decay_schedule(init, steps, alpha=alpha)
    got = cosine_decay_schedule(init, steps, alpha)
    counts = list(range(0, steps + 3, max(steps // 50, 1)))
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(ref(c)) for c in counts], rtol=1e-6)
    assert got(0) == init and got(steps + 5) == pytest.approx(init * alpha)
    with pytest.raises(ValueError):
        cosine_decay_schedule(init, 0)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _gt(rng, b, m, scale):
    """Ground truth with padded rows holding garbage boxes, an image with
    no box (the last) and, in image 0, two overlapping boxes."""
    boxes = rng.uniform(0.0, 0.6, (b, m, 2))
    boxes = np.concatenate([boxes, boxes + rng.uniform(0.1, 0.4, (b, m, 2))],
                           -1).astype(np.float32) * scale
    boxes[0, 1] = boxes[0, 0] + np.float32(0.05 * scale)   # overlaps row 0
    labels = rng.integers(0, 4, (b, m)).astype(np.int32)
    mask = np.ones((b, m), bool)
    mask[1, m - 1:] = False          # a padded row ...
    boxes[1, m - 1] = [5.0, -3.0, 2.0, 9.0]   # ... holding garbage
    mask[b - 1] = False              # an image with no box
    return boxes, labels, mask


def _assert_grads(got, ref):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= GRAD_REL * np.abs(r).max()


def test_yolo_detection_loss_matches_jax():
    """Loss, parts and the gradient of every head output; the class
    target carries the predicted boxes' IoU, whose gradient both
    packages keep."""
    from avede_tpu.models.yolo import YoloConfig as JCfg
    from avede_tpu.parallel.train_det import yolo_detection_loss as jloss

    from avede_tpu_torch.models.yolo import YoloConfig
    from avede_tpu_torch.parallel.train_det import yolo_detection_loss

    rng = np.random.default_rng(0)
    jcfg, cfg = JCfg(num_classes=4, img_size=64), YoloConfig(num_classes=4,
                                                             img_size=64)
    b = 3
    outs = [(rng.normal(0, 1.5, (b, 64 // s, 64 // s, 64)).astype(np.float32),
             rng.normal(-1, 1.5, (b, 64 // s, 64 // s, 4)).astype(np.float32))
            for s in (8, 16, 32)]
    gb, gl, gm = _gt(rng, b, 4, 64.0)

    def jfn(outs):
        return jloss(outs, jcfg, jnp.asarray(gb), jnp.asarray(gl),
                     jnp.asarray(gm))

    (jl, jparts), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        [tuple(jnp.asarray(t) for t in o) for o in outs])
    touts = [tuple(torch.from_numpy(t).requires_grad_() for t in o)
             for o in outs]
    loss, parts = yolo_detection_loss(touts, cfg, torch.from_numpy(gb),
                                      torch.from_numpy(gl),
                                      torch.from_numpy(gm))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_REL * abs(float(jl))
    assert set(parts) == set(jparts) == {"cls", "dfl", "iou"}
    for k in parts:
        assert abs(float(parts[k]) - float(jparts[k])) \
            <= LOSS_REL * abs(float(jparts[k])), k
    assert float(parts["iou"]) > 0     # positives exist
    _assert_grads([t.grad for o in touts for t in o],
                  [t for o in jgrads for t in o])


def test_owl_detection_loss_matches_jax():
    """Loss, parts and the gradient of the logits and boxes; image 0 adds
    a box between grid centres, which only the forced-nearest patch
    holds."""
    from avede_tpu.models.owlvit import OwlViTConfig as JCfg
    from avede_tpu.parallel.train_owl import owl_detection_loss as jloss

    from avede_tpu_torch.models.owlvit import OwlViTConfig
    from avede_tpu_torch.parallel.train_owl import owl_detection_loss

    rng = np.random.default_rng(1)
    jcfg, cfg = (JCfg(image_size=64, patch_size=8),
                 OwlViTConfig(image_size=64, patch_size=8))
    b, p, q, m = 3, cfg.grid ** 2, 4, 5
    logits = rng.normal(0, 2, (b, p, q)).astype(np.float32)
    pboxes = (1 / (1 + np.exp(-rng.normal(0, 1, (b, p, 4))))
              ).astype(np.float32)
    gb, gl, gm = _gt(rng, b, m, 1.0)
    # centres lie at (i + 0.5) / 8: none inside [0.26, 0.29]
    gb[0, 2] = [0.26, 0.26, 0.29, 0.29]

    (jl, jparts), jgrads = jax.value_and_grad(
        lambda lg, pb: jloss(lg, pb, jcfg, jnp.asarray(gb), jnp.asarray(gl),
                             jnp.asarray(gm)),
        argnums=(0, 1), has_aux=True)(jnp.asarray(logits),
                                      jnp.asarray(pboxes))
    tl, tp = (torch.from_numpy(a).requires_grad_() for a in (logits, pboxes))
    loss, parts = owl_detection_loss(tl, tp, cfg, torch.from_numpy(gb),
                                     torch.from_numpy(gl),
                                     torch.from_numpy(gm))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_REL * abs(float(jl))
    assert set(parts) == set(jparts) == {"cls", "box"}
    for k in parts:
        assert abs(float(parts[k]) - float(jparts[k])) \
            <= LOSS_REL * abs(float(jparts[k])), k
    _assert_grads([tl.grad, tp.grad], jgrads)
    # the tiny box trains its nearest patch: its box loss moves
    assert float(tp.grad[0].abs().sum()) > 0


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _scenes(n, hw, max_boxes):
    from avede_tpu_torch.utils.synthetic import draw_shape_scene

    rng = np.random.default_rng(3)
    out = []
    for _ in range(STEPS):
        data = [draw_shape_scene(rng, hw=hw, max_boxes=max_boxes)
                for _ in range(n)]
        out.append([np.stack([d[i] for d in data]) for i in range(4)])
    return out


def _shift_invariant(name):
    return name.endswith("k_proj.bias")


def _assert_params_close(module, ref_sd, lr):
    worst = 0.0
    for k, v in module.state_dict().items():
        diff = float((v - torch.as_tensor(ref_sd[k])).abs().max())
        if _shift_invariant(k):
            assert diff <= 2 * STEPS * lr, k
        else:
            worst = max(worst, diff)
    assert worst <= PARAM_ABS, worst


def _run(jstep, jstate, step, state, batches, lr):
    for batch in batches:
        jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in batch))
        state, m = step(state, *(torch.from_numpy(a) for a in batch))
        jl = float(jm["loss"])
        assert abs(float(m["loss"]) - jl) <= 1e-5 * abs(jl)
        assert set(m) == set(jm) | {"grad_norm"}
    return jstate


def test_yolo_train_step_matches_jax(monkeypatch):
    """JAX's ``create_yolo_train_state`` (its init swapped for seeded
    variables with BatchNorm statistics away from the identity) and the
    port's, carried over; four steps on 64 px scenes with padded rows."""
    from avede_tpu.models.yolo import YoloConfig as JCfg
    from avede_tpu.parallel import train_det as jdet

    from avede_tpu_torch.models.yolo import YoloConfig
    from avede_tpu_torch.parallel.train_det import (create_yolo_train_state,
                                                    make_yolo_train_step)

    lr = 2e-3
    jcfg = JCfg(num_classes=4, img_size=64)
    jmodel, variables = _yolo_variables(jcfg, seed=2)
    monkeypatch.setattr(jdet, "init_yolo", lambda cfg, seed: (jmodel,
                                                              variables))
    _, jstate, extra = jdet.create_yolo_train_state(jcfg, lr)
    jstep = jdet.make_yolo_train_step(jmodel, extra)
    model, state = create_yolo_train_state(
        YoloConfig(num_classes=4, img_size=64), lr, device="cpu")
    model.load_state_dict(params_from_jax(_np(variables)))
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running" in k}
    jstate = _run(jstep, jstate, make_yolo_train_step(model), state,
                  _scenes(4, (64, 64), 3), lr)
    _assert_params_close(model, params_from_jax(_np(
        {"params": jstate.params, **extra})), lr)
    for k, v in stats.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert stats and not any(".running" in n
                             for n, _ in model.named_parameters())


def test_owl_train_step_matches_jax(monkeypatch):
    """The ``detection`` mode's OWL-ViT (64 px, patch 8, 4 heads of 24):
    JAX's ``create_owl_train_state`` on seeded weights and the port's,
    four steps on 128 px scenes through ``clip_preprocess``."""
    from avede_tpu.models.owlvit import OwlViTConfig as JCfg
    from avede_tpu.models.owlvit import OwlViTDetector as JDet
    from avede_tpu.parallel import train_owl as jowl

    from avede_tpu_torch.eval import DETECTION_OWL
    from avede_tpu_torch.models.owlvit import OwlViTConfig
    from avede_tpu_torch.parallel.train_owl import (create_owl_train_state,
                                                    make_owl_train_step)

    lr = 1e-3
    jcfg = JCfg(**DETECTION_OWL)
    jmodel = JDet(jcfg)
    params = _filled(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((4, 8), jnp.int32)), seed=3)["params"]
    monkeypatch.setattr(jowl, "init_owlvit", lambda cfg, seed: (jmodel,
                                                                params))
    _, jstate = jowl.create_owl_train_state(jcfg, lr)
    ids = np.random.default_rng(4).integers(1, 255, (4, 8)).astype(np.int32)
    jstep = jowl.make_owl_train_step(jmodel, ids)
    model, state = create_owl_train_state(OwlViTConfig(**DETECTION_OWL), lr,
                                          device="cpu")
    model.load_state_dict(params_from_jax(_np(params)))
    batches = [[a if i != 1 else (a / 128.0).astype(np.float32)
                for i, a in enumerate(b)]
               for b in _scenes(2, (128, 128), 5)]
    jstate = _run(jstep, jstate, make_owl_train_step(model, ids), state,
                  batches, lr)
    _assert_params_close(model, params_from_jax(_np(jstate.params)), lr)


def test_owl_training_refuses_flash():
    import dataclasses

    from avede_tpu_torch.eval import DETECTION_OWL
    from avede_tpu_torch.models.owlvit import OwlViTConfig
    from avede_tpu_torch.parallel.train_owl import create_owl_train_state

    cfg = dataclasses.replace(OwlViTConfig(**DETECTION_OWL), use_flash=True)
    with pytest.raises(ValueError, match="use_flash=False"):
        create_owl_train_state(cfg, device="cpu")


@pytest.mark.parametrize("name", ["yolo", "reid"])
def test_train_step_runs_convolutions_in_f32(name):
    """A conv trainer's step turns cuDNN's TF32 off for its forward and
    backward (PyTorch allows it by default) and restores the flag."""
    from avede_tpu_torch.models.appearance import tiny_appearance_config
    from avede_tpu_torch.models.yolo import YoloConfig
    from avede_tpu_torch.parallel.train_det import (create_yolo_train_state,
                                                    make_yolo_train_step)
    from avede_tpu_torch.parallel.train_reid import (create_reid_train_state,
                                                     make_reid_train_step)

    if name == "yolo":
        model, state = create_yolo_train_state(
            YoloConfig(num_classes=4, img_size=64), device="cpu")
        step = make_yolo_train_step(model)
        args = [torch.from_numpy(a) for a in _scenes(2, (64, 64), 3)[0]]
    else:
        model, state = create_reid_train_state(tiny_appearance_config(),
                                               device="cpu")
        step = make_reid_train_step(model)
        size = tiny_appearance_config().input_size
        args = [torch.rand(4, size, size, 3) for _ in range(2)]
    seen = []
    model.register_forward_hook(
        lambda *_: seen.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        step(state, *args)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert seen and not any(seen)


# ---------------------------------------------------------------------------
# the person eval mode
# ---------------------------------------------------------------------------

def test_person_mode_matches_jax(jeval, carried_clip, monkeypatch):
    """JAX's ``eval_person`` and the port's on the same carried weights
    (seeded encoders, face-region and person YOLOs; their trainers and
    training batches stubbed alike in both, so the numpy draws of the
    scoring stay aligned): the identity and face margins, the face
    detector's IoU, the fitted fusion weights, the five ablations' rank
    metrics, and every search's matches."""
    import types

    import cv2

    from avede_tpu.models.appearance import AppearanceConfig as JCfg
    from avede_tpu.models.appearance import init_appearance
    from avede_tpu.models.appearance import tiny_appearance_config
    from avede_tpu.models.yolo import YoloConfig as JYolo
    from avede_tpu.parallel import train_reid as jreid
    from avede_tpu.services import person_detector as jpd
    from avede_tpu.utils import synthetic as jsyn

    from avede_tpu_torch import eval as teval
    from avede_tpu_torch.services import person_detector as tpd

    enc = {c.input_size: _filled(lambda c=c: init_appearance(c, seed=0)[1],
                                 seed=c.input_size)
           for c in (tiny_appearance_config(),
                     JCfg(input_size=32, widths=(16, 32, 32, 64),
                          embed_dim=64))}
    yolos = {}
    for img_size in (64, 128):
        cfg = JYolo(num_classes=1, img_size=img_size)
        yolos[img_size] = (cfg, _yolo_variables(cfg, seed=img_size)[1])
    stub = np.zeros((1, 1, 1, 3), np.float32)
    for name in ("identity_batch", "face_batch"):
        monkeypatch.setattr(jsyn, name, lambda *a, **k: (stub, stub))
    monkeypatch.setattr(jreid, "create_reid_train_state", lambda cfg, **k: (
        None, types.SimpleNamespace(params=enc[cfg.input_size])))
    monkeypatch.setattr(jreid, "make_reid_train_step", lambda model: (
        lambda state, a, b: (state, {"loss": 0.25})))
    monkeypatch.setattr(jeval, "_train_tiny_yolo", lambda *a, img_size, **k: (
        yolos[img_size][0], yolos[img_size][1], 0.5))

    from avede_tpu_torch.models.yolo import YoloConfig

    monkeypatch.setattr(teval, "_train_appearance", lambda cfg, *a: (
        params_from_jax(_np(enc[cfg.input_size])), 0.25))
    monkeypatch.setattr(teval, "_train_tiny_yolo", lambda *a, img_size, **k: (
        YoloConfig(num_classes=1, img_size=img_size),
        params_from_jax(_np(yolos[img_size][1])), 0.5))
    jlog, tlog = _record_calls(monkeypatch, [
        (jpd.PersonSearchService, tpd.PersonSearchService,
         "process_video_for_person")])
    cv2.setRNGSeed(0)
    ref = jeval.eval_person(0, reid_steps=8, det_steps=8)
    cv2.setRNGSeed(0)
    got = teval.eval_person(0, reid_steps=8, det_steps=8, device="cpu")
    _close(got, ref)
    assert ref["fusion_val_candidates"] > 0
    assert len(tlog) == len(jlog) == 5
    for g, r in zip(tlog, jlog):
        assert [m["frame_index"] for m in g["matches"]] \
            == [m["frame_index"] for m in r["matches"]]
        np.testing.assert_allclose([m["similarity"] for m in g["matches"]],
                                   [m["similarity"] for m in r["matches"]],
                                   atol=SCORE_ABS)
    assert sum(len(r["matches"]) for r in jlog) > 0


def test_person_mode_serves_each_target_on_the_same_data(monkeypatch):
    """``eval_person``'s ``serve`` pairs score one set of trained weights
    (the trainers stubbed with seeded weights) on the same drawn data: a
    pair served twice gives the same metrics exactly (each pass seeds
    cv2's RNG, which GrabCut draws from), the top-level metrics are the
    first pair's, and a bf16 pair builds the YOLOs and the CLIP in bf16
    (the encoders stay f32), with rank metrics in [0, 1]. One detection
    a frame keeps the searches short."""
    from avede_tpu_torch import eval as teval
    from avede_tpu_torch.models.appearance import init_appearance
    from avede_tpu_torch.models.yolo import YoloConfig, init_yolo
    from avede_tpu_torch.services import detector as tdet
    from avede_tpu_torch.utils.config import settings

    def stub_yolo(*a, img_size, **k):
        cfg = YoloConfig(num_classes=1, img_size=img_size)
        return cfg, init_yolo(cfg, seed=img_size).state_dict(), 0.5

    monkeypatch.setattr(teval, "_train_appearance", lambda cfg, *a: (
        init_appearance(cfg, seed=cfg.input_size).state_dict(), 0.25))
    monkeypatch.setattr(teval, "_train_tiny_yolo", stub_yolo)
    monkeypatch.setattr(settings, "DETECTION_MAX_OBJECTS", 1)
    dtypes = []
    real_engine, real_yolo = teval.tiny_clip_engine, tdet.YoloService.__init__
    monkeypatch.setattr(teval, "tiny_clip_engine", lambda dev, dtype: (
        dtypes.append(("clip", dtype)) or real_engine(dev, dtype=dtype)))
    monkeypatch.setattr(tdet.YoloService, "__init__", lambda self, cfg, **k: (
        dtypes.append(("yolo", cfg.dtype)) or real_yolo(self, cfg, **k)))
    out = teval.eval_person(0, reid_steps=8, det_steps=8, device="cpu",
                            serve=(("cpu", "bfloat16"), ("cpu", "bfloat16")))
    first, again = out["served_on"]
    assert first["dtype"] == "bfloat16" and again == first
    assert all(out[k] == v for k, v in first.items()
               if k not in ("device", "dtype"))
    assert dtypes == [("yolo", "bfloat16"), ("yolo", "bfloat16"),
                      ("clip", "bfloat16")] * 2
    for k in ("person_precision_at_k", "person_frame_precision_at_k",
              "person_recall_at_k"):
        assert 0.0 <= first[k] <= 1.0, k
    assert first["fusion_val_candidates"] > 0
    assert np.isfinite(first["identity_margin"])
