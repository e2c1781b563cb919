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


def _assert_params_close(got, ref, steps):
    assert set(got) == set(ref)
    worst = 0.0
    for k, v in ref.items():
        diff = (got[k].float() - v).abs()
        if k.endswith(("k_proj.bias", "attn.key.bias")):
            assert float(diff.max()) <= 2 * steps * _lr(steps), k
            continue
        if k.endswith("qkv.bias"):
            d = diff.shape[0] // 3
            assert float(diff[d:2 * d].max()) <= 2 * steps * _lr(steps), k
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
# the command line
# ---------------------------------------------------------------------------

def test_modes_and_sections():
    assert teval.MODES == ("image", "grounding", "text", "library",
                           "caption", "background")
    assert teval.LATER_MODES == ("detection", "detection4k", "person")
    assert set(teval.SECTIONS) == set(teval.MODES)


@pytest.mark.parametrize("mode", ["image", "text", "library", "caption",
                                  "background"])
def test_mode_needs_a_card_unless_asked_for_the_cpu(mode, monkeypatch):
    from avede_tpu_torch.utils.errors import ConfigurationError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError, match="device='cpu'"):
        teval.main(["--mode", mode])


def test_main_runs_a_mode_on_the_cpu(monkeypatch, tmp_path):
    """``--mode text --device cpu`` through ``main``, its steps cut by
    the test, writes its section with the device under ``meta``."""
    import json

    real = teval.eval_text_trained
    monkeypatch.setattr(teval, "eval_text_trained",
                        lambda seed, device: real(seed, steps=2, n_seeds=1,
                                                  device=device))
    out_file = tmp_path / "text.json"
    out = teval.main(["--mode", "text", "--device", "cpu",
                      "--out", str(out_file)])
    saved = json.loads(out_file.read_text())
    assert saved["meta"]["device"] == "cpu"
    sec = saved["text_retrieval_trained"]
    assert sec == out["text_retrieval_trained"]
    ref = json.loads((ROOT / "EVAL.json").read_text())[
        "text_retrieval_trained"]
    assert set(sec) == set(ref) and sec["train_steps"] == 2
