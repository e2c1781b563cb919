"""Accuracy evaluation of the port (counterpart of the repository's
``eval.py``), one function per mode, with the JAX package's protocols,
seeds, data and output keys:

- ``image`` — reference-image retrieval: four textured subjects in an
  ``mp4v`` video written by cv2, each found by ``ImageMatcher`` in
  ``traditional`` mode with an untrained tiny CLIP (p@1, recall@5);
- ``grounding`` — temporal localization: train the grounding head
  (``models/univtg.py``) on synthetic (features, segment) pairs, then
  measure the temporal IoU of the segments that
  ``Phase3Temporal.ground_query`` returns for held-out samples;
- ``text`` — a tiny CLIP trained contrastively on 16 (shape, colour)
  classes (``_train_tiny_clip``), then text → video retrieval through
  ``Phase1Scan`` (p@1);
- ``library`` — the same trained CLIP, the classes spread over four
  videos, whole-library search through ``LibrarySearch`` and its bf16
  device index (video@1, hit@1);
- ``caption`` — a tiny BLIP trained teacher-forced on the class
  captions, then ``CaptionService``'s greedy captions (exact match) and
  caption → query similarity (rerank pairs);
- ``background`` — the trained CLIP behind
  ``BackgroundIndependentService``: an object on one background matched
  to its reference on another (success rate, beside a raw-crop CLIP
  baseline).

    python -m avede_tpu_torch.eval --mode {image,grounding,text,library,
        caption,background} [--seed 0] [--out results.json]
        [--device cpu]

Training runs in f32 through plain PyTorch (as the JAX package trains
through XLA); the trained weights are served in the device's compute
dtype, through the kernels on a card (the tiny towers' patch embed at
P = 8 and flash attention at head dim 16). It runs on ``cuda`` unless
``--device`` says otherwise, and raises without a card. ``--out`` writes
the results with the device's name (and on a card its power limit) under
``meta``; the JAX package's ``EVAL.json`` is never written. The modes
``detection``, ``detection4k`` and ``person`` wait for ROADMAP.md's item
8b (their detector trainers).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import tempfile
import types
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .utils.platform import resolve_device

MODES = ("image", "grounding", "text", "library", "caption",
         "background")
LATER_MODES = ("detection", "detection4k", "person")
# each mode's section of the output, as the JAX package names it
SECTIONS = {"image": "image_retrieval", "grounding": "temporal_grounding",
            "text": "text_retrieval_trained",
            "library": "library_search_trained",
            "caption": "caption_trained",
            "background": "background_independence"}


def _spread_into(out: dict, prefix: str, vals) -> None:
    """The across-seed aggregation (``eval.py:41-48``): the mean under
    ``prefix``, the least and the population std under ``<prefix>_min``
    and ``<prefix>_std``."""
    out[prefix] = float(np.mean(vals))
    out[f"{prefix}_min"] = float(np.min(vals))
    out[f"{prefix}_std"] = float(np.std(vals))


# ---------------------------------------------------------------------------
# image retrieval (``eval.py:51-131``)
# ---------------------------------------------------------------------------

def tiny_clip_engine(device, state_dict: Optional[Dict] = None):
    """A ``ClipEngine`` on the tiny CLIP (32 px, patch 8, width 64) in the
    device's compute dtype: ``state_dict``'s weights, else random from
    seed 0."""
    from .models.clip import tiny_test_config
    from .parallel.embed import ClipEngine
    from .utils.platform import with_compute_dtype

    dev = resolve_device(device)
    return ClipEngine(cfg=with_compute_dtype(tiny_test_config(), dev),
                      state_dict=state_dict, device=dev, seed=0)


def _write_video(path: str, frames, fps: float, size) -> None:
    """RGB frames → an ``mp4v`` ``.mp4`` written by cv2 (BGR)."""
    import cv2

    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    for frame in frames:
        w.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    w.release()


def eval_image_retrieval(seed: int = 0, n_subjects: int = 4,
                         n_seeds: int = 2, device=None) -> dict:
    """Reference-image retrieval through the port's ``ImageMatcher``
    (``eval.py:51``): per seed, the across-seed mean with min and std."""
    from .parallel.embed import ClipEngine
    from .utils.config import settings

    dev = resolve_device(device)
    # a configured checkpoint serves; else the untrained tiny CLIP
    engine = (ClipEngine(device=dev) if settings.CLIP_WEIGHTS
              else tiny_clip_engine(dev))
    runs = [_image_retrieval_run(seed + i, n_subjects, engine)
            for i in range(n_seeds)]
    out = {"per_seed": runs, "n_seeds": len(runs),
           "n_subjects": n_subjects}
    _spread_into(out, "precision_at_1",
                 [r["precision_at_1"] for r in runs])
    _spread_into(out, "recall_at_5", [r["recall_at_5"] for r in runs])
    return out


def _image_retrieval_run(seed: int, n_subjects: int, engine) -> dict:
    """One seed of ``eval.py:66``'s protocol: ``n_subjects`` textured
    40 px patches, each shown for 2 s (8 frames at 4 fps) of a 160×120
    video with 2 s of background between; each subject's frame as the
    reference, ``traditional`` mode at threshold 0, top 5 (the classical
    stages carry the signal of an untrained CLIP)."""
    from .io.embedding_cache import EmbeddingCache
    from .services.image_matcher import ImageMatcher

    rng = np.random.default_rng(seed)
    patches = [rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)
               for _ in range(n_subjects)]

    def show(patch):
        frame = np.full((120, 160, 3), 60, np.uint8)
        if patch is not None:
            frame[40:80, 60:100] = patch
        return frame

    subjects = [show(p) for p in patches]
    fps, span = 4.0, 8
    frames, gt, t = [], {}, 0
    for si, patch in enumerate(patches):
        gt[si] = (t / fps, (t + span) / fps)
        frames += [show(patch)] * span + [show(None)] * span
        t += 2 * span
    with tempfile.TemporaryDirectory(prefix="avede_eval_") as tmp:
        video = os.path.join(tmp, "eval.mp4")
        _write_video(video, frames, fps, (160, 120))
        matcher = ImageMatcher(engine, cache=EmbeddingCache(
            os.path.join(tmp, "embeddings")))
        hits = p_at_1 = 0
        for si, subj in enumerate(subjects):
            matches = matcher.match_image_to_video(
                video, subj, mode="traditional", threshold=0.0, top_k=5,
                video_id=f"eval_{seed}_{si}")
            lo, hi = gt[si]
            if matches and lo - 0.3 <= matches[0]["timestamp"] <= hi + 0.3:
                p_at_1 += 1
            if any(lo - 0.3 <= m["timestamp"] <= hi + 0.3 for m in matches):
                hits += 1
    return {"precision_at_1": p_at_1 / n_subjects,
            "recall_at_5": hits / n_subjects,
            "n_subjects": n_subjects}


# ---------------------------------------------------------------------------
# the 16 (shape, colour) classes and the tiny CLIP trained on them
# (``eval.py:266-346``)
# ---------------------------------------------------------------------------

SHAPES = ("square", "circle", "triangle", "stripe")
COLORS = {"red": (220, 40, 40), "green": (40, 200, 60),
          "blue": (50, 80, 220), "yellow": (230, 220, 40)}


def _draw(shape: str, color, rng, size: int = 32) -> np.ndarray:
    """One (shape, colour) render on a background level drawn from
    dark to bright, jittered in place and size, with ±10 noise: the JAX
    package's draws, call for call."""
    import cv2

    img = np.full((size, size, 3), rng.integers(20, 200), np.uint8)
    c = tuple(int(v) for v in color)
    cx = size // 2 + int(rng.integers(-3, 4))
    cy = size // 2 + int(rng.integers(-3, 4))
    r = size // 4 + int(rng.integers(-2, 3))
    if shape == "square":
        cv2.rectangle(img, (cx - r, cy - r), (cx + r, cy + r), c, -1)
    elif shape == "circle":
        cv2.circle(img, (cx, cy), r, c, -1)
    elif shape == "triangle":
        pts = np.array([[cx, cy - r], [cx - r, cy + r], [cx + r, cy + r]])
        cv2.fillPoly(img, [pts], c)
    else:  # stripe
        cv2.rectangle(img, (0, cy - 3), (size, cy + 3), c, -1)
    noise = rng.integers(-10, 10, img.shape)
    return np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)


def _pairs() -> List[Tuple[str, str]]:
    return [(s, c) for s in SHAPES for c in COLORS]


def _train_tiny_clip(seed: int, steps: int = 700, device=None,
                     init: Optional[Dict] = None):
    """``eval.py:299``: the tiny CLIP from ``seed`` (or ``init``'s
    weights) trained contrastively in f32 on a batch of the 16 classes a
    step (a fresh draw each) with Adam under warmup → cosine (peak
    1.5e-3, warmup 50) → (engine serving the trained weights, pairs,
    last loss)."""
    from .models.clip import init_clip, tiny_test_config
    from .models.tokenizer import Tokenizer
    from .ops.preprocess import clip_preprocess
    from .parallel.optim import adam, warmup_cosine_decay_schedule
    from .parallel.train import TrainState, make_train_step

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cfg = tiny_test_config()
    tok = Tokenizer(bpe_path=None, vocab_size=cfg.vocab_size,
                    context_len=cfg.max_text_len)
    model = init_clip(cfg, seed=seed)
    if init is not None:
        model.load_state_dict(init)
    model = model.to(dev).train()
    state = TrainState(model, adam(model.parameters(),
                                   warmup_cosine_decay_schedule(
                                       0.0, 1.5e-3, warmup_steps=50,
                                       decay_steps=max(steps, 51))))
    step = make_train_step(model)
    pairs = _pairs()
    caps = [f"a {c} {s}" for s, c in pairs]
    ids = torch.from_numpy(tok(caps)).to(dev)
    metrics = None
    for _ in range(steps):
        imgs = np.stack([_draw(s, COLORS[c], rng) for s, c in pairs])
        px = clip_preprocess(torch.from_numpy(imgs).to(dev),
                             size=cfg.image_size)
        state, metrics = step(state, px, ids)
    loss = float(metrics["loss"]) if metrics else float("nan")
    engine = tiny_clip_engine(dev, {k: v.detach() for k, v in
                                    model.state_dict().items()})
    return engine, pairs, loss


def _class_video(path: str, order, rng) -> Dict[Tuple[str, str],
                                               Tuple[float, float]]:
    """The classes of ``order`` for 2 s each (8 draws at 4 fps, 64 px by
    nearest-neighbour) in one ``mp4v`` video → each class's span."""
    import cv2

    fps, span = 4.0, 8
    frames, gt = [], {}
    for s, c in order:
        gt[(s, c)] = (len(frames) / fps, (len(frames) + span) / fps)
        frames += [cv2.resize(_draw(s, COLORS[c], rng), (64, 64),
                              interpolation=cv2.INTER_NEAREST)
                   for _ in range(span)]
    _write_video(path, frames, fps, (64, 64))
    return gt


def eval_text_trained(seed: int = 0, steps: int = 700, n_seeds: int = 2,
                      device=None) -> dict:
    """``eval.py:349``: per seed a tiny CLIP trained for ``steps`` steps,
    then text → video retrieval through ``Phase1Scan``; the across-seed
    mean with min and std."""
    runs = [_text_trained_run(seed + i, steps, device)
            for i in range(n_seeds)]
    out = {"per_seed": runs, "n_seeds": len(runs)}
    _spread_into(out, "precision_at_1",
                 [r["precision_at_1"] for r in runs])
    out["classes"] = runs[0]["classes"]
    out["train_steps"] = steps
    out["final_train_loss"] = runs[0]["final_train_loss"]
    return out


def _text_trained_run(seed: int, steps: int, device=None,
                      trained=None) -> dict:
    """One seed of ``eval.py:366``: the 16 classes in shuffled order in
    one video; each class's caption must put its top window (top 3,
    threshold -1, no embedding cache) within 1.1 s of its span.
    ``trained``: ``_train_tiny_clip``'s result, else trained here."""
    from .pipelines.phase1 import Phase1Scan

    rng = np.random.default_rng(seed)
    engine, pairs, loss = trained or _train_tiny_clip(seed, steps, device)
    order = list(pairs)
    rng.shuffle(order)
    with tempfile.TemporaryDirectory(prefix="avede_txt_") as tmp:
        video = os.path.join(tmp, "shapes.mp4")
        gt = _class_video(video, order, rng)
        scan = Phase1Scan(engine, cache=None)
        scan.cache = None
        hits = 0
        for s, c in pairs:
            results = scan.process_video(video, f"a {c} {s}", top_k=3,
                                         threshold=-1.0,
                                         video_id=f"txt_{s}_{c}")
            lo, hi = gt[(s, c)]
            if results and lo - 1.1 <= results[0]["timestamp"] <= hi + 1.1:
                hits += 1
    return {"precision_at_1": hits / len(pairs),
            "classes": len(pairs), "train_steps": steps,
            "final_train_loss": float(loss)}


def eval_library(seed: int = 0, steps: int = 700, n_videos: int = 4,
                 n_seeds: int = 2, device=None) -> dict:
    """``eval.py:408``: the 16 trained classes spread over ``n_videos``
    videos; a whole-library search for each class must surface the right
    video (video@1) at the right second (hit@1) through ``LibrarySearch``
    and its device index. The across-seed mean with min and std."""
    runs = [_library_run(seed + i, steps, n_videos, device)
            for i in range(n_seeds)]
    out = {"per_seed": runs, "n_seeds": len(runs)}
    _spread_into(out, "video_at_1", [r["video_at_1"] for r in runs])
    _spread_into(out, "hit_at_1", [r["hit_at_1"] for r in runs])
    for k in ("classes", "videos", "frames_indexed", "index_dtype",
              "train_steps", "final_train_loss"):
        out[k] = runs[0][k]
    return out


def _library_run(seed: int, steps: int, n_videos: int, device=None,
                 trained=None) -> dict:
    """One seed of ``eval.py:427``, in a temporary video and embedding
    directory (the settings are restored after). ``trained``:
    ``_train_tiny_clip``'s result, else trained here."""
    from .pipelines.phase1 import Phase1Scan
    from .services.library_search import LibrarySearch
    from .utils.config import settings

    rng = np.random.default_rng(seed)
    engine, pairs, loss = trained or _train_tiny_clip(seed, steps, device)
    old = settings.VIDEO_DIR, settings.EMBEDDING_DIR
    with tempfile.TemporaryDirectory(prefix="avede_lib_") as tmp:
        settings.VIDEO_DIR = os.path.join(tmp, "videos")
        settings.EMBEDDING_DIR = os.path.join(tmp, "embeddings")
        os.makedirs(settings.VIDEO_DIR)
        os.makedirs(settings.EMBEDDING_DIR)
        try:
            order = list(pairs)
            rng.shuffle(order)
            per_video = len(order) // n_videos
            gt = {}   # (shape, colour) → (video id, lo, hi)
            for v in range(n_videos):
                vid = f"lib{v}"
                spans = _class_video(
                    os.path.join(settings.VIDEO_DIR, f"{vid}.mp4"),
                    order[v * per_video:(v + 1) * per_video], rng)
                gt.update({k: (vid, lo, hi) for k, (lo, hi)
                           in spans.items()})
            search = LibrarySearch(Phase1Scan(engine))
            video_hits = time_hits = 0
            for (s, c), (vid, lo, hi) in gt.items():
                out = search.search(f"a {c} {s}", top_k=1, threshold=-1.0)
                res = out["results"]
                if res and res[0]["video_id"] == vid:
                    video_hits += 1
                    if lo - 1.1 <= res[0]["timestamp"] <= hi + 1.1:
                        time_hits += 1
            meta = out["metadata"]
        finally:
            settings.VIDEO_DIR, settings.EMBEDDING_DIR = old
    return {"video_at_1": video_hits / len(gt),
            "hit_at_1": time_hits / len(gt),
            "classes": len(gt), "videos": n_videos,
            "frames_indexed": meta.get("index", {}).get("rows", 0),
            "index_dtype": meta.get("index", {}).get("dtype"),
            "train_steps": steps,
            "final_train_loss": float(loss)}


# ---------------------------------------------------------------------------
# captions (``eval.py:498-609``)
# ---------------------------------------------------------------------------

SHAPE_WORDS = ["a", "red", "green", "blue", "yellow",
               "square", "circle", "triangle", "stripe"]


def _shapes_wordpiece_vocab(path: str, cfg) -> None:
    """A ``vocab.txt`` on BLIP's special ids: [PAD] = pad, [DEC] = bos,
    [SEP] = eos; the caption words at low ids."""
    words = ["[PAD]", "[UNK]", "[CLS]"] + SHAPE_WORDS
    vocab = words + [f"[unused{i}]" for i in range(cfg.vocab_size
                                                   - len(words))]
    vocab[cfg.bos_token_id] = "[DEC]"
    vocab[cfg.eos_token_id] = "[SEP]"
    with open(path, "w") as f:
        f.write("\n".join(vocab))


def eval_caption(seed: int = 0, steps: int = 700, device=None) -> dict:
    """``eval.py:514``: two trained tiny BLIPs (seeds ``seed`` and
    ``seed + 1``), the across-seed mean with min and std."""
    runs = [_caption_run(s, steps, device) for s in (seed, seed + 1)]
    out = {"caption_per_seed": [
        {k: r[k] for k in ("seed", "caption_exact_match",
                           "rerank_pairs_correct", "final_train_loss")}
        for r in runs]}
    for metric in ("caption_exact_match", "rerank_pairs_correct"):
        _spread_into(out, metric, [r[metric] for r in runs])
    out["n_seeds"] = len(runs)
    out["examples"] = runs[0]["examples"]
    out["final_train_loss"] = runs[0]["final_train_loss"]
    out["train_steps"] = steps
    return out


def _caption_ids(tok, cfg, texts) -> np.ndarray:
    out = np.full((len(texts), cfg.max_caption_len), cfg.pad_token_id,
                  np.int32)
    for i, t in enumerate(texts):
        ids = [cfg.bos_token_id] + tok.encode(t) + [cfg.eos_token_id]
        out[i, : len(ids)] = ids
    return out


def _train_tiny_blip(rng, vocab_path: str, seed: int, steps: int,
                     device=None, init: Optional[Dict] = None):
    """``eval.py:533-583``'s training: the tiny BLIP from ``seed`` (or
    ``init``'s weights) in f32 with plain attention, teacher-forced on
    the 16 class captions (a fresh draw of images each step, from
    ``rng``), clip 1.0 + Adam under warmup → cosine (peak 1.5e-3) →
    (trained state dict, last loss)."""
    from .models.blip import init_blip, tiny_blip_config
    from .models.tokenizer import WordPieceTokenizer
    from .ops.preprocess import blip_preprocess
    from .parallel.optim import adam, warmup_cosine_decay_schedule
    from .parallel.train import TrainState, make_caption_train_step

    dev = resolve_device(device)
    cfg = dataclasses.replace(tiny_blip_config(), use_flash=False)
    tok = WordPieceTokenizer(vocab_path)
    model = init_blip(cfg, seed=seed)
    if init is not None:
        model.load_state_dict(init)
    model = model.to(dev).train()
    state = TrainState(model, adam(
        model.parameters(), warmup_cosine_decay_schedule(
            0.0, 1.5e-3, warmup_steps=50, decay_steps=max(steps, 51)),
        clip_norm=1.0))
    step = make_caption_train_step(model, cfg.pad_token_id)
    pairs = _pairs()
    ids = torch.from_numpy(_caption_ids(
        tok, cfg, [f"a {c} {s}" for s, c in pairs])).to(dev)
    loss = None
    for _ in range(steps):
        imgs = np.stack([_draw(s, COLORS[c], rng) for s, c in pairs])
        px = blip_preprocess(torch.from_numpy(imgs).to(dev),
                             size=cfg.image_size)
        state, m = step(state, px, ids)
        loss = float(m["loss"])
    return {k: v.detach() for k, v in model.state_dict().items()}, loss


def _caption_run(seed: int, steps: int, device=None) -> dict:
    """One seed of ``eval.py:533``: train, then serve the trained BLIP
    through ``CaptionService`` (the device's compute dtype, flash on a
    card) beside an untrained tiny CLIP for the text side."""
    from .models.blip import tiny_blip_config
    from .services.captioner import CaptionService
    from .utils.platform import with_compute_dtype

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory(prefix="avede_cap_") as tmp:
        vocab_path = os.path.join(tmp, "vocab.txt")
        _shapes_wordpiece_vocab(vocab_path, tiny_blip_config())
        state_dict, loss = _train_tiny_blip(rng, vocab_path, seed, steps,
                                            dev)
        svc = CaptionService(
            tiny_clip_engine(dev),
            cfg=with_compute_dtype(tiny_blip_config(), dev),
            state_dict=state_dict, vocab_path=vocab_path)
        return _caption_scores(svc, rng, seed, steps, loss)


def _caption_scores(svc, rng, seed: int, steps: int, loss) -> dict:
    """A fresh draw of the 16 classes captioned by ``svc``: the share of
    captions equal to their class caption, and of caption → query
    similarities that rank the class's query above a wrong one (colour
    and shape both changed)."""
    pairs = _pairs()
    imgs = np.stack([_draw(s, COLORS[c], rng) for s, c in pairs])
    caps = svc.caption_frames(imgs)
    gt = [f"a {c} {s}" for s, c in pairs]
    exact = sum(c == g for c, g in zip(caps, gt)) / len(gt)
    sims_ok = 0
    for cap, (s, c) in zip(caps, pairs):
        sims = svc.caption_query_similarity([cap], f"a {c} {s}")[0]
        other = svc.caption_query_similarity(
            [cap], f"a {'red' if c != 'red' else 'blue'} "
                   f"{'circle' if s != 'circle' else 'square'}")[0]
        sims_ok += int(sims > other)
    return {"seed": seed, "caption_exact_match": exact,
            "examples": caps[:4],
            "rerank_pairs_correct": sims_ok / len(pairs),
            "final_train_loss": loss, "train_steps": steps}


# ---------------------------------------------------------------------------
# background independence (``eval.py:1372-1500``)
# ---------------------------------------------------------------------------

BACKGROUNDS = ["dark", "bright", "checker", "gradient", "noise"]


def _background(kind: str, rng, size: int = 128) -> np.ndarray:
    import cv2

    if kind == "dark":
        return np.full((size, size, 3), int(rng.integers(20, 50)), np.uint8)
    if kind == "bright":
        return np.full((size, size, 3), int(rng.integers(180, 230)),
                       np.uint8)
    if kind == "checker":
        tile = int(rng.integers(8, 17))
        yy, xx = np.mgrid[0:size, 0:size]
        lo, hi = int(rng.integers(30, 80)), int(rng.integers(150, 220))
        img = np.where(((yy // tile + xx // tile) % 2)[..., None],
                       hi, lo).astype(np.uint8)
        return np.repeat(img, 3, axis=-1).reshape(size, size, 3)
    if kind == "gradient":
        row = np.linspace(30, 220, size).astype(np.uint8)
        return np.stack([np.tile(row, (size, 1))] * 3, -1)
    noise = rng.integers(0, 255, (size, size, 3)).astype(np.uint8)
    return cv2.GaussianBlur(noise, (7, 7), 0)


def _render(shape: str, color, kind: str, rng, size: int = 128):
    """An object on a background → (frame, bbox padded by 6 px)."""
    import cv2

    frame = _background(kind, rng, size).copy()
    rad = int(rng.integers(18, 28))
    cx = int(rng.integers(rad + 4, size - rad - 4))
    cy = int(rng.integers(rad + 4, size - rad - 4))
    c = tuple(int(v) for v in color)
    if shape == "square":
        cv2.rectangle(frame, (cx - rad, cy - rad), (cx + rad, cy + rad), c,
                      -1)
    elif shape == "circle":
        cv2.circle(frame, (cx, cy), rad, c, -1)
    elif shape == "triangle":
        pts = np.array([[cx, cy - rad], [cx - rad, cy + rad],
                        [cx + rad, cy + rad]])
        cv2.fillPoly(frame, [pts], c)
    else:  # stripe: a wide flat bar
        cv2.rectangle(frame, (cx - rad, cy - rad // 3),
                      (cx + rad, cy + rad // 3), c, -1)
    pad = 6
    bbox = [cx - rad - pad, cy - rad - pad, cx + rad + pad, cy + rad + pad]
    return frame, [float(np.clip(v, 0, size)) for v in bbox]


def eval_background(seed: int = 0, steps: int = 400, n_trials: int = 96,
                    device=None, trained=None) -> dict:
    """``eval.py:1372``: cross-background object matching through
    ``BackgroundIndependentService``. The 16 objects on one of five
    backgrounds are the references; each trial draws an object on
    another background family, at a new place and size, and must match
    its own reference among the 16 by ``feature_similarity``. A raw-crop
    CLIP baseline (no segmentation) beside it. ``trained``:
    ``_train_tiny_clip``'s result, else trained here."""
    from .services.background_independent import \
        BackgroundIndependentService

    rng = np.random.default_rng(seed)
    engine, pairs, loss = trained or _train_tiny_clip(seed, steps, device)
    svc = BackgroundIndependentService(engine)

    refs, ref_raw, ref_bg = [], [], []
    for si, (shape, cname) in enumerate(pairs):
        kind = BACKGROUNDS[si % len(BACKGROUNDS)]
        frame, bbox = _render(shape, COLORS[cname], kind, rng)
        feat = svc.extract_features(frame, bbox)
        if feat is None:
            raise RuntimeError(f"segmentation failed for ref {shape}")
        refs.append(feat)
        x0, y0, x1, y1 = (int(v) for v in bbox)
        ref_raw.append(engine.embed_images([frame[y0:y1, x0:x1]])[0])
        ref_bg.append(kind)

    hits = raw_hits = seg_fail = 0
    for t in range(n_trials):
        oi = t % len(pairs)
        shape, cname = pairs[oi]
        kind = BACKGROUNDS[(BACKGROUNDS.index(ref_bg[oi])
                            + 1 + int(rng.integers(0, 4)))
                           % len(BACKGROUNDS)]
        frame, bbox = _render(shape, COLORS[cname], kind, rng)
        feat = svc.extract_features(frame, bbox)
        if feat is None:
            seg_fail += 1
            continue
        sims = [svc.feature_similarity(feat, r) for r in refs]
        hits += int(np.argmax(sims) == oi)
        x0, y0, x1, y1 = (int(v) for v in bbox)
        raw = engine.embed_images([frame[y0:y1, x0:x1]])[0]
        raw_hits += int(np.argmax([raw @ rr for rr in ref_raw]) == oi)

    done = n_trials - seg_fail
    return {"success_rate": hits / max(done, 1),
            "raw_crop_clip_baseline": raw_hits / max(n_trials, 1),
            "trials": n_trials, "segmentation_failures": seg_fail,
            "n_objects": len(pairs),
            "backgrounds": list(BACKGROUNDS),
            "reference_target": 0.85,
            "clip_final_loss": loss}


# ---------------------------------------------------------------------------
# temporal grounding (``eval.py:135-265``)
# ---------------------------------------------------------------------------

# the synthetic grounding task (``eval.py:160-178``): B samples of N
# frames of D-dim features; a segment of 4-11 frames carries the text
GROUNDING_B, GROUNDING_N, GROUNDING_D = 16, 64, 32


def grounding_batch(rng: np.random.Generator, b: int = GROUNDING_B,
                    n: int = GROUNDING_N, d: int = GROUNDING_D):
    """One batch of the synthetic task (the JAX package's numpy draws at
    the default sizes) → ((frames, text, sal_labels, off_labels, valid),
    [(start, end)])."""
    text = rng.normal(size=(b, d)).astype(np.float32)
    frames = rng.normal(size=(b, n, d)).astype(np.float32) * 0.1
    sal = np.zeros((b, n), np.float32)
    off = np.zeros((b, n, 2), np.float32)
    segs = []
    for i in range(b):
        s = int(rng.integers(4, n - 16))
        e = s + int(rng.integers(4, 12))
        frames[i, s:e] += text[i] * 0.6
        sal[i, s:e] = 1.0
        for t in range(s, e):
            off[i, t] = [t - s, e - t]
        segs.append((s, e))
    return (frames, text, sal, off, np.ones((b, n), bool)), segs


class _StubEngine:
    """Plays phase 1's engine for ``Phase3Temporal``: the task lives in
    embedding space, so the text embedding is set per sample."""

    def __init__(self, device: torch.device) -> None:
        self.cfg = types.SimpleNamespace(projection_dim=GROUNDING_D)
        self.device = device
        self.text: Optional[np.ndarray] = None

    def embed_texts(self, query):
        return self.text[None]


class _StubPhase1:
    def __init__(self, engine: _StubEngine) -> None:
        self.engine = engine
        self.emb: Optional[np.ndarray] = None
        self.ts: Optional[List[float]] = None

    def frame_embeddings(self, path, video_id=None):
        return self.emb, self.ts


class _StubPhase2:
    def __init__(self, engine: _StubEngine) -> None:
        self.phase1 = _StubPhase1(engine)


def _tiou(gs: float, ge: float, ps: float, pe: float) -> float:
    inter = max(0.0, min(ge, pe) - max(gs, ps))
    union = max(ge, pe) - min(gs, ps)
    return inter / union if union > 0 else 0.0


def eval_grounding(seed: int = 0, steps: int = 500, n_seeds: int = 3,
                   device=None) -> dict:
    """``eval.py``'s ``eval_grounding`` (``:135-265``) in the port: per
    seed, ``steps`` steps of the tiny head under a warmup → cosine
    ``adamw`` (peak 3e-3, warmup 50), then the held-out batch through
    ``Phase3Temporal.ground_query`` (1 s a frame, top 1) → mean tIoU
    (with its spread over seeds), tIoU@0.5 and @0.7, the last loss."""
    from .models.univtg import tiny_grounding_config
    from .parallel.optim import warmup_cosine_decay_schedule
    from .parallel.train import (create_grounding_train_state,
                                 make_grounding_train_step)
    from .pipelines.phase3 import Phase3Temporal

    dev = resolve_device(device)
    n = GROUNDING_N
    per_seed, final_loss = [], None
    for s_i in range(n_seeds):
        cfg = tiny_grounding_config(input_dim=GROUNDING_D)
        model, state = create_grounding_train_state(
            cfg, learning_rate=warmup_cosine_decay_schedule(
                0.0, 3e-3, warmup_steps=50, decay_steps=max(steps, 51)),
            device=dev)
        step = make_grounding_train_step(model)
        rng = np.random.default_rng(seed + s_i)
        metrics = None
        for _ in range(steps):
            args, _ = grounding_batch(rng)
            state, metrics = step(state, *(torch.from_numpy(a).to(dev)
                                           for a in args))
        final_loss = float(metrics["loss"]) if metrics else None

        engine = _StubEngine(dev)
        p3 = Phase3Temporal(_StubPhase2(engine), cfg=cfg,
                            state_dict=state.module.state_dict())
        (frames, text, *_), segs = grounding_batch(
            np.random.default_rng(seed + s_i + 777))
        ious = []
        for b, (gs, ge) in enumerate(segs):
            p3.phase2.phase1.emb = frames[b]
            p3.phase2.phase1.ts = [float(t) for t in range(n)]
            engine.text = text[b]
            top = p3.ground_query("synthetic://grounding", "query", top_k=1,
                                  video_id=f"g{s_i}_{b}")
            ious.append(_tiou(gs, ge, top[0]["start_time"],
                              top[0]["end_time"]) if top else 0.0)
        per_seed.append({
            "mean_temporal_iou": float(np.mean(ious)),
            "tiou_at_0.5": float(np.mean([i >= 0.5 for i in ious])),
            "tiou_at_0.7": float(np.mean([i >= 0.7 for i in ious])),
        })

    agg: dict = {}
    _spread_into(agg, "mean_temporal_iou",
                 [p["mean_temporal_iou"] for p in per_seed])
    return {**agg,
            "tiou_at_0.5": float(np.mean([p["tiou_at_0.5"]
                                          for p in per_seed])),
            "tiou_at_0.7": float(np.mean([p["tiou_at_0.7"]
                                          for p in per_seed])),
            "per_seed": per_seed,
            "n_seeds": n_seeds,
            "eval_path": "pipelines.phase3.Phase3Temporal.ground_query",
            "final_loss": final_loss,
            "train_steps": steps}


def device_meta(dev: torch.device) -> dict:
    """The device the numbers came from: on a card its name and, from
    ``nvidia-smi``, its power limit."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    meta = {"device": torch.cuda.get_device_name(dev)}
    try:
        meta["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        meta["nvidia_smi"] = "not available"
    return meta


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        description="Accuracy evaluation of the PyTorch port.",
        epilog=f"Modes of the JAX package's eval.py not offered yet: "
               f"{', '.join(LATER_MODES)} (ROADMAP.md item 8b).")
    parser.add_argument("--mode", choices=MODES, default="grounding")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="also write the results, with the seed, date "
                             "and device, to this JSON file")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    run = {"image": eval_image_retrieval, "grounding": eval_grounding,
           "text": eval_text_trained, "library": eval_library,
           "caption": eval_caption, "background": eval_background}
    out = {SECTIONS[args.mode]: run[args.mode](args.seed, device=dev)}
    if args.out:
        out["meta"] = {"seed": args.seed, "mode": args.mode,
                       "date": datetime.datetime.now(datetime.timezone.utc)
                       .isoformat(timespec="seconds"),
                       **device_meta(dev)}
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
