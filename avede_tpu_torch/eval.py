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
  baseline);
- ``detection`` — a tiny YOLO and two seeds of a tiny OWL-ViT trained on
  synthetic shapes (``parallel/train_det.py``, ``train_owl.py``): frame
  P/R of ``YoloService``, open-vocabulary P/R of ``UniversalDetector``'s
  ``owlvit`` and ``hybrid`` modes, video P/R through
  ``SmallObjectService``;
- ``detection4k`` — tiny YOLOs trained on 256 px tiles, then 3840 × 2160
  frames tiled through ``SmallObjectService.detect_in_frame`` (mAP@0.5);
- ``person`` — the re-id encoder, a face-region YOLO, a face embedder and
  a person YOLO trained on synthetic people, then ``PersonSearchService``
  over a crowd video with learned fusion weights and four ablations.

    python -m avede_tpu_torch.eval --mode {image,grounding,text,detection,
        detection4k,person,caption,library,background,all} [--seed 0]
        [--out results.json] [--device cpu]

Training runs in f32 through plain PyTorch (as the JAX package trains
through XLA); the trained weights are served in the device's compute
dtype, through the kernels on a card (the tiny towers' patch embed at
P = 8, flash attention at head dim 16 and, in the ``detection`` mode's
OWL-ViT, at head dim 24). It runs on ``cuda`` unless ``--device`` says
otherwise, and raises without a card. ``--out`` writes the results with
the device's name (and on a card its power limit) and each mode's kernel
launches under ``meta``; the JAX package's ``EVAL.json`` is never
written.
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

# every mode of the JAX package's eval.py, in the order ``all`` runs them
MODES = ("image", "grounding", "text", "detection", "detection4k", "person",
         "caption", "library", "background")
# each mode's section of the output, as the JAX package names it
SECTIONS = {"image": "image_retrieval", "grounding": "temporal_grounding",
            "text": "text_retrieval_trained",
            "detection": "detection_trained",
            "detection4k": "detection_4k_tiled",
            "person": "person_reid_trained",
            "caption": "caption_trained",
            "library": "library_search_trained",
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

def tiny_clip_engine(device, state_dict: Optional[Dict] = None,
                     dtype: Optional[str] = None):
    """A ``ClipEngine`` on the tiny CLIP (32 px, patch 8, width 64) in
    ``dtype`` (by default the device's compute dtype): ``state_dict``'s
    weights, else random from seed 0."""
    from .models.clip import tiny_test_config
    from .parallel.embed import ClipEngine
    from .utils.platform import compute_dtype

    dev = resolve_device(device)
    cfg = dataclasses.replace(tiny_test_config(),
                              dtype=dtype or compute_dtype(dev))
    return ClipEngine(cfg=cfg, state_dict=state_dict, device=dev, seed=0)


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
# detection (``eval.py:606-1035``): tiny YOLO and tiny OWL-ViT trained on
# synthetic shapes, scored through the serving paths
# ---------------------------------------------------------------------------

# the detector trainers' batch (``eval.py:612-721``)
DET_BATCH = 16


def _train_tiny_yolo(steps: int, seed: int, scene_fn, num_classes: int = 4,
                     img_size: int = 64, device=None):
    """``eval.py:612``: a YOLOv8n (``img_size`` px, ``num_classes``)
    from ``seed`` trained in f32 on a fresh batch of ``scene_fn(rng)``
    scenes a step with clip 5.0 + Adam under a cosine decay from 3e-3 to
    1.5e-4 → (config, trained state dict, last loss)."""
    from .models.yolo import YoloConfig
    from .parallel.optim import cosine_decay_schedule
    from .parallel.train_det import (create_yolo_train_state,
                                     make_yolo_train_step)

    dev = resolve_device(device)
    cfg = YoloConfig(num_classes=num_classes, scale="n", img_size=img_size)
    model, state = create_yolo_train_state(
        cfg, cosine_decay_schedule(3e-3, steps, alpha=0.05), seed=seed,
        device=dev)
    step = make_yolo_train_step(model)
    rng = np.random.default_rng(seed)
    metrics = None
    for _ in range(steps):
        data = [scene_fn(rng) for _ in range(DET_BATCH)]
        state, metrics = step(state, *(
            torch.from_numpy(np.stack([d[i] for d in data])).to(dev)
            for i in range(4)))
    loss = float(metrics["loss"]) if metrics else None
    return cfg, {k: v.detach() for k, v in model.state_dict().items()}, loss


def _iou_xyxy(a, g) -> float:
    ix0, iy0 = max(a[0], g[0]), max(a[1], g[1])
    ix1, iy1 = min(a[2], g[2]), min(a[3], g[3])
    inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (g[2] - g[0]) * (g[3] - g[1]) - inter)
    return inter / union if union > 0 else 0.0


def _match_detections(dets, gtb, gtl, iou_thr: float = 0.5):
    """Greedy match → (tp, fp, fn), classes agreeing where a detection
    has a ``class_id``."""
    matched = set()
    tp = fp = 0
    for d in dets:
        best_iou, best_j = 0.0, -1
        for j, g in enumerate(gtb):
            iou = _iou_xyxy(d["bbox"], g)
            if iou > best_iou:
                best_iou, best_j = iou, j
        cid = d.get("class_id")
        cls_ok = cid is None or (best_j >= 0 and cid == gtl[best_j])
        if best_iou >= iou_thr and best_j not in matched and cls_ok:
            tp += 1
            matched.add(best_j)
        else:
            fp += 1
    return tp, fp, len(gtb) - len(matched)


# the ``detection`` mode's OWL-ViT (``eval.py:695-698``): 64 px in 8 px
# patches, 4 vision layers of 4 heads of 24 (flash at L = 65, hd = 24 on
# a card), a 2-layer text tower over 8 tokens of a 256-id vocabulary
DETECTION_OWL = dict(image_size=64, patch_size=8, vision_dim=96,
                     vision_depth=4, vision_heads=4, text_dim=64,
                     text_depth=2, text_heads=4, vocab_size=256,
                     max_text_len=8, projection_dim=64)


def _train_tiny_owl(steps: int, seed: int, scene_fn, device=None):
    """``eval.py:675``: the ``detection`` mode's OWL-ViT from ``seed``
    trained in f32 with plain attention on ``scene_fn(rng)``'s shapes
    with names (the query ids are the class names' tokens, so serving
    routes them through the text tower), clip 5.0 + Adam under warmup →
    cosine (peak 2e-3, warmup 100) → (config, trained state dict, last
    loss)."""
    from .models.owlvit import OwlViTConfig
    from .models.tokenizer import Tokenizer
    from .parallel.optim import warmup_cosine_decay_schedule
    from .parallel.train_owl import (create_owl_train_state,
                                     make_owl_train_step)
    from .utils.synthetic import SHAPE_CLASSES

    dev = resolve_device(device)
    cfg = OwlViTConfig(**DETECTION_OWL)
    tok = Tokenizer(vocab_size=cfg.vocab_size, context_len=cfg.max_text_len)
    model, state = create_owl_train_state(
        cfg, learning_rate=warmup_cosine_decay_schedule(
            0.0, 2e-3, warmup_steps=100, decay_steps=max(steps, 101)),
        seed=seed, device=dev)
    step = make_owl_train_step(model, tok(SHAPE_CLASSES))
    rng = np.random.default_rng(seed)
    metrics = None
    for _ in range(steps):
        data = [scene_fn(rng) for _ in range(DET_BATCH)]
        h, w = data[0][0].shape[:2]
        boxes = np.stack([d[1] for d in data]) \
            / np.asarray([w, h, w, h], np.float32)
        state, metrics = step(state, *(torch.from_numpy(a).to(dev) for a in (
            np.stack([d[0] for d in data]), boxes,
            np.stack([d[2] for d in data]), np.stack([d[3] for d in data]))))
    loss = float(metrics["loss"]) if metrics else None
    return cfg, {k: v.detach() for k, v in model.state_dict().items()}, loss


def _shape_scene128(rng):
    """The ``detection`` mode's scene: 128 px, up to 5 non-overlapping
    shapes of radius 10-22."""
    from .utils.synthetic import draw_shape_scene

    return draw_shape_scene(rng, hw=(128, 128), max_boxes=5, min_r=10,
                            max_r=22, non_overlapping=True)


def _yolo_scene64(rng):
    """A 128 px scene downscaled 2× (cv2 ``INTER_AREA``): what
    ``YoloService``'s resize shows the 64 px YOLO at serving."""
    import cv2

    img, gb, gl, gm = _shape_scene128(rng)
    return (cv2.resize(img, (64, 64), interpolation=cv2.INTER_AREA),
            gb / 2.0, gl, gm)


def _with_query_ids(dets) -> List[Dict]:
    """Detections labelled by query name → ``_match_detections``'s
    ``class_id`` (-1 for a name that is not a shape class)."""
    from .utils.synthetic import SHAPE_CLASSES

    return [{"bbox": d["bbox"],
             "class_id": SHAPE_CLASSES.index(d["query"])
             if d.get("query") in SHAPE_CLASSES else -1} for d in dets]


def eval_detection(seed: int = 0, steps: int = 700, owl_steps: int = 2000,
                   device=None) -> dict:
    """``eval.py:724``: a tiny YOLO (``steps``) and, for seeds ``seed``
    and ``seed + 1``, the tiny OWL-ViT (``owl_steps``) trained on 128 px
    scenes of up to 5 non-overlapping shapes; frame-level P/R of
    ``YoloService.detect`` (conf 0.4) on 32 held-out scenes; open-vocab
    P/R of ``UniversalDetector``'s ``owlvit`` and ``hybrid`` modes at the
    confidence chosen by F1 on a validation split (12 scenes a
    threshold), reported on a test split (24 scenes), as the across-seed
    mean with min and std; video-level P/R through
    ``SmallObjectService`` (``yolo_enhanced``, tile = frame) on a
    24-frame ``mp4v`` video. The trained weights are served in the
    device's compute dtype (on a card: the tiny CLIP's kernels and flash
    at L = 65, hd = 24 in each OWL-ViT layer)."""
    from .services.detector import YoloService
    from .services.small_object import SmallObjectService
    from .services.universal_detector import UniversalDetector
    from .utils.platform import with_compute_dtype
    from .utils.synthetic import SHAPE_CLASSES

    dev = resolve_device(device)
    cfg, yolo_sd, final_loss = _train_tiny_yolo(
        steps, seed, scene_fn=_yolo_scene64, device=dev)
    svc = YoloService(cfg=with_compute_dtype(cfg, dev), state_dict=yolo_sd,
                      class_names=SHAPE_CLASSES, device=dev)

    # frame-level precision / recall on held-out 128 px scenes
    rng = np.random.default_rng(seed + 99)
    tp = fp = fn = 0
    for _ in range(32):
        img, gb, gl, gm = _shape_scene128(rng)
        dets = svc.detect(img[None], conf_threshold=0.4)[0]
        a, b, c = _match_detections(dets, gb[gm], gl[gm])
        tp, fp, fn = tp + a, fp + b, fn + c
    frame_p = tp / max(tp + fp, 1)
    frame_r = tp / max(tp + fn, 1)

    # open vocabulary: each seed's trained OWL-ViT through the detector
    engine = tiny_clip_engine(dev)
    owl_runs, owl_loss, ud = [], None, None
    for s in (seed, seed + 1):
        ocfg, owl_sd, loss_s = _train_tiny_owl(owl_steps, s,
                                               scene_fn=_shape_scene128,
                                               device=dev)
        ud_s = UniversalDetector(engine,
                                 owlvit_cfg=with_compute_dtype(ocfg, dev),
                                 owlvit_state_dict=owl_sd, yolo=svc)
        if ud is None:          # the video path below uses the first run
            ud, owl_loss = ud_s, loss_s

        def mode_pr_at(mode: str, conf: float, rng_m, n: int):
            tp = fp = fn = 0
            for _ in range(n):
                img, gb, gl, gm = _shape_scene128(rng_m)
                dets = ud_s.detect_unlimited_objects(
                    img[None], SHAPE_CLASSES, detection_mode=mode,
                    conf_threshold=conf, adaptive=False)[0]
                a, b, c = _match_detections(_with_query_ids(dets), gb[gm],
                                            gl[gm])
                tp, fp, fn = tp + a, fp + b, fn + c
            return tp / max(tp + fp, 1), tp / max(tp + fn, 1)

        run = {"seed": s, "final_loss": loss_s}
        for mode in ("owlvit", "hybrid"):
            # the operating threshold is chosen on a validation split
            # (F1) and reported on a held-out test split
            best_conf, best_f1 = 0.5, -1.0
            for conf in (0.35, 0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75,
                         0.8):
                p, r = mode_pr_at(mode, conf,
                                  np.random.default_rng(s + 501), 12)
                f1 = 2 * p * r / max(p + r, 1e-9)
                if f1 > best_f1:
                    best_conf, best_f1 = conf, f1
            p, r = mode_pr_at(mode, best_conf, np.random.default_rng(s + 7),
                              24)
            run[f"{mode}_precision"] = p
            run[f"{mode}_recall"] = r
            run[f"{mode}_conf"] = best_conf
        owl_runs.append(run)

    mode_pr = {"owl_per_seed": owl_runs, "owl_n_seeds": len(owl_runs)}
    for mode in ("owlvit", "hybrid"):
        for metric in ("precision", "recall"):
            _spread_into(mode_pr, f"{mode}_{metric}",
                         [r[f"{mode}_{metric}"] for r in owl_runs])
        mode_pr[f"{mode}_conf"] = [r[f"{mode}_conf"] for r in owl_runs]

    # video level through the small-object service; tile = frame (64 px
    # tiles would cut 44 px objects; tiling is the 4K mode's)
    so = SmallObjectService(engine, detector=ud, tile=128, overlap=0)
    gt_frames, frames = [], []
    for _ in range(24):
        img, gb, gl, gm = _shape_scene128(rng)
        gt_frames.append((gb[gm], gl[gm]))
        frames.append(img)
    with tempfile.TemporaryDirectory(prefix="avede_det_") as tmp:
        video = os.path.join(tmp, "shapes.mp4")
        _write_video(video, frames, 4.0, (128, 128))
        out = so.detect_in_video(
            video, SHAPE_CLASSES, min_object_size=10, max_object_size=64,
            confidence_threshold=0.4, top_k=120, sample_rate=1,
            enable_background_independence=False,
            detection_mode="yolo_enhanced")
    vid_tp = vid_fp = 0
    matched_gt = set()   # (frame, gt index) pairs found
    total_gt = sum(len(gl) for _, gl in gt_frames)
    for d in out["results"]:
        gb, gl = gt_frames[d["frame_index"]]
        labelled = _with_query_ids([d])
        a, b, _ = _match_detections(labelled, gb, gl)
        if a:
            # recall bookkeeping: the first unmatched gt row it hits
            for j in range(len(gl)):
                if (d["frame_index"], j) not in matched_gt \
                        and _iou_xyxy(d["bbox"], gb[j]) >= 0.5 \
                        and labelled[0]["class_id"] == gl[j]:
                    matched_gt.add((d["frame_index"], j))
                    break
        vid_tp += a
        vid_fp += b
    return {"frame_precision": frame_p, "frame_recall": frame_r,
            **mode_pr,
            "video_path_hits": vid_tp, "video_path_false": vid_fp,
            "video_path_precision": vid_tp / max(vid_tp + vid_fp, 1),
            "video_path_recall": len(matched_gt) / max(total_gt, 1),
            "scene": "128px, ≤5 non-overlapping objects",
            "train_steps": steps, "owl_train_steps": owl_steps,
            "final_train_loss": final_loss,
            "owl_final_loss": owl_loss}


def _average_precision(all_dets, all_gts, iou_thr: float = 0.5) -> float:
    """COCO-style mAP@iou (``eval.py:898``): per class, 101-point
    interpolated precision over score-ranked detections, averaged over
    the classes in the ground truth. all_dets: per image
    ``[{bbox, confidence, class_id}]``; all_gts: per image (boxes
    ``[M, 4]``, labels ``[M]``)."""
    classes = sorted({int(c) for _, gl in all_gts for c in gl})
    aps = []
    for c in classes:
        recs = []
        npos = 0
        for i, (dets, (gb, gl)) in enumerate(zip(all_dets, all_gts)):
            npos += int((np.asarray(gl) == c).sum())
            recs.extend((d["confidence"], i, d["bbox"]) for d in dets
                        if d.get("class_id") == c)
        if npos == 0:
            continue
        recs.sort(key=lambda r: -r[0])
        matched = set()
        tp = np.zeros(len(recs))
        for k, (_, i, bbox) in enumerate(recs):
            gb, gl = all_gts[i]
            best_iou, best_j = 0.0, -1
            for j in range(len(gl)):
                if int(gl[j]) != c:
                    continue
                iou = _iou_xyxy(bbox, gb[j])
                if iou > best_iou:
                    best_iou, best_j = iou, j
            if best_iou >= iou_thr and (i, best_j) not in matched:
                tp[k] = 1
                matched.add((i, best_j))
        ctp = np.cumsum(tp)
        rec = ctp / npos
        prec = ctp / np.arange(1, len(recs) + 1)
        ap = 0.0
        for t in np.linspace(0, 1, 101):
            mask = rec >= t
            ap += (prec[mask].max() if mask.any() else 0.0) / 101
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


# the tiled 4K geometry (``eval.py:944-949``): 256 px tiles overlapping
# by 64, 220 a 3840 × 2160 frame
TILE4K, OVERLAP4K = 256, 64


def eval_detection_4k(seed: int = 0, steps: int = 1000, n_frames: int = 16,
                      n_seeds: int = 2, device=None) -> dict:
    """``eval.py:952``: per seed a tiny YOLO trained on 256 px tiles (up
    to 3 shapes of radius 12-48, downscaled to 64 px), then ``n_frames``
    3840 × 2160 frames of up to 24 shapes through
    ``SmallObjectService.detect_in_frame`` (``yolo_enhanced``, the tiles
    above, conf 0.35, adaptive thresholds on) → COCO mAP@0.5, the
    across-seed mean with min and std."""
    import cv2

    from .models.owlvit import tiny_owlvit_config
    from .ops.tiling import tile_grid
    from .services.detector import YoloService
    from .services.small_object import SmallObjectService
    from .services.universal_detector import UniversalDetector
    from .utils.platform import with_compute_dtype
    from .utils.synthetic import SHAPE_CLASSES, draw_shape_scene

    dev = resolve_device(device)

    def tile_scene(r):
        # train on tiles downscaled to YOLO's 64 px: the geometry each
        # serving tile goes through
        img, gb, gl, gm = draw_shape_scene(
            r, hw=(TILE4K, TILE4K), max_boxes=3, min_r=12, max_r=48,
            non_overlapping=True)
        img64 = cv2.resize(img, (64, 64), interpolation=cv2.INTER_AREA)
        return img64, gb / 4.0, gl, gm

    per_seed = []
    for s_i in range(n_seeds):
        cfg, yolo_sd, final_loss = _train_tiny_yolo(
            steps, seed + s_i, scene_fn=tile_scene, device=dev)
        svc = YoloService(cfg=with_compute_dtype(cfg, dev),
                          state_dict=yolo_sd, class_names=SHAPE_CLASSES,
                          device=dev)
        engine = tiny_clip_engine(dev)
        # the tiny OWL-ViT: yolo_enhanced never runs it
        ud = UniversalDetector(engine, yolo=svc, owlvit_cfg=with_compute_dtype(
            tiny_owlvit_config(), dev))
        so = SmallObjectService(engine, detector=ud, tile=TILE4K,
                                overlap=OVERLAP4K)
        rng = np.random.default_rng(seed + s_i + 41)
        all_dets, all_gts = [], []
        for _ in range(n_frames):
            frame, gb, gl, gm = draw_shape_scene(
                rng, hw=(2160, 3840), max_boxes=24, min_r=12, max_r=48,
                non_overlapping=True)
            dets = so.detect_in_frame(
                frame, SHAPE_CLASSES, conf_threshold=0.35, enable_rpn=False,
                enable_adaptive_thresholds=True,
                detection_mode="yolo_enhanced")
            all_dets.append([dict(c, confidence=d["confidence"])
                             for d, c in zip(dets, _with_query_ids(dets))])
            all_gts.append((gb[gm], gl[gm]))
        per_seed.append({
            "map50": _average_precision(all_dets, all_gts, iou_thr=0.5),
            "objects_total": sum(len(gl) for _, gl in all_gts),
            "detections_total": sum(len(d) for d in all_dets),
            "final_train_loss": final_loss})

    ret: dict = {}
    _spread_into(ret, "map50", [p["map50"] for p in per_seed])
    return {**ret,
            "per_seed": per_seed, "n_seeds": n_seeds,
            "frames_per_seed": n_frames, "resolution": "3840x2160",
            "tiles_per_frame": len(tile_grid(2160, 3840, TILE4K, OVERLAP4K)),
            "tile_size": TILE4K, "tile_overlap": OVERLAP4K,
            "geometry_shared_with_bench": True,
            "objects_total": sum(p["objects_total"] for p in per_seed),
            "object_size_px": "24-96",
            "train_steps": steps}


# ---------------------------------------------------------------------------
# person re-identification (``eval.py:1042-1367``)
# ---------------------------------------------------------------------------

def _train_appearance(cfg, seed: int, steps: int, batch_fn, device):
    """``eval.py:1065-1086`` and ``:1133-1148``: an appearance encoder
    from ``seed`` trained contrastively (adamw 1e-3, clip 1.0) for
    ``steps`` steps on ``batch_fn(easy)``'s two views (the first eighth
    of the steps easy: no codec round trip, no box jitter) → (trained
    state dict, last loss)."""
    from .parallel.train_reid import (create_reid_train_state,
                                      make_reid_train_step)

    model, state = create_reid_train_state(cfg, learning_rate=1e-3,
                                           seed=seed, device=device)
    step = make_reid_train_step(model)
    metrics = None
    for i in range(steps):
        a, b = batch_fn(i < steps // 8)
        state, metrics = step(state, torch.from_numpy(a).to(device),
                              torch.from_numpy(b).to(device))
    loss = float(metrics["loss"]) if metrics else None
    return {k: v.detach() for k, v in model.state_dict().items()}, loss


def _margin(embs) -> Tuple[float, float]:
    """Per identity a block of unit embeddings → (mean cosine within an
    identity, mean cosine across identities)."""
    same, other = [], []
    for i, e in enumerate(embs):
        s = e @ e.T
        same.extend(s[np.triu_indices(len(e), 1)])
        for j in range(i + 1, len(embs)):
            other.extend((e @ embs[j].T).reshape(-1))
    return float(np.mean(same)), float(np.mean(other))


def eval_person(seed: int = 0, reid_steps: int = 800, det_steps: int = 700,
                device=None,
                serve: Optional[Sequence[Tuple[str, str]]] = None) -> dict:
    """``eval.py:1042``: four trainers, then the real person search.
    (1) the re-id encoder on head crops of 48 synthetic identities
    (``reid_steps``), its identity margin on 8 held-out identities;
    (1b) a 1-class face-region YOLO on person crops (400 steps; mean IoU
    of its top box on 32 held-out crops) and the face embedder on face
    crops (600 steps; face margin); (2) a 1-class 128 px person YOLO on
    crowd scenes of 1-4 people (``det_steps``); (3) ``PersonSearchService``
    over a 48-frame crowd video (the target in alternate 6-frame blocks
    among 3 distractors): fusion weights fitted on a validation video,
    then the learned fusion and four ablations → rank metrics at k = the
    target's frame count.

    The models train on ``device``. ``serve`` lists the (device, dtype)
    pairs that serve them, each on the same drawn data (the YOLOs and
    the CLIP in that dtype, the encoders in their configs' f32); by
    default ``device`` alone, in its compute dtype. The metrics are the
    first pair's; with more than one, ``served_on`` holds each pair's,
    so that weights trained on one device are scored on another. Each
    serving pass first seeds cv2's process-wide RNG with ``seed``: the
    body cue's GrabCut draws from it, so without the seed a pass's
    metrics hang on every GrabCut run before it in the process (JAX's
    eval leaves it unseeded)."""
    from .models.appearance import AppearanceConfig, tiny_appearance_config
    from .utils.platform import compute_dtype
    from .utils.synthetic import (crop_bbox, draw_people, draw_person,
                                  face_batch, face_detector_scene,
                                  head_crop, identity_batch, make_identity,
                                  with_outfit)

    dev = resolve_device(device)
    targets = ([(resolve_device(d), t) for d, t in serve] if serve
               else [(dev, compute_dtype(dev))])
    rng = np.random.default_rng(seed)

    # 1) the identity encoder, contrastive on 48 synthetic identities
    acfg = tiny_appearance_config()
    identities = [make_identity(rng) for _ in range(48)]
    reid_sd, reid_loss = _train_appearance(
        acfg, seed, reid_steps, lambda easy: identity_batch(
            identities, rng, crop_size=acfg.input_size,
            codec_aug=not easy, box_jitter=0.0 if easy else 0.08), dev)

    # held-out identities, 4 head crops each (the identity margin)
    held = [make_identity(rng) for _ in range(8)]
    head_crops = [[head_crop(*draw_person(ident, rng)) for _ in range(4)]
                  for ident in held]

    # 1b) the face path: a face-region detector on person crops and a
    # face embedding on face crops
    face_det_steps = 400
    fd_cfg, fd_sd, fd_loss = _train_tiny_yolo(
        face_det_steps, seed + 11, scene_fn=face_detector_scene,
        num_classes=1, img_size=64, device=dev)
    fd_rng = np.random.default_rng(seed + 12)
    fd_scenes = [face_detector_scene(fd_rng) for _ in range(32)]

    face_embed_steps = 600
    fcfg = AppearanceConfig(input_size=32, widths=(16, 32, 32, 64),
                            embed_dim=64)
    face_sd, face_loss = _train_appearance(
        fcfg, seed + 13, face_embed_steps, lambda easy: face_batch(
            identities, rng, crop_size=fcfg.input_size, codec_aug=not easy,
            box_jitter=0.0 if easy else 0.10), dev)
    face_crops = []
    for ident in held:
        crops = []
        for _ in range(4):
            parts: Dict = {}
            frame, _ = draw_person(ident, rng, parts=parts)
            crops.append(crop_bbox(frame, parts["face"]))
        face_crops.append(crops)

    # 2) a 1-class person detector on crowd scenes, at its native 128 px
    def person_scene(r):
        n = int(r.integers(1, 5))
        idents = [make_identity(r) for _ in range(n)]
        frame, bbs = draw_people(idents, r, frame_hw=(128, 128))
        boxes = np.zeros((4, 4), np.float32)
        mask = np.zeros((4,), bool)
        for i, bb in enumerate(bbs):
            boxes[i] = np.asarray(bb)
            mask[i] = True
        return frame, boxes, np.zeros((4,), np.int32), mask

    ycfg, ysd, det_loss = _train_tiny_yolo(
        det_steps, seed, scene_fn=person_scene, num_classes=1, img_size=128,
        device=dev)

    # 3) the crowd videos of the person search; each person keeps an
    # outfit within a video
    target = with_outfit(held[0], rng)
    distractors = [with_outfit(d, rng) for d in held[1:8]]

    def build_crowd_video(tmp, tgt, pool_ids, tag):
        """8 blocks × 6 frames, the target in the even blocks among 3
        distractors → (path, the target's frames, its box a frame, a
        reference person crop)."""
        frames, gt_frames, gt_boxes = [], [], {}
        for block in range(8):
            with_target = block % 2 == 0
            pool = [d for j, d in enumerate(pool_ids)
                    if j % 4 != block % 4]
            for _ in range(6):
                idents = ([tgt] if with_target else []) \
                    + pool[: 4 - int(with_target)]
                frame, bbs = draw_people(idents, rng, frame_hw=(128, 128))
                if with_target:
                    gt_frames.append(len(frames))
                    gt_boxes[len(frames)] = bbs[0]
                frames.append(frame)
        path = os.path.join(tmp, f"people_{tag}.mp4")
        _write_video(path, frames, 4.0, (128, 128))
        rf, rb = draw_person(tgt, rng, frame_hw=(128, 128), person_h=80)
        x0, y0, x1, y1 = (int(v) for v in rb)
        ref = rf[max(0, y0 - 6):y1 + 6, max(0, x0 - 6):x1 + 6]
        return path, gt_frames, gt_boxes, ref

    trained = types.SimpleNamespace(
        seed=seed, acfg=acfg, reid_sd=reid_sd, head_crops=head_crops, fd_cfg=fd_cfg,
        fd_sd=fd_sd, fd_scenes=fd_scenes, fcfg=fcfg, face_sd=face_sd,
        face_crops=face_crops, ycfg=ycfg, ysd=ysd)
    with tempfile.TemporaryDirectory(prefix="avede_person_") as tmp:
        video, gt_target, _, ref_frame = build_crowd_video(
            tmp, target, distractors, "test")
        # the validation video of the fusion weights, with fresh
        # identities
        val_ids = [with_outfit(make_identity(rng), rng) for _ in range(8)]
        val = build_crowd_video(tmp, val_ids[0], val_ids[1:], "val")
        scores = [_person_served(trained, sdev, sdtype,
                                 (video, gt_target, ref_frame), val)
                  for sdev, sdtype in targets]
    out = {**scores[0],
           "scene": "128px crowd, 4 people/frame",
           "reid_final_loss": reid_loss,
           "face_embed_final_loss": face_loss,
           "face_detector_final_loss": fd_loss,
           "detector_final_loss": det_loss,
           "reid_steps": reid_steps, "det_steps": det_steps,
           "face_embed_steps": face_embed_steps,
           "face_det_steps": face_det_steps}
    if len(targets) > 1:
        out["served_on"] = [{"device": str(sdev), "dtype": sdtype, **s}
                            for (sdev, sdtype), s in zip(targets, scores)]
    return out


def _person_served(trained, dev: torch.device, dtype: str, test, val
                   ) -> dict:
    """``eval_person``'s trained models served on ``dev`` (the YOLOs and
    the CLIP in ``dtype``) over its drawn data → its metrics: the
    identity and face margins, the face detector's IoU, and the crowd
    search's rank metrics on ``test`` (video, the target's frames,
    reference crop) under the fusion weights fitted on ``val`` (video,
    the target's frames, its box a frame, reference crop), with the four
    ablations."""
    import cv2

    from .models.appearance import AppearanceEmbedder
    from .services.detector import YoloService
    from .services.person_detector import (PersonDetector,
                                           PersonSearchService, _cos,
                                           fit_fusion_weights)

    t = trained
    cv2.setRNGSeed(t.seed)
    embedder = AppearanceEmbedder(t.acfg, state_dict=t.reid_sd, device=dev)
    same_mean, other_mean = _margin([embedder.embed(c)
                                     for c in t.head_crops])

    face_yolo = YoloService(cfg=dataclasses.replace(t.fd_cfg, dtype=dtype),
                            state_dict=t.fd_sd, class_names=["face"],
                            device=dev)
    fd_ious = []
    for img, gtb, _, gtm in t.fd_scenes:
        dets = face_yolo.detect(img[None], conf_threshold=0.15)[0]
        if not dets or not gtm[0]:
            fd_ious.append(0.0)
            continue
        best = max(dets, key=lambda d: d["confidence"])
        fd_ious.append(_iou_xyxy(best["bbox"], gtb[0]))

    face_embedder = AppearanceEmbedder(t.fcfg, state_dict=t.face_sd,
                                       device=dev)
    fsame, fother = _margin([face_embedder.embed(c) for c in t.face_crops])

    yolo = YoloService(cfg=dataclasses.replace(t.ycfg, dtype=dtype),
                       state_dict=t.ysd, class_names=["person"], device=dev)
    engine = tiny_clip_engine(dev, dtype=dtype)

    def run_search(video, gt_target, ref_frame, detector) -> dict:
        """One feature configuration's crowd search → rank metrics; a
        frame's score is its best match (how the product surfaces
        hits)."""
        search = PersonSearchService(engine, detector=detector)
        out = search.process_video_for_person(
            video, ref_frame, similarity_threshold=0.0, frame_skip=1,
            temporal_consistency=False)
        ms = sorted(out["matches"], key=lambda m: -m["similarity"])
        k = len(gt_target)
        topk = ms[:k]
        correct = sum(1 for m in topk if m["frame_index"] in gt_target)
        frame_best: dict = {}
        for m in out["matches"]:
            frame_best[m["frame_index"]] = max(
                frame_best.get(m["frame_index"], 0.0), m["similarity"])
        ranked = sorted(frame_best, key=lambda f: -frame_best[f])[:k]
        return {
            "precision_at_k": correct / max(len(topk), 1),
            "frame_precision_at_k": len(set(ranked) & set(gt_target))
            / max(len(ranked), 1),
            "recall_at_k": len({m["frame_index"] for m in topk}
                               & set(gt_target)) / max(k, 1),
            "recall": len({m["frame_index"] for m in ms}
                          & set(gt_target)) / max(k, 1),
            "matches_found": out["total_found"],
        }

    # the fusion weights, fitted on the validation video; labels: IoU >=
    # 0.5 with the target's box
    val_video, _, val_boxes, val_ref = val
    fixed_det = PersonDetector(
        engine, yolo=yolo, appearance=embedder, face_yolo=face_yolo,
        face_embedder=face_embedder)
    cap = cv2.VideoCapture(val_video)
    val_frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        val_frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    ref_feats = fixed_det.process_reference(val_ref)
    val_feats, val_labels = [], []
    for fi, dets in enumerate(fixed_det.detect_persons(np.stack(val_frames))):
        if not dets:
            continue
        feats = fixed_det.extract_features(
            val_frames[fi], [d["bbox"] for d in dets])
        for f in feats:
            conf = min(float(ref_feats.get("face_conf") or 0.0),
                       float(f.get("face_conf") or 0.0))
            fc = _cos(ref_feats.get("face"), f.get("face"))
            val_feats.append({
                "identity": _cos(ref_feats.get("identity"),
                                 f.get("identity")),
                # faded by the face confidence, as similarity() takes it
                "face": conf * fc if fc is not None else None,
                "body": _cos(ref_feats.get("body"), f.get("body")),
                "visual": _cos(ref_feats.get("visual"), f.get("visual"))})
            val_labels.append(
                fi in val_boxes
                and _iou_xyxy(f["bbox"], val_boxes[fi]) >= 0.5)
    learned_w = fit_fusion_weights(
        val_feats, val_labels, keys=("identity", "face", "body", "visual"))

    # the learned fusion against the fixed reference weights, each
    # identity cue alone and the untrained geometric fallback
    detectors = {
        "full": PersonDetector(
            engine, yolo=yolo, appearance=embedder, face_yolo=face_yolo,
            face_embedder=face_embedder, fusion_weights=learned_w),
        "fixed_reference_weights": fixed_det,
        "appearance_only": PersonDetector(engine, yolo=yolo,
                                          appearance=embedder),
        "face_only": PersonDetector(engine, yolo=yolo, face_yolo=face_yolo,
                                    face_embedder=face_embedder),
        "geometric_fallback": PersonDetector(engine, yolo=yolo)}
    ablations = {name: run_search(*test, det)
                 for name, det in detectors.items()}
    full = ablations["full"]
    return {"identity_same_mean_sim": same_mean,
            "identity_other_mean_sim": other_mean,
            "identity_margin": same_mean - other_mean,
            "face_margin": fsame - fother,
            "face_detector_iou": float(np.mean(fd_ious)),
            "person_precision_at_k": full["precision_at_k"],
            "person_frame_precision_at_k": full["frame_precision_at_k"],
            "person_recall_at_k": full["recall_at_k"],
            "person_recall": full["recall"],
            "ablations": ablations,
            "fusion_weights_learned": learned_w,
            "fusion_val_candidates": len(val_feats),
            "fusion_val_positives": int(sum(val_labels)),
            "matches_found": full["matches_found"]}


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


def kernel_launches() -> Dict[str, int]:
    """The launches so far of the kernels that the modes run: the bf16
    flash entry's by L, the packed patch embed's by kernel and the
    fused score + top-k entries' (all 0 on the CPU, where the wrappers
    run their plain versions)."""
    from .ops import attention, kernels

    flash = attention.flash_attention_blhd.launches_by_length
    patch = kernels.fused_patch_embed_i420.launches_by_kernel
    return {**{f"flash_attention_blhd[L={n}]": c for n, c in flash.items()},
            **{f"fused_patch_embed_i420[{k}]": c for k, c in patch.items()},
            **{fn.__name__: fn.launches for fn in (
                kernels.cosine_window_topk, kernels.cosine_topk_f32,
                kernels.cosine_topk_bf16, kernels.cosine_topk_int8)}}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(
        description="Accuracy evaluation of the PyTorch port.")
    parser.add_argument("--mode", choices=MODES + ("all",),
                        default="grounding")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None,
                        help="also write the results, with the seed, date "
                             "and device, to this JSON file")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    run = {"image": eval_image_retrieval, "grounding": eval_grounding,
           "text": eval_text_trained, "detection": eval_detection,
           "detection4k": eval_detection_4k, "person": eval_person,
           "caption": eval_caption, "library": eval_library,
           "background": eval_background}
    modes = MODES if args.mode == "all" else (args.mode,)
    out, launches = {}, {}
    for m in modes:
        before = kernel_launches()
        out[SECTIONS[m]] = run[m](args.seed, device=dev)
        launches[m] = {k: n - before.get(k, 0)
                       for k, n in kernel_launches().items()
                       if n != before.get(k, 0)}
    if args.out:
        out["meta"] = {"seed": args.seed, "mode": args.mode,
                       "date": datetime.datetime.now(datetime.timezone.utc)
                       .isoformat(timespec="seconds"),
                       **device_meta(dev), "kernel_launches": launches}
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
