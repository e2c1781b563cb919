"""Accuracy evaluation of the port (counterpart of the repository's
``eval.py``), one mode so far:

- ``grounding`` — temporal localization: train the grounding head
  (``models/univtg.py``) on synthetic (features, segment) pairs, then
  measure the temporal IoU of the segments that
  ``Phase3Temporal.ground_query`` returns for held-out samples against
  the true ones, over several seeds.

    python -m avede_tpu_torch.eval --mode grounding [--seed 0]
        [--out results.json] [--device cpu]

It runs on ``cuda`` unless ``--device`` says otherwise, and raises
without a card. ``--out`` writes the results with the device's name (and
on a card its power limit) under ``meta``; the JAX package's
``EVAL.json`` is never written. The other modes of ``eval.py`` (image,
text, library, caption, detection, detection4k, person, background) wait
for ROADMAP.md's item 8b.
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import types
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .utils.platform import resolve_device

MODES = ("grounding",)
LATER_MODES = ("image", "text", "library", "caption", "detection",
               "detection4k", "person", "background")


def _spread_into(out: dict, prefix: str, vals) -> None:
    """The across-seed aggregation (``eval.py:41-48``): the mean under
    ``prefix``, the least and the population std under ``<prefix>_min``
    and ``<prefix>_std``."""
    out[prefix] = float(np.mean(vals))
    out[f"{prefix}_min"] = float(np.min(vals))
    out[f"{prefix}_std"] = float(np.std(vals))


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
    out = {"temporal_grounding": eval_grounding(args.seed, device=dev)}
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
