"""Phase 3 — temporal grounding over cached frame embeddings
(counterpart of ``avede_tpu/pipelines/phase3.py``).

Phase 2 (2× top_k) → the grounding head (``models/univtg.py``) over the
CLIP frame embeddings phase 1 already cached, one forward for all
candidates → boundaries averaged over each candidate's foreground run →
greedy overlap suppression (>50% overlap keeps the higher confidence) →
sort by confidence. Results carry ``start_time``, ``end_time``,
``duration``, ``saliency`` and ``refinement_method``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.convert import load_params
from ..models.univtg import TemporalGroundingConfig, init_grounding
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.trace import trace
from .phase2 import Phase2Rerank

logger = get_logger(__name__)


class Phase3Temporal:
    phase_name = "phase3_univtg"

    def __init__(self, phase2: Phase2Rerank,
                 cfg: Optional[TemporalGroundingConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None
                 ) -> None:
        """The head runs on phase 1's engine device, in the config's
        dtype (float32 by default, as in the JAX package). Weights:
        ``state_dict``, else ``settings.UNIVTG_WEIGHTS``, else random
        from seed 0."""
        self.phase2 = phase2
        engine = phase2.phase1.engine
        self.device = engine.device
        self.cfg = cfg or TemporalGroundingConfig(
            input_dim=engine.cfg.projection_dim)
        model = init_grounding(self.cfg, seed=0)
        weights = settings.UNIVTG_WEIGHTS
        if state_dict is None and weights and Path(weights).exists():
            state_dict = load_params(weights)
            logger.info("Grounding weights loaded from %s", weights)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device, self.cfg.torch_dtype).eval()

    def _forward(self, emb: np.ndarray, text: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Saliency + offsets for ALL frames.

        Frame counts pad to power-of-two buckets, and videos longer than
        the head's ``max_frames`` positional table run as a batch of
        windows (positions restart at 0 in each), padded to a
        power-of-two window count; all-False windows get a uniform
        softmax inside the head and are dropped here."""
        n, d = emb.shape
        cap = min(self.cfg.max_frames,
                  max(8, 1 << (n - 1).bit_length() if n > 1 else 8))
        nw = (n + cap - 1) // cap
        nwb = 1 << max(nw - 1, 0).bit_length()
        padded = np.zeros((nwb, cap, d), np.float32)
        valid = np.zeros((nwb, cap), bool)
        for b in range(nw):
            lo = b * cap
            m = min(cap, n - lo)
            padded[b, :m] = emb[lo:lo + m]
            valid[b, :m] = True
        text_b = np.repeat(np.asarray(text, np.float32)[None], nwb, axis=0)
        dev = self.device
        with torch.inference_mode():
            sal, off = self.model(torch.from_numpy(padded).to(dev),
                                  torch.from_numpy(text_b).to(dev),
                                  torch.from_numpy(valid).to(dev))
        keep = valid.reshape(nwb * cap)
        return (sal.cpu().numpy().reshape(nwb * cap)[keep],
                off.cpu().numpy().reshape(nwb * cap, -1)[keep])

    # ------------------------------------------------------------------
    def process_video(self, video_path: str, query: str,
                      top_k: Optional[int] = None,
                      threshold: Optional[float] = None,
                      video_id: Optional[str] = None) -> List[Dict]:
        top_k = top_k or settings.TOP_K_RESULTS
        candidates = self.phase2.process_video(
            video_path, query, top_k=top_k * 2, threshold=threshold,
            video_id=video_id)
        if not candidates:
            return []
        refined = self.refine_candidates(video_path, query, candidates,
                                         video_id=video_id)
        refined = temporal_consistency(refined)
        refined.sort(key=lambda r: r["confidence"], reverse=True)
        return refined[:top_k]

    def _saliency(self, video_path: str, query: str,
                  video_id: Optional[str]):
        """→ (saliency probabilities [N], offsets [N, 2], timestamps [N],
        median frame step dt) over the whole cached table."""
        p1 = self.phase2.phase1
        emb, ts = p1.frame_embeddings(video_path, video_id)
        text = p1.engine.embed_texts(query)[0]
        sal, off = self._forward(emb, text)
        prob = 1.0 / (1.0 + np.exp(-np.clip(sal, -30, 30)))
        ts_arr = np.asarray(ts)
        dt = float(np.median(np.diff(ts_arr))) if len(ts_arr) > 1 else 1.0
        return prob, off, ts_arr, dt

    def refine_candidates(self, video_path: str, query: str,
                          candidates: List[Dict],
                          video_id: Optional[str] = None) -> List[Dict]:
        """Candidates → refined boundaries."""
        with trace("phase3.ground"):
            prob, off, ts_arr, dt = self._saliency(video_path, query,
                                                   video_id)
        out = []
        for c in candidates:
            i = int(np.argmin(np.abs(ts_arr - c["timestamp"])))
            start, end = _run_averaged_bounds(prob, off, ts_arr, dt, i)
            if end - start < dt:
                end = start + dt
            conf = float(c["confidence"] * (0.5 + 0.5 * prob[i]))
            out.append({
                **{k: v for k, v in c.items()
                   if k not in ("phase", "confidence")},
                "timestamp": c["timestamp"],
                "start_time": start,
                "end_time": end,
                "duration": end - start,
                "confidence": conf,
                "saliency": float(prob[i]),
                "phase": self.phase_name,
                "refinement_method": "grounding_head",
            })
        return out

    def ground_query(self, video_path: str, query: str, top_k: int = 5,
                     video_id: Optional[str] = None) -> List[Dict]:
        """Direct query→segments grounding, no candidate stage: segments
        come straight from saliency peaks + offsets."""
        prob, off, ts_arr, dt = self._saliency(video_path, query, video_id)
        order = np.argsort(prob)[::-1][: top_k * 4]
        segs = []
        for i in order:
            start, end = _run_averaged_bounds(prob, off, ts_arr, dt, i)
            end = max(end, start + dt)
            segs.append({"timestamp": float(ts_arr[i]),
                         "start_time": start, "end_time": end,
                         "duration": end - start,
                         "confidence": float(prob[i]),
                         "phase": self.phase_name,
                         "refinement_method": "grounding_head"})
        segs = temporal_consistency(segs)
        segs.sort(key=lambda s: s["confidence"], reverse=True)
        return segs[:top_k]


def _run_averaged_bounds(prob: np.ndarray, off: np.ndarray,
                         ts_arr: np.ndarray, dt: float, i: int,
                         thresh: float = 0.5):
    """Segment boundaries for anchor ``i``, saliency-weighted over the
    contiguous foreground run (prob ≥ ``thresh``) around it: every
    foreground frame regresses the same segment, so averaging cancels
    per-frame regression noise. Clamped so the anchor stays inside."""
    n = len(ts_arr)
    lo = i
    while lo - 1 >= 0 and prob[lo - 1] >= thresh:
        lo -= 1
    hi = i
    while hi + 1 < n and prob[hi + 1] >= thresh:
        hi += 1
    idx = np.arange(lo, hi + 1)
    w = prob[idx]
    if idx.size >= 2 and float(w.sum()) > 0.0:
        start = float(np.average(ts_arr[idx] - off[idx, 0] * dt,
                                 weights=w))
        end = float(np.average(ts_arr[idx] + off[idx, 1] * dt,
                               weights=w))
    else:
        start = float(ts_arr[i] - off[i, 0] * dt)
        end = float(ts_arr[i] + off[i, 1] * dt)
    start = min(max(0.0, start), float(ts_arr[i]))
    end = max(end, float(ts_arr[i]))
    return start, end


def temporal_consistency(results: List[Dict]) -> List[Dict]:
    """Greedy overlap suppression: drop a segment when it overlaps an
    accepted one by >50% of either's duration, keeping the higher
    confidence."""
    if len(results) <= 1:
        return list(results)
    kept: List[Dict] = []
    for cur in sorted(results, key=lambda r: r["timestamp"]):
        cs = cur.get("start_time", cur["timestamp"] - 2.5)
        ce = cur.get("end_time", cur["timestamp"] + 2.5)
        add = True
        for ex in list(kept):
            es = ex.get("start_time", ex["timestamp"] - 2.5)
            ee = ex.get("end_time", ex["timestamp"] + 2.5)
            ov = max(0.0, min(ce, ee) - max(cs, es))
            if ov > 0.5 * (ce - cs) or ov > 0.5 * (ee - es):
                if cur["confidence"] <= ex["confidence"]:
                    add = False
                    break
                kept.remove(ex)
        if add:
            kept.append(cur)
    return kept
