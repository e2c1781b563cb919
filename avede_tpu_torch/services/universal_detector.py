"""Open-vocabulary detection hub (counterpart of
``avede_tpu/services/universal_detector.py``).

Dispatches a frame batch to one of four modes: ``owlvit`` (OWL-ViT B/32,
flash attention at L = 577 in every vision layer), ``clip`` (the CLIP
cell grid), ``yolo_enhanced`` (YOLO boxes filtered by CLIP crop ↔ query
similarity fused with a lexical class-name match) and ``hybrid`` (OWL-ViT
and the CLIP grid on the same batch, merged by IoU). Near-duplicate
consecutive frames run the detectors once per run representative
(``ops/dedup.FrameDeduper``); adaptive thresholds filter and boost the
result.

The OWL-ViT step follows the JAX package's jitted program: sigmoid of
the class logits, best query per patch, cxcywh → xyxy, then padded NMS
with indices, so each kept box keeps its query; all of it on the device
for the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.convert import load_params
from ..models.owlvit import (OwlViTConfig, OwlViTDetector, init_owlvit,
                             owlvit_base_patch32)
from ..models.tokenizer import Tokenizer
from ..ops.boxes import cxcywh_to_xyxy, pairwise_iou
from ..ops.nms import nms_padded
from ..ops.preprocess import clip_preprocess
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.platform import with_compute_dtype
from ..utils.trace import trace
from .adaptive_threshold import AdaptiveThresholdSystem, DetectionContext
from .detector import ClipGridDetector, YoloService, \
    extract_object_embeddings

logger = get_logger(__name__)


class UniversalDetector:
    """The detection modes over one CLIP engine; OWL-ViT and YOLO run on
    the engine's device. OWL-ViT weights: ``owlvit_state_dict``, else
    ``settings.OWLVIT_WEIGHTS``, else random from seed 0."""

    def __init__(self, engine: ClipEngine,
                 owlvit_cfg: Optional[OwlViTConfig] = None,
                 owlvit_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 yolo: Optional[YoloService] = None) -> None:
        self.engine = engine
        self.device = engine.device
        cfg = owlvit_cfg or with_compute_dtype(owlvit_base_patch32(),
                                               self.device)
        # the serving configuration: flash attention in every vision layer
        self.owl_cfg = dataclasses.replace(cfg, use_flash=True)
        model = init_owlvit(self.owl_cfg, seed=0)
        if owlvit_state_dict is None and settings.OWLVIT_WEIGHTS:
            owlvit_state_dict = load_params(settings.OWLVIT_WEIGHTS)
            logger.info("OWL-ViT weights loaded")
        elif owlvit_state_dict is None:
            logger.info("OWL-ViT randomly initialised (no checkpoint)")
        if owlvit_state_dict is not None:
            model.load_state_dict(owlvit_state_dict)
        self.owl: OwlViTDetector = model.to(
            self.device, self.owl_cfg.torch_dtype).eval()
        self.owl_tokenizer = Tokenizer(vocab_size=self.owl_cfg.vocab_size,
                                       context_len=self.owl_cfg.max_text_len)
        self._yolo = yolo
        self.clip_grid = ClipGridDetector(engine)
        self.thresholds = AdaptiveThresholdSystem()

    @property
    def yolo(self) -> YoloService:
        if self._yolo is None:
            self._yolo = YoloService(device=self.device)
        return self._yolo

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def owl_forward(self, frames: np.ndarray, ids: np.ndarray):
        """uint8 [N, H, W, 3] frames × query ids → OWL-ViT (logits
        [N, P, Q], boxes [N, P, 4] cxcywh) on the square center crop."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        px = clip_preprocess(x, size=self.owl_cfg.image_size)
        return self.owl(px, torch.from_numpy(ids).to(self.device))

    @torch.inference_mode()
    def _owl_run(self, frames: np.ndarray, ids: np.ndarray,
                 conf_thr: float):
        logits, boxes_cxcywh = self.owl_forward(frames, ids)
        probs = torch.sigmoid(logits)                    # [N, P, Q]
        score, qidx = probs.amax(dim=-1), probs.argmax(dim=-1)
        boxes = cxcywh_to_xyxy(boxes_cxcywh)
        masked = torch.where(score >= conf_thr, score,
                             torch.full_like(score, float("-inf")))
        ob, os_, valid, idx = nms_padded(
            boxes, masked, settings.DETECTION_IOU_THRESHOLD,
            settings.DETECTION_MAX_OBJECTS, return_indices=True)
        return ob, os_, valid, torch.gather(qidx, 1, idx)

    def detect_owlvit(self, frames: np.ndarray, queries: Sequence[str],
                      conf_threshold: float = 0.1) -> List[List[Dict]]:
        """Batched OWL-ViT detection; boxes in source-frame pixels."""
        if len(frames) == 0:
            return []
        ids = self.owl_tokenizer(list(queries))
        with trace("owlvit.detect"):
            ob, os_, valid, qidx_all = (t.cpu().numpy() for t in
                                        self._owl_run(frames, ids, float(
                                            np.float32(conf_threshold))))
        h, w = frames.shape[1:3]
        # square-crop preprocessing maps boxes to the central square
        s = min(h, w)
        ox, oy = (w - s) / 2, (h - s) / 2
        out: List[List[Dict]] = []
        for b in range(len(frames)):
            dets = []
            for i in np.nonzero(valid[b])[0]:
                x0, y0, x1, y1 = ob[b, i]
                dets.append({
                    "bbox": [float(x0 * s + ox), float(y0 * s + oy),
                             float(x1 * s + ox), float(y1 * s + oy)],
                    "confidence": float(os_[b, i]),
                    # the class head's own best query, carried through
                    # NMS by the kept indices
                    "query": queries[int(qidx_all[b, i])],
                    "method": "owlvit",
                })
            out.append(dets)
        # annotate with CLIP crop ↔ query similarity (composite scoring
        # reads query_similarity)
        self._attach_queries(out, frames, queries)
        return out

    def _attach_queries(self, dets_per_frame, frames, queries) -> None:
        """Annotate detections with CLIP crop ↔ query similarity; fills
        ``query`` only where the detector did not label it."""
        text = self.engine.embed_texts(list(queries))
        for frame, dets in zip(frames, dets_per_frame):
            if not dets:
                continue
            emb = extract_object_embeddings(self.engine, frame,
                                            [d["bbox"] for d in dets])
            sims = emb @ text.T
            for d, row in zip(dets, sims):
                if d.get("query") is None:
                    d["query"] = queries[int(np.argmax(row))]
                d["query_similarity"] = float(np.max(row))

    # ------------------------------------------------------------------
    def detect_yolo_enhanced(self, frames: np.ndarray,
                             queries: Sequence[str],
                             conf_threshold: float = 0.25
                             ) -> List[List[Dict]]:
        """YOLO boxes kept where CLIP crop ↔ query cosine fused with the
        class-name ↔ query word Jaccard (0.7 / 0.3) exceeds 0.12."""
        det = self.yolo.detect(frames, conf_threshold)
        text = self.engine.embed_texts(list(queries))
        q_tokens = [set(q.lower().split()) for q in queries]
        out = []
        for frame, dets in zip(frames, det):
            kept = []
            if dets:
                emb = extract_object_embeddings(
                    self.engine, frame, [d["bbox"] for d in dets])
                sims = emb @ text.T
                for d, row in zip(dets, sims):
                    cls_tokens = set(d["class_name"].lower().split())
                    lex = np.asarray([
                        len(cls_tokens & qt) / max(len(cls_tokens | qt), 1)
                        for qt in q_tokens])
                    fused = 0.7 * np.maximum(row, 0.0) + 0.3 * lex
                    qi = int(np.argmax(fused))
                    if fused[qi] > 0.12:
                        kept.append({**d, "query": queries[qi],
                                     "query_similarity": float(row[qi]),
                                     "lexical_similarity": float(lex[qi]),
                                     "method": "yolo_enhanced",
                                     "confidence":
                                         float(d["confidence"] * 0.5
                                               + 0.5 * min(fused[qi], 1.0))})
            out.append(kept)
        return out

    # ------------------------------------------------------------------
    def detect_unlimited_objects(self, frames: np.ndarray,
                                 queries: Sequence[str],
                                 detection_mode: str = "hybrid",
                                 conf_threshold: float = 0.3,
                                 contexts: Optional[
                                     List[DetectionContext]] = None,
                                 adaptive: bool = True,
                                 dedup: bool = True
                                 ) -> List[List[Dict]]:
        """Frame-batch open-vocabulary detection in any mode. Runs of
        near-duplicate consecutive frames (``SCAN_DEDUP_EPS``) run the
        detectors once per representative; callers whose batch is not
        consecutive frames pass ``dedup=False``."""
        def run(fb) -> List[List[Dict]]:
            if detection_mode == "owlvit":
                return self.detect_owlvit(fb, queries, conf_threshold)
            if detection_mode == "clip":
                return self.clip_grid.detect(fb, queries, conf_threshold)
            if detection_mode == "yolo_enhanced":
                return self.detect_yolo_enhanced(fb, queries,
                                                 conf_threshold)
            if detection_mode == "hybrid":
                a = self.detect_owlvit(fb, queries, conf_threshold)
                b = self.clip_grid.detect(fb, queries, conf_threshold)
                return [merge_detections(x + y) for x, y in zip(a, b)]
            raise ValueError(f"unknown detection mode '{detection_mode}' "
                             f"(expected one of {settings.DETECTION_MODES})")

        eps = settings.SCAN_DEDUP_EPS if dedup else 0.0
        if eps > 0 and len(frames) > 1:
            from ..ops.dedup import FrameDeduper

            deduper = FrameDeduper(eps)
            uniq = deduper.filter(np.asarray(frames))
            if deduper.n_unique < deduper.n_total:
                uniq_dets = run(uniq)
                # fresh dicts per frame: the thresholds below and the
                # callers annotate them frame by frame
                dets = [[dict(d) for d in uniq_dets[m]]
                        for m in deduper.mapping]
            else:
                dets = run(np.asarray(frames))
        else:
            dets = run(frames)
        if adaptive:
            dets = [
                self.thresholds.apply(
                    d, context=(contexts[i] if contexts else None))
                for i, d in enumerate(dets)]
        return dets


def merge_detections(dets: List[Dict], iou_threshold: float = 0.5
                     ) -> List[Dict]:
    """Cross-method IoU dedup, keeping the higher confidence of two
    overlapping detections of one query."""
    if len(dets) <= 1:
        return list(dets)
    dets = sorted(dets, key=lambda d: d["confidence"], reverse=True)
    boxes = torch.tensor([d["bbox"] for d in dets], dtype=torch.float32)
    iou = pairwise_iou(boxes, boxes).numpy()
    kept: List[int] = []
    for i in range(len(dets)):
        if all(iou[i, j] <= iou_threshold
               or dets[i].get("query") != dets[j].get("query")
               for j in kept):
            kept.append(i)
    return [dets[i] for i in kept]
