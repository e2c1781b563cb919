"""Video-level open-vocabulary matching (counterpart of
``avede_tpu/services/open_vocab_matcher.py``).

Stream 16-frame batches (at most ``min(MAX_FRAMES, 200)`` frames) →
per-batch unlimited detection (``UniversalDetector``) under adaptive
thresholds → enhancement scores per detection (visual quality, semantic
relevance, size) → composite ``0.4·conf + 0.3·sem + 0.2·vis + 0.1·size``
→ the precision threshold → temporal dedup (Δt ≤ 2 s, IoU ≥ 0.5, same
query; ``ops/hostops.temporal_dedup``) → the precision's rank. The
visual quality uses ``ops/image_stats.py``, equal to the JAX package's
OpenCV calls.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io.video_reader import VideoReader
from ..ops import hostops, image_stats
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from .adaptive_threshold import DetectionContext
from .universal_detector import UniversalDetector

logger = get_logger(__name__)

COMPOSITE_WEIGHTS = {"confidence": 0.4, "semantic": 0.3, "visual": 0.2,
                     "size": 0.1}


class OpenVocabMatcher:
    def __init__(self, engine: ClipEngine,
                 detector: Optional[UniversalDetector] = None,
                 reader: Optional[VideoReader] = None) -> None:
        self.engine = engine
        self._detector = detector
        self.reader = reader or VideoReader()
        self.stats = {"videos": 0, "detections": 0, "seconds": 0.0}

    @property
    def detector(self) -> UniversalDetector:
        if self._detector is None:
            self._detector = UniversalDetector(self.engine)
        return self._detector

    # ------------------------------------------------------------------
    def match_unlimited_objects(self, video_path: str,
                                queries: Sequence[str],
                                detection_mode: str = "hybrid",
                                matching_precision: str = "balanced",
                                top_k: int = 10,
                                confidence_threshold: float = 0.3,
                                sample_rate: Optional[int] = None,
                                batch_size: int = 16,
                                video_id: Optional[str] = None) -> Dict:
        t0 = time.time()
        precision_thr = settings.MATCHING_PRECISIONS.get(
            matching_precision, confidence_threshold)
        # the reader's decode threads fill the next batch while the
        # device detects the current one
        results: List[Dict] = []
        prev = None
        n_frames = 0
        for batch, ts_batch in self.reader.stream_batches(
                video_path, batch_size, sample_rate=sample_rate,
                max_frames=min(settings.MAX_FRAMES, 200)):
            contexts = []
            for f in batch:
                contexts.append(DetectionContext.from_frame(f, prev))
                prev = f
            dets_per_frame = self.detector.detect_unlimited_objects(
                batch, list(queries), detection_mode=detection_mode,
                conf_threshold=min(confidence_threshold, precision_thr),
                contexts=contexts)
            for i, dets in enumerate(dets_per_frame):
                for d in dets:
                    d = self._enhance(d, batch[i], queries)
                    d["timestamp"] = float(ts_batch[i])
                    d["frame_index"] = n_frames + i
                    results.append(d)
            n_frames += len(batch)

        results = [r for r in results
                   if r["composite_score"] >= precision_thr]
        results = self._deduplicate(results)
        results = self._rank(results, matching_precision)[:top_k]

        dt = time.time() - t0
        self.stats["videos"] += 1
        self.stats["detections"] += len(results)
        self.stats["seconds"] += dt
        return {
            "results": results,
            "total_found": len(results),
            "metadata": {
                "frames_processed": n_frames,
                "detection_mode": detection_mode,
                "matching_precision": matching_precision,
                "precision_threshold": precision_thr,
                "processing_time": dt,
            },
        }

    # ------------------------------------------------------------------
    def _enhance(self, det: Dict, frame: np.ndarray,
                 queries: Sequence[str]) -> Dict:
        """Visual-quality, semantic-relevance and size scores."""
        h, w = frame.shape[:2]
        x0, y0, x1, y1 = [int(v) for v in det["bbox"]]
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, w), min(y1, h)
        crop = frame[y0:y1, x0:x1]

        if crop.size > 0:
            gray = image_stats.rgb_to_gray(crop)
            sharp = min(image_stats.laplacian(gray).var() / 500.0, 1.0)
            contrast = min(gray.std() / 64.0, 1.0)
            bright = 1.0 - abs(gray.mean() / 255.0 - 0.5) * 2.0
            visual = 0.4 * sharp + 0.3 * contrast + 0.3 * bright
        else:
            visual = 0.0

        # semantic relevance: method prior × query-complexity bonus
        method_mult = {"owlvit": 1.0, "clip_grid": 0.85,
                       "yolo_enhanced": 0.9}.get(det.get("method"), 0.8)
        q = det.get("query") or ""
        complexity = min(len(q.split()) / 5.0, 1.0) * 0.2
        semantic = min(det.get("query_similarity",
                               det["confidence"]) * method_mult
                       + complexity, 1.0)

        # size score: ideal 1–50% of frame, aspect penalty
        area_frac = max((x1 - x0) * (y1 - y0), 1) / float(h * w)
        if 0.01 <= area_frac <= 0.5:
            size_score = 1.0
        elif area_frac < 0.01:
            size_score = area_frac / 0.01
        else:
            size_score = max(1.0 - (area_frac - 0.5), 0.1)
        bw, bh = max(x1 - x0, 1), max(y1 - y0, 1)
        aspect = max(bw / bh, bh / bw)
        if aspect > 4.0:
            size_score *= 0.7

        comp = (COMPOSITE_WEIGHTS["confidence"] * det["confidence"]
                + COMPOSITE_WEIGHTS["semantic"] * semantic
                + COMPOSITE_WEIGHTS["visual"] * visual
                + COMPOSITE_WEIGHTS["size"] * size_score)
        return {**det, "visual_quality": float(visual),
                "semantic_relevance": float(semantic),
                "size_score": float(size_score),
                "composite_score": float(comp)}

    @staticmethod
    def _deduplicate(results: List[Dict], time_window: float = 2.0,
                     iou_threshold: float = 0.5) -> List[Dict]:
        """Same query, Δt ≤ 2 s and IoU ≥ 0.5 → keep the best
        composite."""
        if len(results) <= 1:
            return list(results)
        order = sorted(results, key=lambda r: r["composite_score"],
                       reverse=True)
        boxes = np.asarray([r["bbox"] for r in order], np.float32)
        times = np.asarray([r["timestamp"] for r in order], np.float32)
        queries = {q: i for i, q in enumerate(
            {r.get("query") for r in order})}
        qids = np.asarray([queries[r.get("query")] for r in order],
                          np.int32)
        keep = hostops.temporal_dedup(boxes, times, qids, time_window,
                                      iou_threshold)
        return [order[i] for i in keep]

    @staticmethod
    def _rank(results: List[Dict], precision: str) -> List[Dict]:
        key = {
            "semantic": lambda r: r["semantic_relevance"],
            "visual": lambda r: r["visual_quality"],
            "precise": lambda r: r["confidence"],
        }.get(precision, lambda r: r["composite_score"])
        return sorted(results, key=key, reverse=True)

    # ------------------------------------------------------------------
    def suggest_queries(self, partial: str = "") -> List[str]:
        """Query suggestions."""
        base = [
            "person walking", "person running", "red car", "blue car",
            "dog", "cat", "bicycle", "truck", "traffic light", "backpack",
            "person wearing red shirt", "white van", "motorcycle",
            "person with umbrella", "delivery truck",
        ]
        if partial:
            p = partial.lower()
            return [s for s in base if p in s][:10]
        return base[:10]
