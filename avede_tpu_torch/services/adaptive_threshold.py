"""Size- and context-aware confidence thresholds (counterpart of
``avede_tpu/services/adaptive_threshold.py``).

Size categories with base thresholds and confidence boosts, context
adjustments (motion, noise, lighting, complexity, blur), per-scale
weights, and thresholds re-fitted from the recorded detection history.
``DetectionContext.from_frame`` computes its frame statistics with
``ops/image_stats.py``, equal to the OpenCV calls of the JAX package.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from ..ops import image_stats
from ..utils.config import settings
from ..utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class DetectionContext:
    """Frame statistics driving threshold adaptation."""

    motion_level: float = 0.0      # mean abs diff vs previous frame [0,1]
    noise_level: float = 0.0       # estimated σ of high-freq residual [0,1]
    brightness: float = 0.5        # mean luminance [0,1]
    edge_density: float = 0.0      # Canny edge fraction [0,1]
    sharpness: float = 0.5         # normalized Laplacian variance [0,1]

    @classmethod
    def from_frame(cls, frame: np.ndarray,
                   prev_frame: Optional[np.ndarray] = None
                   ) -> "DetectionContext":
        gray = image_stats.rgb_to_gray(frame)
        brightness = float(gray.mean()) / 255.0
        lap = image_stats.laplacian(gray)
        sharpness = float(min(lap.var() / 1000.0, 1.0))
        edges = image_stats.canny(gray, 50, 150)
        edge_density = float((edges > 0).mean())
        blur = image_stats.gaussian_blur5(gray)
        noise = float(min(np.abs(gray.astype(np.float32)
                                 - blur.astype(np.float32)).mean() / 50.0,
                          1.0))
        motion = 0.0
        if prev_frame is not None and prev_frame.shape == frame.shape:
            pg = image_stats.rgb_to_gray(prev_frame)
            motion = float(min(np.abs(gray.astype(np.float32)
                                      - pg.astype(np.float32)).mean() / 64.0,
                               1.0))
        return cls(motion, noise, brightness, edge_density, sharpness)


@dataclasses.dataclass
class AdaptiveResult:
    threshold: float
    size_category: str
    base_threshold: float
    confidence_boost: float
    adjustments: Dict[str, float]
    reasoning: str


class AdaptiveThresholdSystem:
    def __init__(self, history_size: int = 500) -> None:
        self._lock = threading.Lock()
        self._history: Deque[Tuple[str, float, bool]] = deque(
            maxlen=history_size)
        self._learned: Dict[str, float] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def size_category(area_px: float) -> str:
        for cat, (lo, hi) in settings.SMALL_OBJECT_SIZES.items():
            if lo <= area_px < hi:
                return cat
        return "large"

    def calculate_threshold(self, bbox: Optional[List[float]] = None,
                            size_category: Optional[str] = None,
                            context: Optional[DetectionContext] = None,
                            scale: Optional[int] = None) -> AdaptiveResult:
        """Threshold for a detection of a given size under a context."""
        if size_category is None:
            if bbox is None:
                size_category = "medium"
            else:
                area = max(bbox[2] - bbox[0], 0) * max(bbox[3] - bbox[1], 0)
                size_category = self.size_category(area)
        base = self._learned.get(
            size_category,
            settings.SMALL_OBJECT_BASE_THRESHOLDS.get(size_category, 0.25))
        boost = settings.SMALL_OBJECT_BOOSTS.get(size_category, 1.0)

        adj: Dict[str, float] = {}
        thr = base
        if context is not None:
            if context.motion_level > 0.5:
                adj["motion"] = -0.03
            if context.noise_level > 0.5:
                adj["noise"] = +0.05
            if context.brightness < 0.25 or context.brightness > 0.9:
                adj["lighting"] = +0.04
            if context.edge_density > 0.25:
                adj["complexity"] = +0.03
            if context.sharpness < 0.2:
                adj["blur"] = +0.04
            thr = base + sum(adj.values())
        if scale is not None:
            w = settings.MULTI_SCALE_WEIGHTS.get(str(scale), 1.0)
            adj["scale"] = thr * (1.0 / w - 1.0)
            thr = thr / w
        thr = float(np.clip(thr, 0.01, 0.95))

        reasons = [f"size={size_category} base={base:.2f}"]
        reasons += [f"{k}{v:+.2f}" for k, v in adj.items()]
        return AdaptiveResult(threshold=thr, size_category=size_category,
                              base_threshold=base, confidence_boost=boost,
                              adjustments=adj,
                              reasoning="; ".join(reasons))

    def apply(self, detections: List[Dict],
              context: Optional[DetectionContext] = None,
              scale: Optional[int] = None) -> List[Dict]:
        """Filter and boost a detection list in place of a flat
        threshold."""
        out = []
        for d in detections:
            res = self.calculate_threshold(bbox=d.get("bbox"),
                                           context=context, scale=scale)
            conf = d.get("confidence", 0.0)
            if conf >= res.threshold:
                boosted = float(min(conf * res.confidence_boost, 1.0))
                out.append({**d, "confidence": boosted,
                            "raw_confidence": conf,
                            "size_category": res.size_category,
                            "adaptive_threshold": res.threshold})
        return out

    # ------------------------------------------------------------------
    def record_outcome(self, size_category: str, confidence: float,
                       was_correct: bool) -> None:
        with self._lock:
            self._history.append((size_category, confidence, was_correct))

    def optimize(self, min_samples: int = 100) -> Dict[str, float]:
        """Re-fit per-category thresholds from the outcome history."""
        with self._lock:
            hist = list(self._history)
        if len(hist) < min_samples:
            return dict(self._learned)
        by_cat: Dict[str, List[Tuple[float, bool]]] = {}
        for cat, conf, ok in hist:
            by_cat.setdefault(cat, []).append((conf, ok))
        for cat, samples in by_cat.items():
            if len(samples) < 20:
                continue
            wrong = sorted(c for c, ok in samples if not ok)
            if wrong:
                # set threshold just above the 75th percentile of
                # false-positive confidences
                self._learned[cat] = float(np.clip(
                    np.percentile(wrong, 75) + 0.02, 0.02, 0.9))
        logger.info("Adaptive thresholds optimized: %s", self._learned)
        return dict(self._learned)
