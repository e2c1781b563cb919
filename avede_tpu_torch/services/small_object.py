"""Small-object detection over video — tiled, proposal-guided, adaptive
(counterpart of ``avede_tpu/services/small_object.py``).

1. tile each frame into a fixed grid (``ops/tiling.py``) and run every
   tile of the frame through open-vocabulary detection in one call;
2. optionally boost detections that overlap saliency, motion or edge
   region proposals (``region_proposals.py``);
3. apply the size-category adaptive thresholds
   (``adaptive_threshold.py``) and merge duplicates across overlapping
   tiles (``merge_detections``);
4. keep sizes in the requested [min, max] pixel range, rank, and
   optionally re-score the top candidates with background-removed crop
   embeddings (``background_independent.py``).

Frames are read at up to 4096 px a side: small objects die in
downscaling.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..io.video_reader import VideoReader
from ..ops.boxes import pairwise_iou
from ..ops.tiling import tile_frame, tile_grid
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from .adaptive_threshold import AdaptiveThresholdSystem, DetectionContext
from .region_proposals import RegionProposalService
from .universal_detector import UniversalDetector, merge_detections

logger = get_logger(__name__)


class SmallObjectService:
    def __init__(self, engine: ClipEngine,
                 detector: Optional[UniversalDetector] = None,
                 reader: Optional[VideoReader] = None,
                 tile: Optional[int] = None,
                 overlap: Optional[int] = None) -> None:
        self.engine = engine
        self._detector = detector
        self.reader = reader or VideoReader(max_side=4096)
        # `is not None`: an explicit overlap=0 is a valid configuration
        self.tile = tile if tile is not None else settings.TILE_SIZE
        self.overlap = (overlap if overlap is not None
                        else settings.TILE_OVERLAP)
        self.proposals = RegionProposalService()
        self.thresholds = AdaptiveThresholdSystem()
        self._bg_service = None

    @property
    def detector(self) -> UniversalDetector:
        if self._detector is None:
            self._detector = UniversalDetector(self.engine)
        return self._detector

    # ------------------------------------------------------------------
    def detect_in_frame(self, frame: np.ndarray,
                        queries: Sequence[str],
                        conf_threshold: float = 0.2,
                        enable_rpn: bool = True,
                        context: Optional[DetectionContext] = None,
                        enable_adaptive_thresholds: bool = True,
                        detection_mode: str = "clip") -> List[Dict]:
        tiles, offsets = tile_frame(frame, self.tile, self.overlap)
        # dedup=False: tiles are spatial crops of one frame, so a blank
        # tile must not take (or give) the detections of a near-equal
        # neighbour at another offset
        dets_per_tile = self.detector.detect_unlimited_objects(
            tiles, list(queries), detection_mode=detection_mode,
            conf_threshold=conf_threshold, adaptive=False, dedup=False)
        dets: List[Dict] = []
        for t, tile_dets in enumerate(dets_per_tile):
            oy, ox = offsets[t]
            for d in tile_dets:
                b = d["bbox"]
                dets.append({**d, "bbox": [b[0] + ox, b[1] + oy,
                                           b[2] + ox, b[3] + oy],
                             "tile": t})
        if enable_rpn:
            props = self.proposals.generate_proposals(frame)
            dets = self._boost_by_proposals(dets, props)
        if enable_adaptive_thresholds:
            dets = self.thresholds.apply(dets, context=context)
        return merge_detections(dets)

    @staticmethod
    def _boost_by_proposals(dets: List[Dict], props: List[Dict],
                            iou_thr: float = 0.3) -> List[Dict]:
        """×1.15 confidence (capped at 1) for detections that overlap a
        proposal above ``iou_thr``."""
        if not dets or not props:
            return dets
        db = torch.tensor([d["bbox"] for d in dets], dtype=torch.float32)
        pb = torch.tensor([p["bbox"] for p in props], dtype=torch.float32)
        iou = pairwise_iou(db, pb).numpy()
        for i, d in enumerate(dets):
            if (iou[i] > iou_thr).any():
                d["confidence"] = float(min(d["confidence"] * 1.15, 1.0))
                d["proposal_supported"] = True
        return dets

    # ------------------------------------------------------------------
    def detect_in_video(self, video_path: str, queries: Sequence[str],
                        min_object_size: int = 16,
                        max_object_size: int = 128,
                        confidence_threshold: float = 0.2,
                        top_k: int = 20,
                        enable_background_independence: bool = True,
                        enable_adaptive_thresholds: bool = True,
                        enable_rpn: bool = True,
                        sample_rate: Optional[int] = None,
                        video_id: Optional[str] = None,
                        detection_mode: str = "clip") -> Dict:
        t0 = time.time()
        self.proposals.reset()
        frames, timestamps = self.reader.extract_frames(
            video_path, sample_rate=sample_rate,
            max_frames=min(settings.MAX_FRAMES, 60))

        results: List[Dict] = []
        stats = {"tiles_processed": 0, "proposals_used": 0,
                 "size_filtered": 0, "bg_features": 0}
        prev = None
        for i, frame in enumerate(frames):
            ctx = DetectionContext.from_frame(frame, prev)
            prev = frame
            dets = self.detect_in_frame(
                frame, queries, conf_threshold=confidence_threshold,
                enable_rpn=enable_rpn, context=ctx,
                enable_adaptive_thresholds=enable_adaptive_thresholds,
                detection_mode=detection_mode)
            stats["tiles_processed"] += len(tile_grid(
                frame.shape[0], frame.shape[1], self.tile, self.overlap))
            for d in dets:
                x0, y0, x1, y1 = d["bbox"]
                side = float(np.sqrt(max(x1 - x0, 1) * max(y1 - y0, 1)))
                if not (min_object_size <= side <= max_object_size):
                    stats["size_filtered"] += 1
                    continue
                d["timestamp"] = float(timestamps[i])
                d["frame_index"] = i
                d["object_size"] = side
                if d.get("proposal_supported"):
                    stats["proposals_used"] += 1
                results.append(d)

        # rank first so GrabCut (host-bound) only touches the candidates
        # that can surface
        results.sort(key=lambda d: d["confidence"], reverse=True)
        results = results[: top_k * 2]
        if enable_background_independence and results:
            results = self._add_background_features(frames, results,
                                                    queries, stats)
            results.sort(key=lambda d: d["confidence"], reverse=True)
        results = results[:top_k]
        small = sum(1 for d in results
                    if d.get("size_category") in ("tiny", "small"))
        return {
            "results": results,
            "total_found": len(results),
            "small_objects_found": small,
            "enhancement_stats": {**stats,
                                  "processing_time": time.time() - t0},
            "metadata": {"frames_processed": len(frames),
                         "tile_size": self.tile,
                         "tile_overlap": self.overlap,
                         "size_range": [min_object_size, max_object_size]},
        }

    def _add_background_features(self, frames, results, queries,
                                 stats) -> List[Dict]:
        """Re-score with background-removed crop embeddings: 0.7 of the
        confidence + 0.3 of the best positive crop ↔ query cosine."""
        from .background_independent import BackgroundIndependentService

        if self._bg_service is None:
            self._bg_service = BackgroundIndependentService(self.engine)
        bg = self._bg_service
        text = self.engine.embed_texts(list(queries))
        for d in results:
            frame = frames[d["frame_index"]]
            feat = bg.extract_features(frame, d["bbox"])
            if feat is None:
                continue
            sims = feat["embedding"] @ text.T
            qi = int(np.argmax(sims))
            d["bg_independent_similarity"] = float(sims[qi])
            d["confidence"] = float(np.clip(
                0.7 * d["confidence"] + 0.3 * max(sims[qi], 0.0), 0, 1))
            stats["bg_features"] += 1
        return results
