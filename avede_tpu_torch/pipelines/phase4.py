"""Phase 4: the image-query pipeline (counterpart of
``avede_tpu/pipelines/phase4.py``).

Mode dispatch to ``ImageMatcher`` with each mode's default threshold,
a quality score per match (similarity blended with the spread of its
method scores and the number of methods agreeing), clips cut around
each match by ``ClipWriter`` (their names land on the matches), batch
and mode-comparison utilities, and counters by mode.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io.clip_writer import ClipWriter
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from ..services.image_matcher import ImageMatcher

logger = get_logger(__name__)


class Phase4ImageMatching:
    phase_name = "phase4_image_matching"

    def __init__(self, engine: ClipEngine,
                 matcher: Optional[ImageMatcher] = None,
                 clip_writer: Optional[ClipWriter] = None,
                 cache=None) -> None:
        self.engine = engine
        self._matcher = matcher
        self._cache = cache
        self.clip_writer = clip_writer or ClipWriter()
        self.stats = {"queries": 0, "matches": 0, "seconds": 0.0,
                      "by_mode": {}}

    @property
    def matcher(self) -> ImageMatcher:
        if self._matcher is None:
            # share the facade's embedding cache INSTANCE (not just its
            # directory): sparse-entry upgrades done here must land in
            # the same in-memory tier phases 1 and 3 read, or their stale
            # sparse copy triggers a redundant backfill later
            self._matcher = ImageMatcher(self.engine, cache=self._cache)
        return self._matcher

    # ------------------------------------------------------------------
    def process_image_query(self, video_path: str, image: np.ndarray,
                            matching_mode: str = "smart_match",
                            target_class: Optional[str] = None,
                            top_k: Optional[int] = None,
                            similarity_threshold: Optional[float] = None,
                            extract_clips: bool = True,
                            video_id: Optional[str] = None) -> Dict:
        t0 = time.time()
        top_k = top_k or settings.TOP_K_RESULTS
        matches = self.matcher.match_image_to_video(
            video_path, image, mode=matching_mode,
            target_class=target_class, top_k=top_k,
            threshold=similarity_threshold, video_id=video_id)

        for m in matches:
            m["phase"] = self.phase_name
            m["quality_score"] = self._quality(m)

        clips: List[Dict] = []
        if extract_clips:
            clips = self._extract_clips(video_path, matches)

        dt = time.time() - t0
        self.stats["queries"] += 1
        self.stats["matches"] += len(matches)
        self.stats["seconds"] += dt
        mode_stats = self.stats["by_mode"].setdefault(
            matching_mode, {"queries": 0, "matches": 0})
        mode_stats["queries"] += 1
        mode_stats["matches"] += len(matches)

        return {
            "results": matches,
            "clips": clips,
            "total_found": len(matches),
            "metadata": {
                "matching_mode": matching_mode,
                "target_class": target_class,
                "threshold": similarity_threshold
                if similarity_threshold is not None
                else settings.MATCHING_THRESHOLDS.get(matching_mode),
            },
            "performance": {"processing_time": dt,
                            "matches_found": len(matches)},
        }

    @staticmethod
    def _quality(match: Dict) -> float:
        """Quality = similarity blended with method agreement and
        breadth, clipped to [0, 1]."""
        sim = match["similarity"]
        breakdown = match.get("breakdown", {})
        consistency = 0.0
        if breakdown:
            vals = [v for v in breakdown.values() if isinstance(v, float)]
            if vals:
                consistency = 1.0 - float(np.clip(np.std(vals), 0, 1))
        agree = match.get("methods_agreeing", 1)
        return float(np.clip(0.6 * sim + 0.25 * consistency
                             + 0.15 * min(agree / 3.0, 1.0), 0, 1))

    def _extract_clips(self, video_path: str,
                       matches: List[Dict]) -> List[Dict]:
        clips = []
        for m in matches:
            try:
                clip = self.clip_writer.extract_clip_with_padding(
                    video_path, m["timestamp"])
                m["clip_filename"] = clip["clip_filename"]
                clips.append({**clip, "timestamp": m["timestamp"],
                              "similarity": m["similarity"]})
            except Exception as exc:  # noqa: BLE001
                logger.warning("clip extraction failed @%.2fs: %s",
                               m["timestamp"], exc)
        return clips

    # ------------------------------------------------------------------
    def process_batch(self, video_path: str,
                      images: Sequence[np.ndarray],
                      **kwargs) -> List[Dict]:
        """One query per image, without clips."""
        return [self.process_image_query(video_path, img,
                                         extract_clips=False, **kwargs)
                for img in images]

    def compare_modes(self, video_path: str, image: np.ndarray,
                      modes: Optional[Sequence[str]] = None,
                      video_id: Optional[str] = None) -> Dict[str, Dict]:
        """Each mode's count, time and best similarity on one image."""
        modes = list(modes or settings.MATCHING_MODES)
        out = {}
        for mode in modes:
            res = self.process_image_query(
                video_path, image, matching_mode=mode,
                extract_clips=False, video_id=video_id)
            out[mode] = {"total_found": res["total_found"],
                         "processing_time":
                             res["performance"]["processing_time"],
                         "best_similarity":
                             max((m["similarity"] for m in res["results"]),
                                 default=0.0)}
        return out
