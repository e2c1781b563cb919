"""Central orchestration facade (counterpart of
``avede_tpu/services/video_processor.py``).

The single object the API talks to: query preprocessing, video
validation, mode dispatch (``mvp`` → phase 1, ``reranked`` → phase 2's
BLIP caption rerank, ``advanced`` → phase 3's temporal grounding),
threshold filtering, per-result clip extraction and typed error
envelopes; and open-vocabulary detection over a whole video
(``process_unlimited_detection``: OWL-ViT, the CLIP grid and YOLO
through ``OpenVocabMatcher``), tiled small-object detection
(``process_small_object_detection``), background-independent matching
(``process_background_independence``) and image query
(``process_image_matching``: phase 4's six matching modes) and person
search (``process_person_search``: a reference image's person found
across the video). The heavier
pipelines and detectors are built at first use over the one shared CLIP
engine, and the detection services share one ``UniversalDetector``.
"""

from __future__ import annotations

import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..io.clip_writer import ClipWriter
from ..io.video_reader import validate_video
from ..parallel.embed import ClipEngine
from ..pipelines.phase1 import Phase1Scan
from ..utils.config import settings
from ..utils.errors import AvedeError, error_envelope, error_log
from ..utils.logging import get_logger
from .query_rewrite import preprocess_query

logger = get_logger(__name__)

QUERY_MODES = ("mvp", "reranked", "advanced")


class VideoProcessor:
    def __init__(self, engine: Optional[ClipEngine] = None,
                 device: Optional[str] = None) -> None:
        """``engine`` defaults to a ``ClipEngine`` on ``device``
        (``cuda`` unless ``"cpu"`` is passed)."""
        self.engine = engine or ClipEngine(device=device)
        self.phase1 = Phase1Scan(self.engine)
        self.clip_writer = ClipWriter()
        self._phase2 = None
        self._phase3 = None
        self._universal_detector = None
        self._image_matching = None
        self._open_vocab = None
        self._small_object = None
        self._background = None
        self._person = None

    # -- lazy pipelines (BLIP and the grounding head load on first use) --
    @property
    def phase2(self):
        if self._phase2 is None:
            from ..pipelines.phase2 import Phase2Rerank

            self._phase2 = Phase2Rerank(self.phase1)
        return self._phase2

    @property
    def phase3(self):
        if self._phase3 is None:
            from ..pipelines.phase3 import Phase3Temporal

            self._phase3 = Phase3Temporal(self.phase2)
        return self._phase3

    @property
    def image_matching(self):
        if self._image_matching is None:
            from ..pipelines.phase4 import Phase4ImageMatching

            self._image_matching = Phase4ImageMatching(
                self.engine, cache=self.phase1.cache)
        return self._image_matching

    @property
    def universal_detector(self):
        """One detector hub (OWL-ViT, the CLIP grid, YOLO) for every
        detection service."""
        if self._universal_detector is None:
            from .universal_detector import UniversalDetector

            self._universal_detector = UniversalDetector(self.engine)
        return self._universal_detector

    @property
    def open_vocab(self):
        if self._open_vocab is None:
            from .open_vocab_matcher import OpenVocabMatcher

            self._open_vocab = OpenVocabMatcher(
                self.engine, detector=self.universal_detector)
        return self._open_vocab

    @property
    def small_object(self):
        if self._small_object is None:
            from .small_object import SmallObjectService

            self._small_object = SmallObjectService(
                self.engine, detector=self.universal_detector)
        return self._small_object

    @property
    def background(self):
        if self._background is None:
            from .background_independent import BackgroundIndependentService

            self._background = BackgroundIndependentService(
                self.engine, detector=self.universal_detector)
        return self._background

    @property
    def person(self):
        if self._person is None:
            from .person_detector import PersonSearchService

            self._person = PersonSearchService(self.engine)
        return self._person

    def resolve_video(self, video_id: str) -> str:
        """``data/videos/<id>.<ext>`` lookup over the supported
        extensions."""
        base = Path(settings.VIDEO_DIR)
        for ext in settings.SUPPORTED_FORMATS:
            p = base / f"{video_id}.{ext}"
            if p.exists():
                return str(p)
        raise AvedeError(f"video not found: {video_id}")

    def validate_video(self, video_path: str) -> Dict[str, Any]:
        meta = validate_video(video_path)
        return {"valid": True, "fps": meta.fps, "duration": meta.duration,
                "total_frames": meta.total_frames,
                "resolution": [meta.width, meta.height]}

    def process_query(self, video_path: str, query: str, mode: str = "mvp",
                      top_k: Optional[int] = None,
                      threshold: Optional[float] = None,
                      extract_clips: bool = True,
                      video_id: Optional[str] = None) -> Dict[str, Any]:
        task_id = uuid.uuid4().hex
        t0 = time.time()
        try:
            if mode not in QUERY_MODES:
                raise AvedeError(
                    f"unknown mode '{mode}' (expected one of {QUERY_MODES})")
            validate_video(video_path)
            clean = preprocess_query(query)
            if mode == "mvp":
                pipeline = self.phase1
            elif mode == "reranked":
                pipeline = self.phase2
            else:
                pipeline = self.phase3
            results = pipeline.process_video(
                video_path, clean, top_k=top_k, threshold=threshold,
                video_id=video_id)
            if extract_clips:
                results = self._attach_clips(video_path, results)
            return {
                "task_id": task_id,
                "status": "completed",
                "results": results,
                "total_found": len(results),
                "metadata": {
                    "mode": mode,
                    "query": query,
                    "preprocessed_query": clean,
                    "processing_time": time.time() - t0,
                },
            }
        except Exception as exc:  # noqa: BLE001 — typed error envelope
            error_log.record(exc, component="process_query")
            return error_envelope(task_id, exc)
        finally:
            # request-scope retention: the scan's frames serve only this
            # request's backfill
            self.phase1.retention.release()

    def _attach_clips(self, video_path: str,
                      results: List[Dict]) -> List[Dict]:
        for r in results:
            try:
                clip = self.clip_writer.extract_clip_with_padding(
                    video_path, r["timestamp"])
                r["clip_path"] = clip["clip_path"]
                r["clip_filename"] = clip["clip_filename"]
                r["clip_start"] = clip["start_time"]
                r["clip_end"] = clip["end_time"]
            except Exception as exc:  # noqa: BLE001 — results still serve
                error_log.record(exc, severity="warning",
                                 component="clip_extraction")
        return results

    # ------------------------------------------------------------------
    def process_unlimited_detection(self, video_path: str, object_queries,
                                    detection_mode: str = "hybrid",
                                    matching_precision: str = "balanced",
                                    top_k: int = 10,
                                    confidence_threshold: float = 0.3,
                                    video_id: Optional[str] = None
                                    ) -> Dict[str, Any]:
        """Open-vocabulary detection of ``object_queries`` (a string or a
        list of strings) over the video, in ``detection_mode``."""
        task_id = uuid.uuid4().hex
        try:
            validate_video(video_path)
            queries = ([object_queries] if isinstance(object_queries, str)
                       else list(object_queries))
            out = self.open_vocab.match_unlimited_objects(
                video_path, queries, detection_mode=detection_mode,
                matching_precision=matching_precision, top_k=top_k,
                confidence_threshold=confidence_threshold,
                video_id=video_id)
            return {"task_id": task_id, "status": "completed",
                    "queries": queries, "detection_mode": detection_mode,
                    "matching_precision": matching_precision, **out}
        except Exception as exc:  # noqa: BLE001 — typed error envelope
            error_log.record(exc, component="unlimited_detection")
            env = error_envelope(task_id, exc)
            env.update({"queries": object_queries
                        if isinstance(object_queries, list)
                        else [object_queries],
                        "detection_mode": detection_mode,
                        "matching_precision": matching_precision,
                        "metadata": {}})
            return env

    def process_image_matching(self, video_path: str, image,
                               matching_mode: str = "smart_match",
                               target_class: Optional[str] = None,
                               top_k: Optional[int] = None,
                               similarity_threshold: Optional[float] = None,
                               extract_clips: bool = True,
                               video_id: Optional[str] = None
                               ) -> Dict[str, Any]:
        """Matches of the reference ``image`` (uint8 RGB) in the video,
        in ``matching_mode``, with clips cut around them."""
        task_id = uuid.uuid4().hex
        try:
            validate_video(video_path)
            return {"task_id": task_id, "status": "completed",
                    **self.image_matching.process_image_query(
                        video_path, image, matching_mode=matching_mode,
                        target_class=target_class, top_k=top_k,
                        similarity_threshold=similarity_threshold,
                        extract_clips=extract_clips, video_id=video_id)}
        except Exception as exc:  # noqa: BLE001 — typed error envelope
            error_log.record(exc, component="image_matching")
            env = error_envelope(task_id, exc)
            env.update({"clips": [], "metadata": {}, "performance": {}})
            return env

    def process_small_object_detection(self, video_path: str, object_queries,
                                       video_id: Optional[str] = None,
                                       **kwargs) -> Dict[str, Any]:
        """Tiled small-object detection of ``object_queries`` (a string
        or a list of strings); ``kwargs`` go to
        ``SmallObjectService.detect_in_video``."""
        task_id = uuid.uuid4().hex
        try:
            validate_video(video_path)
            queries = ([object_queries] if isinstance(object_queries, str)
                       else list(object_queries))
            out = self.small_object.detect_in_video(
                video_path, queries, video_id=video_id, **kwargs)
            return {"task_id": task_id, "status": "completed",
                    "queries": queries, **out}
        except Exception as exc:  # noqa: BLE001 — typed error envelope
            error_log.record(exc, component="small_object_detection")
            env = error_envelope(task_id, exc)
            env.update({"queries": object_queries
                        if isinstance(object_queries, list)
                        else [object_queries],
                        "small_objects_found": 0, "enhancement_stats": {},
                        "metadata": {}})
            return env

    def process_background_independence(self, video_path: str, object_queries,
                                        video_id: Optional[str] = None,
                                        **kwargs) -> Dict[str, Any]:
        """Background-independent matching of ``object_queries``;
        ``kwargs`` go to ``BackgroundIndependentService.match_in_video``."""
        task_id = uuid.uuid4().hex
        try:
            validate_video(video_path)
            queries = ([object_queries] if isinstance(object_queries, str)
                       else list(object_queries))
            out = self.background.match_in_video(
                video_path, queries, video_id=video_id, **kwargs)
            return {"task_id": task_id, "status": "completed",
                    "queries": queries, **out}
        except Exception as exc:  # noqa: BLE001 — typed error envelope
            error_log.record(exc, component="background_independence")
            env = error_envelope(task_id, exc)
            env.update({"queries": object_queries
                        if isinstance(object_queries, list)
                        else [object_queries],
                        "background_independence_stats": {}, "metadata": {}})
            return env

    def process_person_search(self, video_path: str, reference_image,
                              **kwargs) -> Dict[str, Any]:
        """Matches of the person in ``reference_image`` (uint8 RGB)
        across the video; ``kwargs`` go to
        ``PersonSearchService.process_video_for_person``."""
        task_id = uuid.uuid4().hex
        try:
            validate_video(video_path)
            out = self.person.process_video_for_person(
                video_path, reference_image, **kwargs)
            return {"task_id": task_id, "status": "completed", **out}
        except Exception as exc:  # noqa: BLE001 — typed error envelope
            error_log.record(exc, component="person_search")
            return error_envelope(task_id, exc)
