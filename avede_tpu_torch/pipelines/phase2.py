"""Phase 2 — caption-based re-ranking of phase-1 candidates
(counterpart of ``avede_tpu/pipelines/phase2.py``).

Phase 1 with 2× top_k → caption each candidate's middle frame with BLIP
→ combined score ``0.7·clip + 0.3·caption_similarity`` → sort, truncate.
Only the candidate frames are read (scan retention first, container
seeks for the rest), captions decode as one batch, and captions are
cached per frame, so a warm rerank reads no frame and runs no BLIP.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.trace import trace
from .phase1 import Phase1Scan, _default_video_id

logger = get_logger(__name__)

CLIP_WEIGHT = 0.7
CAPTION_WEIGHT = 0.3


class Phase2Rerank:
    phase_name = "phase2_reranked"

    def __init__(self, phase1: Phase1Scan, captioner=None) -> None:
        """``captioner`` defaults to ``services.captioner.make_reranker``
        on phase 1's engine, built at first use."""
        self.phase1 = phase1
        self._captioner = captioner
        self._repr_cache = None
        self._cache_lock = threading.Lock()

    @property
    def captioner(self):
        if self._captioner is None:
            from ..services.captioner import make_reranker

            self._captioner = make_reranker(self.phase1.engine)
        return self._captioner

    def _reprs(self, video_path: str, video_id: Optional[str],
               timestamps: List[float]) -> List[np.ndarray]:
        """Query-independent rerank representations (captions) of the
        candidate frames — cached per (video, frame, model) like
        embeddings, so a warm rerank touches neither the video nor BLIP."""
        cap = self.captioner
        if video_id is None:
            frames, _ = self._candidate_frames(
                video_path, _default_video_id(video_path), timestamps)
            return cap.frame_repr(frames)
        if self._repr_cache is None:
            with self._cache_lock:   # concurrent API requests share us
                if self._repr_cache is None:
                    from ..io.embedding_cache import FrameReprCache

                    # mirror phase 1's cache gating: caching disabled →
                    # memory-only tier, nothing persisted to disk
                    emb_cache = self.phase1.cache
                    self._repr_cache = FrameReprCache(
                        cap.repr_kind,
                        cache_dir=str(emb_cache.dir) if emb_cache
                        else None,
                        persist=emb_cache is not None)
        tag = cap.repr_tag
        hit = self._repr_cache.get_many(video_id, tag, timestamps)
        keyf = self._repr_cache.key
        missing = [t for t in timestamps if keyf(t) not in hit]
        if missing:
            frames, ok = self._candidate_frames(video_path, video_id,
                                                missing)
            fresh = dict(zip((keyf(t) for t in missing),
                             cap.frame_repr(frames)))
            # persist only frames that decoded: a transient read failure
            # must not pin a black-frame caption forever
            self._repr_cache.put_many(video_id, tag, {
                keyf(t): fresh[keyf(t)]
                for t, good in zip(missing, ok) if good})
            hit.update(fresh)
        return [hit[keyf(t)] for t in timestamps]

    def _candidate_frames(self, video_path: str, video_id: str,
                          timestamps: List[float]):
        """Candidate frames: the scan's retained frames when the cold
        scan just ran (``Phase1Scan.retention`` — no second decode),
        container seeks (``reader.read_frames_at``) only for frames
        retention doesn't hold. → (uint8 [N, H, W, 3] RGB, ok [N])."""
        from ..io.frame_retention import ts_key

        retained = self.phase1.retention.lookup(video_id, timestamps)
        if not retained:
            return self.phase1.reader.read_frames_at(
                video_path, timestamps, return_ok=True)
        to_read = [t for t in timestamps if ts_key(t) not in retained]
        read_map = {}
        if to_read:
            read, read_ok = self.phase1.reader.read_frames_at(
                video_path, to_read, return_ok=True)
            read_map = {ts_key(t): (f, o) for t, f, o in
                        zip(to_read, read, read_ok)}
        sample = next(iter(retained.values()))
        frames = np.zeros((len(timestamps),) + sample.shape, np.uint8)
        ok = np.zeros((len(timestamps),), bool)
        for n, t in enumerate(timestamps):
            k = ts_key(t)
            if k in retained:
                frames[n], ok[n] = retained[k], True
            else:
                frames[n], ok[n] = read_map[k]
        return frames, ok

    def process_video(self, video_path: str, query: str,
                      top_k: Optional[int] = None,
                      threshold: Optional[float] = None,
                      video_id: Optional[str] = None) -> List[Dict]:
        top_k = top_k or settings.TOP_K_RESULTS
        candidates = self.phase1.process_video(
            video_path, query, top_k=top_k * 2, threshold=threshold,
            video_id=video_id)
        if not candidates:
            return []

        with trace("phase2.rerank"):
            reprs = self._reprs(video_path, video_id,
                                [c["timestamp"] for c in candidates])
            cap_sim, aux = self.captioner.scores_from_repr(reprs, query)

        for c, extra, s in zip(candidates, aux, cap_sim):
            c.update(extra)
            c["caption_similarity"] = float(s)
            c["clip_score"] = c["confidence"]
            c["confidence"] = float(CLIP_WEIGHT * c["clip_score"]
                                    + CAPTION_WEIGHT * s)
            c["phase"] = self.phase_name
        candidates.sort(key=lambda c: c["confidence"], reverse=True)
        out = candidates[:top_k]
        logger.info("Phase 2: reranked %d candidates → top %d",
                    len(candidates), len(out))
        return out
