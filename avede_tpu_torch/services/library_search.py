"""Cross-video library search (counterpart of
``avede_tpu/services/library_search.py``).

Search EVERY uploaded video for a text query in one shot. The embedding
cache already holds one unit-norm table per video. Whole-library
searches go through the device-resident ``DeviceLibraryIndex`` (one
fused score + top-k kernel call on the device; videos without cached
embeddings are embedded on first search and cached); a search over a
``video_ids`` subset scores the concatenated host tables with numpy,
as the JAX package does.

Exposed at ``POST /api/search-library``.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..pipelines.phase1 import Phase1Scan
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.trace import span
from .library_index import DeviceLibraryIndex

logger = get_logger(__name__)


class LibrarySearch:
    def __init__(self, phase1: Phase1Scan) -> None:
        self.phase1 = phase1
        # built EAGERLY (it allocates nothing until the first add): lazy
        # init would race when a shared instance (ApiState) serves two
        # first searches on executor threads. The dtype is fixed here.
        engine = phase1.engine
        # the index's rows shard over the engine's data devices (as JAX's
        # ``mesh=getattr(engine, "mesh", None)``; an engine without a mesh
        # gives its device)
        mesh = getattr(engine, "mesh", None)
        self._index = DeviceLibraryIndex(
            engine.cfg.projection_dim, mesh=mesh,
            device=engine.device if mesh is None else None)
        # serializes index population: without it two concurrent first
        # searches both embed every uncached video (correct, since add
        # replaces atomically, but the heavy work runs twice)
        self._populate_lock = threading.Lock()

    def prewarm(self) -> int:
        """Sync the device index with VIDEO_DIR: evict deleted videos,
        embed-and-add any uncached ones. Every search does this
        implicitly; a server can also call it at startup
        (``settings.LIBRARY_PREWARM``) so the FIRST search doesn't pay
        the whole library's embed and index build. → videos indexed."""
        with span("library.prewarm"):
            index = self._index
            n_videos = 0
            listed = self.list_videos()
            with self._populate_lock:
                for vid in set(index.video_ids()) - set(listed):
                    index.remove(vid)   # deleted from VIDEO_DIR → evict
                for vid in listed:
                    try:
                        if not index.has(vid):
                            path = self._resolve(vid)
                            emb, ts = self.phase1.frame_embeddings(path, vid)
                            index.add(vid, emb, ts)
                        n_videos += 1
                    except Exception as exc:  # noqa: BLE001 — skip it
                        logger.warning("library: skipping %s (%s)", vid, exc)
        return n_videos

    def invalidate(self, video_id: str) -> None:
        """Drop a video from the device index."""
        self._index.remove(video_id)

    def list_videos(self) -> List[str]:
        base = Path(settings.VIDEO_DIR)
        if not base.exists():
            return []
        return sorted(p.stem for p in base.glob("*")
                      if p.suffix.lstrip(".").lower()
                      in settings.SUPPORTED_FORMATS)

    def search(self, query: str, top_k: int = 10,
               threshold: Optional[float] = None,
               per_video_k: int = 3,
               video_ids: Optional[List[str]] = None) -> Dict:
        with span("library.search"):
            t0 = time.time()
            threshold = (settings.CONFIDENCE_THRESHOLD if threshold is None
                         else threshold)
            if video_ids is None and settings.LIBRARY_INDEX_ENABLED:
                # whole-library search rides the device index; subset
                # searches keep the per-table path (a global top-k
                # filtered to a small subset could come back empty)
                return self._search_indexed(query, top_k, threshold,
                                            per_video_k, t0)
            return self._search_tables(query, top_k, threshold,
                                       per_video_k, video_ids, t0)

    def _search_tables(self, query: str, top_k: int, threshold: float,
                       per_video_k: int, video_ids: Optional[List[str]],
                       t0: float) -> Dict:
        """Search the listed (or given) videos' host tables with numpy."""
        ids = video_ids or self.list_videos()
        tables: List[np.ndarray] = []
        spans: List[tuple] = []   # (video_id, timestamps)
        for vid in ids:
            try:
                path = self._resolve(vid)
                emb, ts = self.phase1.frame_embeddings(path, vid)
            except Exception as exc:  # noqa: BLE001 — skip bad videos
                logger.warning("library: skipping %s (%s)", vid, exc)
                continue
            tables.append(emb)
            spans.append((vid, ts))
        if not tables:
            return {"results": [], "total_found": 0,
                    "metadata": {"videos_searched": 0,
                                 "processing_time": time.time() - t0}}

        all_emb = np.concatenate(tables, axis=0)
        q = self.phase1.engine.embed_texts(query)[0]
        scores = all_emb @ q

        results: List[Dict] = []
        offset = 0
        for (vid, ts), emb in zip(spans, tables):
            n = len(emb)
            s = scores[offset: offset + n]
            offset += n
            order = np.argsort(s)[::-1][:per_video_k]
            for i in order:
                if s[i] >= threshold:
                    results.append({
                        "video_id": vid,
                        "timestamp": float(ts[i]),
                        "confidence": float(s[i]),
                        "frame_index": int(i),
                    })
        results.sort(key=lambda r: r["confidence"], reverse=True)
        results = results[:top_k]
        return {
            "results": results,
            "total_found": len(results),
            "metadata": {
                "videos_searched": len(tables),
                "frames_scored": int(len(scores)),
                "processing_time": time.time() - t0,
            },
        }

    def _search_indexed(self, query: str, top_k: int, threshold: float,
                        per_video_k: int, t0: float) -> Dict:
        """Whole-library search through the ``DeviceLibraryIndex``.

        The device returns a global top-K' candidate set; the host
        applies threshold + per-video cap + global top_k, and K'
        quadruples (rarely) whenever capping starved the result below
        ``top_k`` while candidates remained."""
        index = self._index
        n_videos = self.prewarm()
        if index.n_rows == 0:
            return {"results": [], "total_found": 0,
                    "metadata": {"videos_searched": 0,
                                 "processing_time": time.time() - t0}}
        q = self.phase1.engine.embed_texts(query)[0]

        k_dev = max(64, 4 * top_k)
        while True:
            cands = index.search(q, k_dev)
            per_video: Dict[str, int] = {}
            results: List[Dict] = []
            for c in cands:
                if c["confidence"] < threshold:
                    break  # candidates arrive best-first
                if per_video.get(c["video_id"], 0) >= per_video_k:
                    continue
                per_video[c["video_id"]] = \
                    per_video.get(c["video_id"], 0) + 1
                results.append(c)
                if len(results) >= top_k:
                    break
            exhausted = (len(cands) < k_dev
                         or (cands and cands[-1]["confidence"] < threshold))
            if len(results) >= top_k or exhausted \
                    or k_dev >= index.capacity:
                break
            k_dev *= 4
        return {
            "results": results[:top_k],
            "total_found": len(results[:top_k]),
            "metadata": {
                "videos_searched": n_videos,
                "frames_scored": index.n_rows,
                "processing_time": time.time() - t0,
                "index": {"rows": index.n_rows,
                          "capacity": index.capacity,
                          "dtype": index.dtype,
                          "device_resident": True},
            },
        }

    def _resolve(self, video_id: str) -> str:
        base = Path(settings.VIDEO_DIR)
        for ext in settings.SUPPORTED_FORMATS:
            p = base / f"{video_id}.{ext}"
            if p.exists():
                return str(p)
        raise FileNotFoundError(video_id)
