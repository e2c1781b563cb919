"""Host-side retention of scan-decoded frames for same-request reuse
(copy of ``avede_tpu/io/frame_retention.py``).

The sparse cold scan embeds only window-middle frames; the lazy
backfill of the remaining rows, and later the phase-2 reranker, need
frames the scan already decoded. This store keeps the scan's decoded
chunks alive (by reference — the reader allocates a fresh buffer per
chunk, so retention costs zero copies) keyed by timestamp, bounded by
``settings.FRAME_RETAIN_MB``. Only the most recently scanned video is
retained.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.config import settings
from ..utils.logging import get_logger

logger = get_logger(__name__)


def ts_key(t: float) -> int:
    """Millisecond-quantized timestamp key (matches the repr-cache's
    quantization so one scan timestamp maps to one retained frame)."""
    return int(round(float(t) * 1000))


class FrameRetention:
    """Budgeted single-video frame store.

    ``begin`` starts retention for a video (evicting the previous one),
    ``add`` records a decoded chunk, ``lookup`` returns whatever subset
    of the requested timestamps is retained. Exceeding the byte budget
    drops the whole video's retention (a partial store would still
    satisfy some lookups, but the budget exists to bound worst-case
    host memory, and half-retained videos complicate accounting for a
    path that always has the file-read fallback).
    """

    def __init__(self, budget_mb: Optional[int] = None) -> None:
        self._budget_mb = budget_mb
        self._lock = threading.Lock()
        self._vid: Optional[str] = None
        self._color = "rgb"
        self._chunks: List[np.ndarray] = []
        # key → (chunk, row, timestamp); ts disambiguates ms-key
        # collisions between different frames (poisoned on conflict)
        self._index: Dict[int, Tuple[int, int, float]] = {}
        self._poisoned: set = set()
        self._bytes = 0
        self._over = False

    @property
    def budget_bytes(self) -> int:
        mb = (settings.FRAME_RETAIN_MB if self._budget_mb is None
              else self._budget_mb)
        return max(int(mb), 0) * (1 << 20)

    def begin(self, video_id: str, color: str = "rgb") -> None:
        """``color="bgr"`` marks the retained chunks as decoder-native
        BGR (the fused-pack scan path skips the per-frame BGR→RGB
        pass); ``lookup`` converts the K requested candidates back to
        RGB on access, so consumers always see RGB at identical pixel
        values."""
        with self._lock:
            self._vid = video_id
            self._color = color
            self._chunks = []
            self._index = {}
            self._poisoned = set()
            self._bytes = 0
            self._over = self.budget_bytes == 0

    def add(self, video_id: str, frames: np.ndarray,
            timestamps: Sequence[float]) -> None:
        """Retain one decoded chunk (no copy — caller must not mutate)."""
        if len(frames) != len(timestamps):
            raise ValueError(
                f"frames/timestamps length mismatch: {len(frames)} vs "
                f"{len(timestamps)}")
        with self._lock:
            if self._vid != video_id or self._over:
                return
            if self._bytes + frames.nbytes > self.budget_bytes:
                self._over = True
                self._chunks = []
                self._index = {}
                logger.info(
                    "Frame retention over budget for %s (%d MB cap) — "
                    "disabled for this video; rerank falls back to "
                    "file reads", video_id, self.budget_bytes >> 20)
                return
            ci = len(self._chunks)
            self._chunks.append(frames)
            self._bytes += frames.nbytes
            poisoned = self._poisoned
            for row, t in enumerate(timestamps):
                k = ts_key(t)
                if k in poisoned:
                    continue
                # two DIFFERENT timestamps quantizing to one ms key are
                # different frames; last-write-wins here would silently
                # serve a neighbor frame as an exact lookup hit (and the
                # backfill path would store its embedding as exact), so
                # the ambiguous key is poisoned — lookups miss it and
                # consumers fall back to the per-index decode. Equal
                # timestamps (duplicated pts) are the same frame and may
                # overwrite freely.
                prev = self._index.get(k)
                if prev is not None and prev[2] != t:
                    del self._index[k]
                    poisoned.add(k)
                    continue
                self._index[k] = (ci, row, t)

    def lookup(self, video_id: str, timestamps: Sequence[float]
               ) -> Dict[int, np.ndarray]:
        """→ {ts_key: frame} (RGB) for every requested timestamp
        retained. BGR-retained stores convert only the K requested
        frames — a per-candidate channel-swap copy, not a per-scan
        pass."""
        with self._lock:
            if self._vid != video_id or self._over:
                return {}
            swap = getattr(self, "_color", "rgb") == "bgr"
            out = {}
            for t in timestamps:
                hit = self._index.get(ts_key(t))
                if hit is not None:
                    ci, row = hit[0], hit[1]
                    frame = self._chunks[ci][row]
                    if swap:
                        frame = np.ascontiguousarray(frame[..., ::-1])
                    out[ts_key(t)] = frame
            return out

    def release(self, video_id: Optional[str] = None) -> None:
        """Drop retained frames (end-of-request hook): retention exists
        to serve the scan→rerank pattern WITHIN one request; holding up
        to ``FRAME_RETAIN_MB`` of decoded frames until the next cold
        scan idled alongside the embedding cache on memory-constrained
        hosts. With ``video_id`` the release is
        conditional (no-op if another video started retaining since)."""
        with self._lock:
            if video_id is not None and self._vid != video_id:
                return
            self._vid = None
            self._chunks = []
            self._index = {}
            self._bytes = 0
            self._over = False

    @property
    def retained_bytes(self) -> int:
        """Bytes of frames held now (0 once the budget was exceeded)."""
        with self._lock:
            return self._bytes if not self._over else 0
