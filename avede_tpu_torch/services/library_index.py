"""Device-resident library index for whole-library search (counterpart
of ``avede_tpu/services/library_index.py``).

``LibrarySearch`` answers "find this query in EVERY uploaded video". The
library lives on the device as one bucketed ``[capacity, D]`` table in
the tier's dtype — ``bfloat16`` by default, ``float32``, or per-row
``int8`` with f32 scales (``settings.LIBRARY_INDEX_DTYPE``) — with a
bool ``valid`` mask over its rows. A query is one call of the tier's
fused score + top-k kernel (``ops/kernels.py``: ``cosine_topk_f32``,
``cosine_topk_bf16`` or ``cosine_topk_int8``; padded and removed rows
score -inf); only the top ``k`` scores and row indices leave the
device. Adds write bucket-padded spans into the
table in place; the int8 tier quantizes each block into the table and
writes its valid mask in one launch (``quant.quantize_rows_into``), and
quantizes growth's uploads with ``quant.quantize_rows``. Capacity grows
by doubling, which also compacts the holes that removals leave.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import kernels, quant
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.platform import resolve_device

logger = get_logger(__name__)

_ROW_BUCKET = 256          # adds are padded to this many rows
_MIN_CAPACITY = 1024
_UPLOAD_ROWS = 1 << 16     # growth uploads the shadow in chunks of rows

_TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8}

_Span = Tuple[str, int, int, np.ndarray, np.ndarray]


def _padded(n: int) -> int:
    """Rows occupied by an ``n``-row span after bucket padding."""
    return -(-n // _ROW_BUCKET) * _ROW_BUCKET


class DeviceLibraryIndex:
    """Incrementally-built, device-resident ``[capacity, D]`` embedding
    table with masked rows and O(1)-amortized adds.

    Rows for one video form a contiguous bucket-padded span; padding
    rows (and removed videos) are masked invalid and score ``-inf``.
    A host shadow backs capacity growth: float16 for the bf16 device
    tier (half the memory, strictly more precise than the bf16 device
    copy), float32 for the float32 and int8 tiers so growth never
    compounds a second rounding on top of the tier's own.

    ``device`` is ``cuda`` unless ``"cpu"`` is passed (then the kernels'
    plain versions run). Sharding the table over several cards is not
    ported yet."""

    def __init__(self, dim: int, dtype: Optional[str] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        self.dim = dim
        self.dtype = dtype or settings.LIBRARY_INDEX_DTYPE
        if self.dtype not in _TABLE_DTYPES:
            raise ValueError(f"unknown library index dtype {self.dtype!r} "
                             f"(expected one of {sorted(_TABLE_DTYPES)})")
        self.device = resolve_device(device)
        self._int8 = self.dtype == "int8"
        self._shadow_dtype = (np.float16 if self.dtype == "bfloat16"
                              else np.float32)
        self._lock = threading.Lock()
        self._cap = 0
        self._table: Optional[torch.Tensor] = None    # [cap, D] tier dtype
        self._scales: Optional[torch.Tensor] = None   # [cap] f32, int8 only
        self._valid: Optional[torch.Tensor] = None    # [cap] bool
        self._shadow: Optional[np.ndarray] = None     # host [cap, D]
        self._shadow_valid: Optional[np.ndarray] = None
        # span bookkeeping (ordered by start row)
        self._starts: List[int] = []
        # (video_id, start_row, n_rows, timestamps, frame_indices)
        self._spans: List[_Span] = []
        self._by_vid: Dict[str, int] = {}
        self._rows_end = 0          # first free row

    # ------------------------------------------------------------------
    @property
    def n_videos(self) -> int:
        return len(self._by_vid)

    @property
    def n_rows(self) -> int:
        """Valid (unmasked) rows currently searchable."""
        return int(sum(s[2] for s in self._spans))

    @property
    def capacity(self) -> int:
        return self._cap

    def has(self, video_id: str) -> bool:
        return video_id in self._by_vid

    def video_ids(self) -> List[str]:
        with self._lock:
            return list(self._by_vid)

    # ------------------------------------------------------------------
    def add(self, video_id: str, embeddings: np.ndarray,
            timestamps) -> None:
        """Insert (or replace) one video's unit-norm [N, D] table."""
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}], got {emb.shape}")
        ts = np.asarray(timestamps, np.float32)
        if len(ts) != len(emb):
            # after run-collapse a short ts array would shift or zero
            # the hits' timestamps: refuse it up front
            raise ValueError(
                f"timestamps length {len(ts)} != embeddings length "
                f"{len(emb)} for video {video_id!r}")
        frames = np.arange(len(emb), dtype=np.int32)
        if settings.LIBRARY_INDEX_DEDUP and len(emb) > 1:
            # lossless run collapse: the scan's dedup gate scatters the
            # SAME embedding to every frame of a static run; keep the run
            # head. ``frames`` keeps the original sampled-frame indices,
            # so hits report the frame_index the host path would.
            keep = np.ones(len(emb), bool)
            keep[1:] = ~np.all(emb[1:] == emb[:-1], axis=1)
            if not keep.all():
                emb = emb[keep]
                frames = frames[keep]
                ts = ts[keep]
        with self._lock:
            n = len(emb)
            padded = _padded(n)
            if video_id in self._by_vid:
                # removal leaves a hole (rows_end does not drop); when this
                # add grows the table anyway, compaction discards the hole,
                # so its device zero-write is skipped
                will_grow = n > 0 and self._rows_end + padded > self._cap
                self._remove_locked(video_id, device_write=not will_grow)
            if n == 0:
                return
            if self._rows_end + padded > self._cap:
                self._grow_locked(padded)
            start = self._rows_end
            block = np.zeros((padded, self.dim), np.float32)
            block[:n] = emb
            self._device_write_locked(block, n, start)
            self._shadow[start:start + padded] = \
                block.astype(self._shadow_dtype)
            self._shadow_valid[start:start + padded] = \
                np.arange(padded) < n
            idx = bisect.bisect_left(self._starts, start)
            self._starts.insert(idx, start)
            self._spans.insert(idx, (video_id, start, n, ts, frames))
            self._by_vid[video_id] = start
            self._rows_end = start + padded

    def remove(self, video_id: str) -> None:
        with self._lock:
            if video_id in self._by_vid:
                self._remove_locked(video_id)

    def _remove_locked(self, video_id: str,
                       device_write: bool = True) -> None:
        start = self._by_vid.pop(video_id)
        idx = self._starts.index(start)
        n = self._spans[idx][2]
        padded = _padded(n)
        del self._starts[idx]
        del self._spans[idx]
        if device_write:
            self._device_write_locked(
                np.zeros((padded, self.dim), np.float32), 0, start)
        self._shadow[start:start + padded] = 0
        self._shadow_valid[start:start + padded] = False
        # holes persist until the next capacity growth, which compacts

    # ------------------------------------------------------------------
    def _topk_locked(self, q: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._int8:
            return kernels.cosine_topk_int8(self._table, self._scales, q,
                                            self._valid, k)
        if self.dtype == "bfloat16":
            return kernels.cosine_topk_bf16(self._table, q, self._valid, k)
        return kernels.cosine_topk_f32(self._table, q, self._valid, k)

    def search(self, query_embedding: np.ndarray, k: int
               ) -> List[Dict]:
        """Top-``k`` rows across the whole library for a unit-norm
        query. Returns dicts with video_id/timestamp/confidence/
        frame_index, best first."""
        q = torch.from_numpy(np.array(query_embedding, np.float32)
                             ).to(self.device)
        with self._lock:
            if self._table is None or not self._spans:
                return []
            # k rounds up to a power of two, as in the JAX package (whose
            # per-k programs this bounded; here it keeps k's a handful)
            k_prog = min(1 << (max(k, 1) - 1).bit_length(), self._cap)
            # ENQUEUE under the lock: every launch goes to the one current
            # stream in order, so this search reads the table as it is
            # now, whatever later adds or growth write or free. The copy
            # to the host, which waits for the device, happens outside.
            scores, idx = self._topk_locked(q, k_prog)
            starts = list(self._starts)
            spans = list(self._spans)
        scores = scores[:k].cpu().numpy()
        idx = idx[:k].cpu().numpy()
        out: List[Dict] = []
        for s, i in zip(scores, idx):
            if not np.isfinite(s):
                break
            vid, ts, frame = self._locate(int(i), starts, spans)
            out.append({"video_id": vid, "timestamp": float(ts),
                        "confidence": float(s), "frame_index": frame})
        return out

    @staticmethod
    def _locate(row: int, starts: List[int], spans: List[_Span]
                ) -> Tuple[str, float, int]:
        j = bisect.bisect_right(starts, row) - 1
        vid, start, n, ts, frames = spans[j]
        # ``add`` enforces len(ts) == len(frames) == n, and only the
        # first n rows of a span are valid (padding is masked), so a
        # returned row always indexes in range
        off = row - start
        return vid, float(ts[off]), int(frames[off])

    # ------------------------------------------------------------------
    def _grow_locked(self, extra_rows: int) -> None:
        """Grow capacity (doubling) and compact removal holes: spans are
        re-laid contiguously in the new shadow, then uploaded once."""
        compacted = sum(_padded(s[2]) for s in self._spans)
        new_cap = max(_MIN_CAPACITY, self._cap or _MIN_CAPACITY)
        while new_cap < compacted + extra_rows:
            new_cap *= 2
        shadow = np.zeros((new_cap, self.dim), self._shadow_dtype)
        shadow_valid = np.zeros((new_cap,), bool)
        new_starts: List[int] = []
        new_spans: List[_Span] = []
        pos = 0
        for vid, start, n, ts, frames in self._spans:
            padded = _padded(n)
            shadow[pos:pos + padded] = self._shadow[start:start + padded]
            shadow_valid[pos:pos + padded] = \
                self._shadow_valid[start:start + padded]
            new_starts.append(pos)
            new_spans.append((vid, pos, n, ts, frames))
            self._by_vid[vid] = pos
            pos += padded
        self._shadow, self._shadow_valid = shadow, shadow_valid
        self._starts, self._spans = new_starts, new_spans
        self._rows_end = pos
        # drop the old table before allocating the new one; a search
        # already enqueued on it still runs first (stream order)
        self._table = self._scales = self._valid = None
        dev = self.device
        table = torch.zeros((new_cap, self.dim),
                            dtype=_TABLE_DTYPES[self.dtype], device=dev)
        scales = (torch.full((new_cap,), 1e-12, dtype=torch.float32,
                             device=dev) if self._int8 else None)
        # only the occupied prefix is uploaded (the tail is zero and
        # masked), in chunks, so the f32 staging copy stays small; the
        # int8 tier quantizes each chunk on the device
        for lo in range(0, pos, _UPLOAD_ROWS):
            hi = min(lo + _UPLOAD_ROWS, pos)
            rows = torch.from_numpy(shadow[lo:hi]).to(dev)
            if self._int8:
                quant.quantize_rows(rows, out=(table[lo:hi], scales[lo:hi]))
            else:
                table[lo:hi] = rows
        self._table, self._scales = table, scales
        self._valid = torch.from_numpy(shadow_valid).to(dev)
        row_bytes = table.element_size()
        logger.info("library index capacity -> %d rows (%s, %.0f MB on "
                    "%s)", new_cap, self.dtype,
                    new_cap * self.dim * row_bytes / 1e6, dev)
        self._cap = new_cap

    def _device_write_locked(self, block: np.ndarray, n_valid: int,
                             offset: int) -> None:
        """Write ``block`` at row ``offset``, its first ``n_valid`` rows
        valid and the rest masked. In place into row slices: the JAX
        package donates its buffers to one update program; the int8 tier
        is one upload and one launch."""
        end = offset + len(block)
        rows = torch.from_numpy(block).to(self.device)
        if self._int8:
            quant.quantize_rows_into(rows, self._table[offset:end],
                                     self._scales[offset:end],
                                     self._valid[offset:end], n_valid)
            return
        self._table[offset:end] = rows
        self._valid[offset:end] = torch.from_numpy(
            np.arange(len(block)) < n_valid).to(self.device)
