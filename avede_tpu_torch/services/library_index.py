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

On a mesh (``parallel/mesh.py``) the rows are split into ``n_data``
contiguous shards, one on each data device (table, scales and valid
mask), capacity rounded up to a multiple of ``n_data`` as in the JAX
package. A write whose span crosses a shard boundary is cut there, each
piece written on its shard (the int8 tier's pieces through
``quantize_rows_into``); growth uploads and quantizes each shard's part.
A search runs the tier's fused kernel on every shard, moves the shards'
``(score, global row)`` pairs to the first data device and merges them
exactly: by score, equal scores lower row first, the one-device order.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import kernels, quant
from ..parallel.mesh import MeshContext, build_mesh
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.trace import span

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


@dataclasses.dataclass
class _Shard:
    """One data device's contiguous rows of the table."""

    device: torch.device
    start: int                           # its first global row
    table: torch.Tensor                  # [rows, D] tier dtype
    scales: Optional[torch.Tensor]       # [rows] f32, int8 only
    valid: torch.Tensor                  # [rows] bool


class DeviceLibraryIndex:
    """Incrementally-built, device-resident ``[capacity, D]`` embedding
    table with masked rows and O(1)-amortized adds.

    Rows for one video form a contiguous bucket-padded span; padding
    rows (and removed videos) are masked invalid and score ``-inf``.
    A host shadow backs capacity growth: float16 for the bf16 device
    tier (half the memory, strictly more precise than the bf16 device
    copy), float32 for the float32 and int8 tiers so growth never
    compounds a second rounding on top of the tier's own.

    ``mesh`` (a local ``MeshContext``) shards the rows over its data
    devices; ``device`` is a one-shard index there (``cuda`` unless
    ``"cpu"`` is passed, where the kernels' plain versions run); they
    exclude each other."""

    def __init__(self, dim: int, dtype: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 mesh: Optional[MeshContext] = None) -> None:
        self.dim = dim
        self.dtype = dtype or settings.LIBRARY_INDEX_DTYPE
        if self.dtype not in _TABLE_DTYPES:
            raise ValueError(f"unknown library index dtype {self.dtype!r} "
                             f"(expected one of {sorted(_TABLE_DTYPES)})")
        if mesh is not None and device is not None:
            raise ValueError("pass mesh or device, not both")
        if mesh is None:
            mesh = build_mesh(["cuda" if device is None else device],
                              shape=(1, 1))
        if mesh.is_distributed:
            raise ValueError("the index takes a local mesh (build_mesh "
                             "with devices), not a process group's")
        self.mesh = mesh
        self.device = mesh.data_devices[0]
        self._int8 = self.dtype == "int8"
        self._shadow_dtype = (np.float16 if self.dtype == "bfloat16"
                              else np.float32)
        self._lock = threading.Lock()
        self._cap = 0
        self._shards: List[_Shard] = []
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

    @property
    def _table(self) -> Optional[torch.Tensor]:
        """The whole ``[capacity, D]`` table (the shards joined on the
        first data device; one shard's own tensor)."""
        return self._joined("table")

    @property
    def _scales(self) -> Optional[torch.Tensor]:
        return self._joined("scales")

    @property
    def _valid(self) -> Optional[torch.Tensor]:
        return self._joined("valid")

    def _joined(self, name: str) -> Optional[torch.Tensor]:
        parts = [getattr(sh, name) for sh in self._shards]
        if not parts or parts[0] is None:
            return None
        if len(parts) == 1:
            return parts[0]
        return torch.cat([t.to(self.device) for t in parts])

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
    def _shard_topk(self, sh: _Shard, q: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._int8:
            return kernels.cosine_topk_int8(sh.table, sh.scales, q,
                                            sh.valid, k)
        if self.dtype == "bfloat16":
            return kernels.cosine_topk_bf16(sh.table, q, sh.valid, k)
        return kernels.cosine_topk_f32(sh.table, q, sh.valid, k)

    def _topk_locked(self, q: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The top ``k`` (scores, global rows): each shard's own top
        ``min(k, its rows)``, merged on the first data device by score,
        equal scores lower row first (each shard's kernel orders its ties
        so, and a stable sort keeps the row order it is given)."""
        if len(self._shards) == 1:
            return self._shard_topk(self._shards[0], q, k)
        vals, rows = [], []
        for sh in self._shards:
            v, i = self._shard_topk(sh, q.to(sh.device, non_blocking=True),
                                    min(k, sh.table.shape[0]))
            vals.append(v.to(self.device, non_blocking=True))
            rows.append(i.to(self.device, non_blocking=True) + sh.start)
        # the shards are in row order and each lists its ties by row, so
        # a stable sort by descending score alone gives the global order
        vals, rows = torch.cat(vals), torch.cat(rows)
        vals, order = torch.sort(vals, descending=True, stable=True)
        return vals[:k], rows[order[:k]]

    def search(self, query_embedding: np.ndarray, k: int
               ) -> List[Dict]:
        """Top-``k`` rows across the whole library for a unit-norm
        query. Returns dicts with video_id/timestamp/confidence/
        frame_index, best first."""
        with span("index.search"):
            q = torch.from_numpy(np.array(query_embedding, np.float32)
                                 ).to(self.device)
            with self._lock:
                if not self._shards or not self._spans:
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
        # the rows split evenly over the data devices: round up to a
        # multiple (doubling never reaches one for, e.g., 3 shards)
        new_cap = self.mesh.pad_to_data(new_cap)
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
        # drop the old shards before allocating the new ones; a search
        # already enqueued on them still runs first (stream order)
        self._shards = []
        per = new_cap // self.mesh.n_data
        for i, dev in enumerate(self.mesh.data_devices):
            self._shards.append(self._upload_shard(
                dev, i * per, per, shadow, shadow_valid, pos))
        row_bytes = self._shards[0].table.element_size()
        logger.info("library index capacity -> %d rows (%s, %.0f MB on "
                    "%s)", new_cap, self.dtype,
                    new_cap * self.dim * row_bytes / 1e6,
                    ", ".join(str(d) for d in
                              dict.fromkeys(self.mesh.data_devices)))
        self._cap = new_cap

    def _upload_shard(self, dev: torch.device, start: int, rows: int,
                      shadow: np.ndarray, shadow_valid: np.ndarray,
                      occupied: int) -> _Shard:
        """Shard ``[start, start + rows)`` on ``dev`` from the host shadow:
        only its occupied rows (below ``occupied``) are uploaded (the
        tail is zero and masked), in chunks, so the f32 staging copy
        stays small; the int8 tier quantizes each chunk on the device."""
        table = torch.zeros((rows, self.dim),
                            dtype=_TABLE_DTYPES[self.dtype], device=dev)
        scales = (torch.full((rows,), 1e-12, dtype=torch.float32,
                             device=dev) if self._int8 else None)
        for lo in range(start, min(start + rows, occupied), _UPLOAD_ROWS):
            hi = min(lo + _UPLOAD_ROWS, start + rows, occupied)
            x = torch.from_numpy(shadow[lo:hi]).to(dev)
            a, b = lo - start, hi - start
            if self._int8:
                quant.quantize_rows(x, out=(table[a:b], scales[a:b]))
            else:
                table[a:b] = x
        valid = torch.from_numpy(shadow_valid[start:start + rows]).to(dev)
        return _Shard(dev, start, table, scales, valid)

    def _pieces(self, offset: int, end: int
                ) -> Iterator[Tuple[_Shard, int, int]]:
        """``(shard, lo, hi)`` for each shard that global rows ``[offset,
        end)`` touch, ``lo``/``hi`` global rows."""
        for sh in self._shards:
            lo = max(offset, sh.start)
            hi = min(end, sh.start + sh.table.shape[0])
            if lo < hi:
                yield sh, lo, hi

    def _device_write_locked(self, block: np.ndarray, n_valid: int,
                             offset: int) -> None:
        """Write ``block`` at row ``offset``, its first ``n_valid`` rows
        valid and the rest masked. In place into row slices, cut where
        the span crosses a shard boundary: the JAX package donates its
        buffers to one update program; the int8 tier is one upload and
        one launch a piece."""
        for sh, lo, hi in self._pieces(offset, offset + len(block)):
            a, b = lo - sh.start, hi - sh.start
            rows = torch.from_numpy(block[lo - offset: hi - offset]
                                    ).to(sh.device)
            # the valid rows are the block's first n_valid
            n = min(max(n_valid - (lo - offset), 0), hi - lo)
            if self._int8:
                quant.quantize_rows_into(rows, sh.table[a:b],
                                         sh.scales[a:b], sh.valid[a:b], n)
                continue
            sh.table[a:b] = rows
            sh.valid[a:b] = torch.from_numpy(
                np.arange(hi - lo) < n).to(sh.device)
