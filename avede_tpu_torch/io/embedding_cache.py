"""Persistent frame-embedding cache — ``data/embeddings/<video_id>.npz``
(counterpart of ``avede_tpu/io/embedding_cache.py``, same on-disk
format, so both packages read each other's files; the model tag keeps
their tables apart).

``<video_id>.npz`` (numpy zip) containing:
- ``embeddings``  float32 [N, D] — unit-norm frame embeddings, OR
  (``settings.EMBEDDING_CACHE_INT8``, the default) ``embeddings_int8``
  int8 [N, D] + ``scales`` f32 [N] — symmetric per-row quantization
  (``quantize_rows_np``), 4× smaller storage at ≲1e-3 cosine error
- ``timestamps``  float64 [N]    — seconds per sampled frame
- ``valid``       bool [N]       — OPTIONAL row mask: present only for
  sparse entries (the sparse cold scan embeds window-middle rows only;
  unfilled rows are zero vectors until the lazy backfill completes
  them — ``complete_rows``)
- ``meta``        JSON bytes     — {version, model_tag, frame_hw,
                                    sample_rate, dtype, complete,
                                    dedup_gated, created}

A cache entry is valid only if model tag + sampling parameters match.
``FrameReprCache`` keeps phase 2's per-frame captions beside the table
(``<video_id>.<kind>.npz``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.quant import quantize_rows_np
from ..utils.config import settings
from ..utils.logging import get_logger

logger = get_logger(__name__)

FORMAT_VERSION = 1


def table_tag(model_tag: str) -> str:
    """Model tag for per-frame embedding TABLES.

    Dedup gating changes table values (dup frames carry their run
    representative's embedding), so the eps is part of the key. Every
    producer/consumer of ``<video_id>.npz`` tables (Phase1Scan,
    ImageMatcher, library search) must use THIS function — divergent
    tags on the same file would make the paths perpetually invalidate
    and overwrite each other's entries.

    Not every producer under a dedup tag actually gates: the sparse
    cold scan embeds its middle rows exactly, lazy backfill embeds
    exactly, and ImageMatcher embeds every frame exactly — only the
    dense scan with eps>0 writes gated (approximate) values. Exact
    tables are at least as accurate as gated ones, so an exact table
    superseding a gated one under the same tag is by design; which
    producer wrote an entry is recorded in ``meta["dedup_gated"]``."""
    eps = settings.SCAN_DEDUP_EPS
    return f"{model_tag}|dedup{eps:g}" if eps > 0 else model_tag


class EmbeddingCache:
    def __init__(self, cache_dir: Optional[str] = None) -> None:
        self.dir = Path(cache_dir or settings.EMBEDDING_DIR)
        self.dir.mkdir(parents=True, exist_ok=True)
        # in-memory tier: without it each warm query re-reads and
        # re-dequantizes the .npz from disk. Bounded by bytes, LRU.
        # Values are (emb, ts, valid) — ``valid`` is None for complete
        # tables, else a bool row mask (sparse cold-scan entries).
        self._mem: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._mem_bytes = 0
        self._mem_lock = threading.Lock()

    def _path(self, video_id: str) -> Path:
        return self.dir / f"{video_id}.npz"

    def _mem_put(self, key: tuple, emb: np.ndarray, ts: List[float],
                 valid: Optional[np.ndarray] = None) -> None:
        cap = settings.EMBEDDING_MEM_CACHE_MB * (1 << 20)
        if cap <= 0 or emb.nbytes > cap:
            return
        with self._mem_lock:
            if key in self._mem:
                self._mem_bytes -= self._mem[key][0].nbytes
                del self._mem[key]
            self._mem[key] = (emb, ts, valid)
            self._mem_bytes += emb.nbytes
            while self._mem_bytes > cap and self._mem:
                _, (old, _ts, _v) = self._mem.popitem(last=False)
                self._mem_bytes -= old.nbytes

    def _mem_drop(self, video_id: str) -> None:
        with self._mem_lock:
            for key in [k for k in self._mem if k[0] == video_id]:
                self._mem_bytes -= self._mem[key][0].nbytes
                del self._mem[key]

    def put(self, video_id: str, embeddings: np.ndarray,
            timestamps: List[float], model_tag: str,
            frame_hw: Tuple[int, int], sample_rate: int,
            valid: Optional[np.ndarray] = None,
            gated: bool = False) -> np.ndarray:
        """Store the table; returns the CANONICAL stored values (the
        int8 round trip when quantization is on), so callers that keep
        using the table in memory agree exactly with later cache
        reads — near-tie result ordering stays deterministic across
        cold and warm queries.

        ``valid`` (bool [N]) marks a SPARSE entry: only masked rows
        hold real embeddings (the sparse cold scan embeds window
        middles only — ``Phase1Scan``); an all-true or None mask stores
        a complete table. ``get`` serves complete entries only;
        ``get_entry`` also serves sparse ones.

        ``gated=True`` records (meta provenance only — no read path
        keys on it) that rows may carry dedup-run-representative
        values rather than exact embeddings: the dense scan with
        eps>0. Exact producers writing under the same dedup tag
        supersede gated tables by design — see ``table_tag``."""
        emb = np.ascontiguousarray(np.asarray(embeddings, dtype=np.float32))
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)
            if bool(valid.all()):
                valid = None
        int8 = settings.EMBEDDING_CACHE_INT8
        meta = {
            "version": FORMAT_VERSION,
            "model_tag": model_tag,
            "frame_hw": list(frame_hw),
            "sample_rate": int(sample_rate),
            "dtype": "int8" if int8 else "float32",
            "complete": valid is None,
            "dedup_gated": bool(gated),
            "created": time.time(),
        }
        path = self._path(video_id)
        arrays = {
            "timestamps": np.asarray(timestamps, dtype=np.float64),
            "meta": np.frombuffer(json.dumps(meta).encode(),
                                  dtype=np.uint8),
        }
        if valid is not None:
            arrays["valid"] = valid
        if int8 and len(emb):
            q, scales = quantize_rows_np(emb)         # per-ROW scales
            arrays["embeddings_int8"] = q
            arrays["scales"] = scales
            emb = q.astype(np.float32) * scales[:, None]
        else:
            arrays["embeddings"] = emb
        np.savez_compressed(path, **arrays)
        ts_list = [float(t) for t in timestamps]
        # one file per video: entries under any other tag/rate are now
        # stale in the memory tier too
        self._mem_drop(video_id)
        self._mem_put((video_id, model_tag, int(sample_rate)), emb,
                      ts_list, valid)
        logger.info("Cached %d embeddings for %s (%s%s)", len(emb),
                    video_id, model_tag,
                    "" if valid is None
                    else f", sparse {int(valid.sum())}/{len(valid)} rows")
        return emb

    def get(self, video_id: str, model_tag: str, sample_rate: int
            ) -> Optional[Tuple[np.ndarray, List[float]]]:
        """Complete tables only — sparse cold-scan entries (see ``put``)
        are invisible here, so every pre-existing consumer keeps its
        all-rows-are-real contract. ``get_entry`` serves both."""
        ent = self.get_entry(video_id, model_tag, sample_rate)
        if ent is None or ent[2] is not None:
            return None
        return ent[0], ent[1]

    def get_entry(self, video_id: str, model_tag: str, sample_rate: int
                  ) -> Optional[Tuple[np.ndarray, List[float],
                                      Optional[np.ndarray]]]:
        """→ (emb, ts, valid) — ``valid`` is None for complete tables,
        else the bool row mask of a sparse entry (unfilled rows are
        zero vectors)."""
        key = (video_id, model_tag, int(sample_rate))
        with self._mem_lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                emb, ts, valid = self._mem[key]
                return emb, list(ts), valid
        path = self._path(video_id)
        if not path.exists():
            return None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"].tobytes()).decode())
                if (meta.get("version") != FORMAT_VERSION
                        or meta.get("model_tag") != model_tag
                        or meta.get("sample_rate") != sample_rate):
                    logger.info("Embedding cache stale for %s "
                                "(tag/rate/version mismatch)", video_id)
                    return None
                if "embeddings_int8" in z:
                    emb = (z["embeddings_int8"].astype(np.float32)
                           * z["scales"][:, None])
                else:
                    emb = np.asarray(z["embeddings"], np.float32)
                ts = [float(t) for t in z["timestamps"]]
                valid = (np.asarray(z["valid"], bool)
                         if not meta.get("complete", True) else None)
                self._mem_put(key, emb, ts, valid)
                return emb, ts, valid
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as exc:
            logger.warning("Corrupt embedding cache for %s: %s", video_id, exc)
            return None

    def complete_rows(self, video_id: str, model_tag: str,
                      sample_rate: int, rows: np.ndarray,
                      row_idx: np.ndarray,
                      frame_hw: Optional[Tuple[int, int]] = None
                      ) -> Optional[np.ndarray]:
        """Fill rows of a sparse entry (lazy backfill of a sparse cold
        scan — ``Phase1Scan.frame_embeddings(rows="full")``). Returns
        the canonical merged table (complete if every row is now
        valid), or None when no entry exists under this key.

        Merging re-quantizes the whole table; the per-row amax/127
        scheme is exactly idempotent on already-round-tripped rows, so
        previously-stored rows keep their byte-identical values.

        Completed tables are exact (sparse entries and backfill rows
        are both embedded without dedup gating), so the merged entry
        is stored with ``dedup_gated=False`` provenance."""
        ent = self.get_entry(video_id, model_tag, sample_rate)
        if ent is None:
            return None
        emb, ts, valid = ent
        if valid is None:
            return emb                      # already complete
        if frame_hw is None:
            frame_hw = (0, 0)
            try:
                with np.load(self._path(video_id)) as z:
                    meta = json.loads(bytes(z["meta"].tobytes()).decode())
                    frame_hw = tuple(meta.get("frame_hw", (0, 0)))
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                pass
        merged = np.array(emb, dtype=np.float32, copy=True)
        row_idx = np.asarray(row_idx, dtype=np.int64)
        merged[row_idx] = np.asarray(rows, dtype=np.float32)
        new_valid = valid.copy()
        new_valid[row_idx] = True
        return self.put(video_id, merged, ts, model_tag, frame_hw,
                        sample_rate, valid=new_valid)

    def invalidate(self, video_id: str) -> None:
        """Drop a video's entry from memory and disk."""
        self._mem_drop(video_id)
        self._path(video_id).unlink(missing_ok=True)

    def stats(self) -> dict:
        """Entries on disk and their bytes."""
        files = list(self.dir.glob("*.npz"))
        return {"entries": len(files),
                "bytes": sum(f.stat().st_size for f in files)}


class FrameReprCache:
    """Per-frame, query-INDEPENDENT rerank representations (BLIP
    captions), cached per video next to the embedding tables, in the
    JAX package's format: ``<video_id>.<kind>.npz`` mapping
    ``r<timestamp_ms>`` → array (captions are numpy unicode scalars —
    npz-safe without pickle), with a ``tag`` entry for model-identity
    invalidation. In-memory dict tier in front of disk. A warm rerank
    therefore reads no frame and runs no captioner.

    Concurrency: the load-merge-save in ``put_many`` is guarded by an
    in-process lock only — the API serves from ONE process, so
    cross-process writers are out of contract; two independent
    processes pointed at the same cache dir could drop each other's
    merged entries.

    ``persist=False`` keeps the cache memory-only (used when the
    embedding cache is disabled: disabling caching must not keep
    writing rerank reprs to disk)."""

    def __init__(self, kind: str, cache_dir: Optional[str] = None,
                 persist: bool = True) -> None:
        self.kind = kind
        self.persist = persist
        self.dir = Path(cache_dir or settings.EMBEDDING_DIR)
        if persist:
            self.dir.mkdir(parents=True, exist_ok=True)
        # memory tier: video_id → (tag, entries), LRU-evicted under a
        # byte budget like EmbeddingCache's tier — the tag is PART of
        # the cached value, so an in-process model-knob change discards
        # rather than serves (and never persists) stale reprs
        self._mem: "OrderedDict[str, Tuple[str, Dict[str, np.ndarray]]]" \
            = OrderedDict()
        self._mem_bytes = 0
        self._lock = threading.Lock()

    def _path(self, video_id: str) -> Path:
        return self.dir / f"{video_id}.{self.kind}.npz"

    @staticmethod
    def key(timestamp: float) -> str:
        return f"r{int(round(timestamp * 1000))}"

    @staticmethod
    def _nbytes(entries: Dict[str, np.ndarray]) -> int:
        return sum(getattr(v, "nbytes", 64) for v in entries.values())

    def _mem_store(self, video_id: str, tag: str,
                   entries: Dict[str, np.ndarray]) -> None:
        if video_id in self._mem:
            self._mem_bytes -= self._nbytes(self._mem[video_id][1])
            del self._mem[video_id]
        budget = settings.EMBEDDING_MEM_CACHE_MB * (1 << 20)
        if budget <= 0:     # 0 disables the tier (EmbeddingCache rule)
            return
        self._mem[video_id] = (tag, entries)
        self._mem_bytes += self._nbytes(entries)
        while self._mem_bytes > budget and len(self._mem) > 1:
            _, (_, old) = self._mem.popitem(last=False)
            self._mem_bytes -= self._nbytes(old)

    def _load(self, video_id: str, tag: str) -> Dict[str, np.ndarray]:
        hit = self._mem.get(video_id)
        if hit is not None and hit[0] == tag:
            self._mem.move_to_end(video_id)
            return hit[1]
        entries: Dict[str, np.ndarray] = {}
        p = self._path(video_id)
        if self.persist and p.exists():
            try:
                with np.load(p, allow_pickle=False) as z:
                    if str(z["tag"]) == tag:
                        entries = {k: z[k] for k in z.files if k != "tag"}
                    else:
                        logger.info("Repr cache tag changed for %s "
                                    "(%s) — discarding", video_id,
                                    self.kind)
            except (OSError, ValueError, KeyError) as exc:
                logger.warning("Corrupt repr cache for %s: %s",
                               video_id, exc)
        self._mem_store(video_id, tag, entries)
        return entries

    def get_many(self, video_id: str, tag: str, timestamps
                 ) -> Dict[str, np.ndarray]:
        """→ {key: repr} for the cached subset of ``timestamps``."""
        with self._lock:
            entries = self._load(video_id, tag)
            keys = [self.key(t) for t in timestamps]
            return {k: entries[k] for k in keys if k in entries}

    def put_many(self, video_id: str, tag: str,
                 new: Dict[str, np.ndarray]) -> None:
        if not new:
            return
        with self._lock:
            # a new dict, not the one the memory tier holds: _mem_store
            # subtracts the stored dict's size, which an in-place update
            # would already have grown (the JAX package's put_many has
            # that defect, so its tier under-counts)
            entries = {**self._load(video_id, tag), **new}
            self._mem_store(video_id, tag, entries)
            if not self.persist:
                return
            try:
                # atomic replace: a crash mid-write must not truncate
                # the only copy of every cached repr for the video.
                # The tmp name must END in .npz — np.savez appends the
                # extension otherwise and the rename source vanishes.
                p = self._path(video_id)
                tmp = p.with_name(p.stem + ".tmp.npz")
                np.savez(tmp, tag=np.str_(tag), **entries)
                tmp.replace(p)
            except OSError as exc:  # disk full etc — keep memory tier
                logger.warning("Repr cache write failed for %s: %s",
                               video_id, exc)

    def invalidate(self, video_id: str) -> None:
        with self._lock:
            hit = self._mem.pop(video_id, None)
            if hit is not None:
                self._mem_bytes -= self._nbytes(hit[1])
            if self.persist:
                self._path(video_id).unlink(missing_ok=True)
