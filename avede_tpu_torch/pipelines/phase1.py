"""Phase 1 — the core text→video scan (counterpart of
``avede_tpu/pipelines/phase1.py``).

Extract frames → sliding windows (16/8) → score each window's MIDDLE
frame by CLIP cosine against the query → top-k above
``CONFIDENCE_THRESHOLD`` → result dicts
``{timestamp, confidence, phase, window_index}``.

Sampled frames are embedded on the device in bucket-padded chunks
(``parallel/embed.py``); windows are index arithmetic
(``ops/windows.py``); scoring + top-k run on a device-resident table
(``ClipEngine.query_window_topk``). Embeddings persist in the versioned
cache so repeat queries skip decode AND embed entirely. Spans
(``utils/trace.py``) are ``torch.profiler.record_function`` ranges that
also record their wall time into the metrics monitor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..io.embedding_cache import EmbeddingCache
from ..io.frame_retention import FrameRetention
from ..io.video_reader import VideoReader
from ..ops.dedup import FrameDeduper, rebatch
from ..ops.dedup import _signatures as _dedup_sigs
from ..ops.similarity import window_topk_multi
from ..ops.windows import window_middle_indices, window_timestamps
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.trace import trace

logger = get_logger(__name__)


class Phase1Scan:
    phase_name = "phase1_mvp"

    def __init__(self, engine: Optional[ClipEngine] = None,
                 reader: Optional[VideoReader] = None,
                 cache: Optional[EmbeddingCache] = None,
                 device: Optional[str] = None) -> None:
        """``engine`` defaults to a ``ClipEngine`` on ``device`` (``cuda``
        unless ``"cpu"`` is passed). ``reader`` is anything with
        ``stream_frames(path, chunk=, finish=)``,
        ``expected_sample_count(path)`` and ``sample_rate``."""
        self.engine = engine or ClipEngine(device=device)
        self.reader = reader or VideoReader()
        self.cache = cache if cache is not None else (
            EmbeddingCache() if settings.EMBEDDING_CACHE_ENABLED else None)
        # scan-decoded frames of the latest video, kept for the lazy
        # backfill of sparse tables (no second decode)
        self.retention = FrameRetention()

    def cache_tag(self) -> str:
        """Embedding-cache model tag (shared with every other table
        producer — see ``io.embedding_cache.table_tag``)."""
        from ..io.embedding_cache import table_tag

        return table_tag(self.engine.model_tag)

    # ------------------------------------------------------------------
    def frame_embeddings(self, video_path: str,
                         video_id: Optional[str] = None,
                         rows: str = "full"
                         ) -> Tuple[np.ndarray, List[float]]:
        """Embeddings+timestamps for sampled frames, cache-aware.

        ``rows="full"`` (default): every sampled frame's row is real —
        the contract every pre-existing consumer (phase-3 grounding,
        library ingest) relies on. ``rows="scan"``: only the rows
        phase-1 scoring ever reads (window MIDDLE frames,
        ``ops/windows.py``) are guaranteed; with
        ``settings.SCAN_SPARSE_COLD`` the cold path then embeds ~1/8 of
        the frames — proportionally less host→device transfer (the
        cold-scan wall on bandwidth-limited links) AND less ViT work —
        and stores a sparse cache entry that full-table consumers
        complete lazily from scan retention (no second decode).

        Cold path overlaps decode with embed: ``stream_frames`` chunks
        feed ``embed_stream`` through a staging thread, so the device
        embeds chunk *i* while the host decodes chunk *i+1*."""
        vid = video_id or _default_video_id(video_path)
        tag = self.cache_tag()
        if self.cache is not None:
            ent = self.cache.get_entry(vid, tag, self.reader.sample_rate)
            if ent is not None:
                emb, ts_hit, valid = ent
                if valid is None:
                    logger.info("Embedding cache hit for %s (%d frames)",
                                vid, len(emb))
                    return emb, ts_hit
                if rows == "scan" and self._scan_rows_valid(valid):
                    logger.info(
                        "Sparse embedding cache hit for %s (%d/%d rows)",
                        vid, int(valid.sum()), len(valid))
                    return emb, ts_hit
                done = self._complete_table(video_path, vid, tag, emb,
                                            ts_hit, valid)
                if done is not None:
                    return done, ts_hit
                # retention gone AND decode fallback failed: rescan dense
                logger.warning("Sparse entry for %s could not be "
                               "completed — rescanning", vid)
        size = self.engine.cfg.image_size
        fused = (settings.SCAN_FUSED_PACK
                 and settings.SCAN_TRANSFER == "i420"
                 and size % 4 == 0)
        if rows == "scan" and settings.SCAN_SPARSE_COLD and fused:
            return self._scan_sparse(video_path, vid, tag, size)
        return self._scan_dense(video_path, vid, tag, size, fused)

    def _scan_rows_valid(self, valid: np.ndarray) -> bool:
        mids = window_middle_indices(len(valid), settings.WINDOW_SIZE,
                                     settings.WINDOW_STRIDE)
        return bool(valid[mids].all()) if len(mids) else True

    def _scan_dense(self, video_path: str, vid: str, tag: str,
                    size: int, fused: bool
                    ) -> Tuple[np.ndarray, List[float]]:
        eps = settings.SCAN_DEDUP_EPS
        ts: List[float] = []
        shape: List[Tuple[int, int]] = []
        # fused pack: the compact-transfer i420 pack runs ON the decode
        # threads (N-way parallel) instead of serialized on the staging
        # thread, and the decoder's per-frame BGR→RGB pass is deleted —
        # the pack matrix absorbs the channel order
        # (``pack_frames_i420(src="bgr")``). Retention keeps the BGR
        # chunks; lookup converts requested frames back to RGB.
        finish = None
        if fused:
            from ..ops.preprocess import pack_frames_i420

            def finish(bgr, chunk_ts):   # runs on decode threads
                if not shape:
                    shape.append(bgr.shape[1:3])
                # retain pre-dedup (the reranker needs frames the scan
                # skipped as duplicates too); zero-copy chunk reference
                self.retention.add(vid, bgr, chunk_ts)
                return pack_frames_i420(bgr, size, src="bgr")

            # gate signatures on the packed luma plane (the chroma
            # rows would dilute the 16×16 thumbnail)
            deduper = (FrameDeduper(
                eps, signature_fn=lambda f: _dedup_sigs(f[:, :size]))
                if eps > 0 else None)
        else:
            deduper = FrameDeduper(eps) if eps > 0 else None
        self.retention.begin(vid, color="bgr" if fused else "rgb")

        def chunks():
            for frames, chunk_ts in self.reader.stream_frames(
                    video_path, chunk=settings.STREAM_CHUNK_FRAMES,
                    finish=finish):
                ts.extend(chunk_ts)
                if not fused:
                    if not shape:
                        shape.append(frames.shape[1:3])
                    self.retention.add(vid, frames, chunk_ts)
                if deduper is not None:
                    frames = deduper.filter(frames)
                    if len(frames) == 0:
                        continue
                yield frames

        with trace("phase1.decode_embed"):
            # rebatch: dedup leaves chunks of arbitrary size; coalescing
            # keeps the stream on full buckets
            stream = chunks()
            if deduper is not None:
                stream = rebatch(stream, settings.STREAM_CHUNK_FRAMES)
            emb = self.engine.embed_stream(stream)
        if deduper is not None:
            emb = deduper.scatter(emb)
            if deduper.n_unique < deduper.n_total:
                logger.info(
                    "Scan dedup: embedded %d/%d frames (%.0f%% duplicate)",
                    deduper.n_unique, deduper.n_total,
                    100 * (1 - deduper.n_unique / deduper.n_total))
        if self.cache is not None:
            # put returns the canonical stored values (int8 round trip
            # when enabled) so cold and warm queries score identically
            emb = self.cache.put(vid, emb, ts, tag, shape[0],
                                 self.reader.sample_rate,
                                 gated=deduper is not None)
        return emb, ts

    # ------------------------------------------------------------------
    def _scan_sparse(self, video_path: str, vid: str, tag: str,
                     size: int) -> Tuple[np.ndarray, List[float]]:
        """Cold scan that embeds ONLY window-middle rows.

        The whole video still decodes once (retention needs every
        sampled frame for the lazy backfill), but only ~1/8 of the
        frames are packed, transferred, and pushed through the ViT.

        Middle rows are embedded EXACTLY — the dedup gate is
        deliberately NOT applied here. Consecutive middles are a full
        stride (8 frames) apart, so gating them buys almost nothing,
        and a gated sparse table would disagree with a dense scan's
        values under the same cache tag.
        Phase-1 scores from a sparse table therefore equal an exact
        (eps=0) dense scan's up to int8-cache quantization; when
        ``SCAN_DEDUP_EPS > 0`` it is the DENSE scan that approximates
        (duplicate rows carry their run representative's embedding),
        never the sparse one. Middle indices come from the container's
        metadata frame count; if the decode yields a different count
        (broken metadata), the delta rows are embedded from retention
        before the table is stored."""
        from ..ops.preprocess import pack_frames_i420

        n_exp = self.reader.expected_sample_count(video_path)
        sel = np.unique(window_middle_indices(
            n_exp, settings.WINDOW_SIZE, settings.WINDOW_STRIDE)
        ).astype(np.int64)
        ts: List[float] = []
        shape: List[Tuple[int, int]] = []
        sel_order: List[int] = []

        def finish(bgr, chunk_ts):      # decode threads: retain only
            if not shape:
                shape.append(bgr.shape[1:3])
            self.retention.add(vid, bgr, chunk_ts)
            return bgr

        self.retention.begin(vid, color="bgr")

        def chunks():
            off = 0
            for bgr, chunk_ts in self.reader.stream_frames(
                    video_path, chunk=settings.STREAM_CHUNK_FRAMES,
                    finish=finish):
                lo, off = off, off + len(bgr)
                ts.extend(chunk_ts)
                take = sel[(sel >= lo) & (sel < off)] - lo
                if len(take) == 0:
                    continue
                sel_order.extend((take + lo).tolist())
                yield pack_frames_i420(
                    np.ascontiguousarray(bgr[take]), size, src="bgr")

        with trace("phase1.decode_embed"):
            # rebatch: middle rows arrive ~chunk/stride at a time;
            # coalescing keeps the stream on full buckets
            emb_sel = self.engine.embed_stream(
                rebatch(chunks(), settings.STREAM_CHUNK_FRAMES))
        n = len(ts)
        dim = (emb_sel.shape[1] if len(emb_sel)
               else self.engine.cfg.projection_dim)
        table = np.zeros((n, dim), np.float32)
        valid = np.zeros(n, bool)
        idx = np.asarray(sel_order, np.int64)
        table[idx] = np.asarray(emb_sel, np.float32)
        valid[idx] = True
        logger.info("Sparse cold scan for %s: embedded %d/%d rows",
                    vid, len(idx), n)
        # metadata drift: the real count defines the windows
        missing = window_middle_indices(n, settings.WINDOW_SIZE,
                                        settings.WINDOW_STRIDE)
        missing = np.unique(missing[~valid[missing]])
        if len(missing):
            logger.info("Metadata count %d vs decoded %d for %s — "
                        "embedding %d extra middle rows", n_exp, n,
                        vid, len(missing))
            got = self._embed_rows_from_retention(vid, ts, missing)
            if got is None:     # retention blew budget mid-scan: rare
                fused = True    # sparse requires the fused path
                return self._scan_dense(video_path, vid, tag, size,
                                        fused)
            table[missing] = got
            valid[missing] = True
        if self.cache is not None:
            table = self.cache.put(
                vid, table, ts, tag, shape[0] if shape else (0, 0),
                self.reader.sample_rate, valid=valid)
        return table, ts

    def _embed_rows_from_retention(self, vid: str, ts: List[float],
                                   idx: np.ndarray
                                   ) -> Optional[np.ndarray]:
        """Embed table rows ``idx`` from retained scan frames (RGB on
        lookup — pixel-identical to the decode-thread pack)."""
        from ..io.frame_retention import ts_key

        # duplicate timestamps quantize to the same ms key; retention
        # holds ONE frame per key, so completeness is judged per unique
        # key, not per row (a len mismatch here used to force a
        # needless full re-decode). Shared keys are only trusted when
        # the colliding rows carry the SAME timestamp (true duplicate
        # pts → same frame); two *different* timestamps landing on one
        # ms key could be different frames, and serving the one
        # retained frame for both would store a neighbor's embedding
        # as exact — that case falls back to the per-index decode.
        keys = [ts_key(ts[i]) for i in idx]
        by_key: dict = {}
        for i, k in zip(idx, keys):
            if by_key.setdefault(k, ts[i]) != ts[i]:
                return None
        frames = self.retention.lookup(vid, [ts[i] for i in idx])
        if len(frames) < len(by_key):
            return None
        arr = np.stack([frames[k] for k in keys])
        return self.engine.embed_frames(arr)

    def _complete_table(self, video_path: str, vid: str, tag: str,
                        emb: np.ndarray, ts: List[float],
                        valid: np.ndarray) -> Optional[np.ndarray]:
        """Lazy backfill of a sparse cache entry: embed every missing
        row (retention first, one streaming re-decode as fallback) and
        merge into the cached table. Backfill rows are embedded
        EXACTLY (no dedup gating — they are off the latency path), so
        completed tables are at least as accurate as a dense scan's."""
        missing = np.where(~valid)[0]
        if len(missing) == 0:
            return emb
        with trace("phase1.backfill"):
            rows = self._embed_rows_from_retention(vid, ts, missing)
            if rows is None:
                rows = self._embed_rows_by_decode(video_path, missing)
            if rows is None or len(rows) != len(missing):
                return None
            logger.info("Backfilled %d/%d rows for %s", len(missing),
                        len(valid), vid)
            if self.cache is not None:
                merged = self.cache.complete_rows(
                    vid, tag, self.reader.sample_rate, rows, missing)
                if merged is not None:
                    return merged
            merged = np.array(emb, np.float32, copy=True)
            merged[missing] = rows
            return merged

    def _embed_rows_by_decode(self, video_path: str, idx: np.ndarray
                              ) -> Optional[np.ndarray]:
        """Streaming re-decode that embeds only global rows ``idx`` —
        the backfill fallback when retention no longer holds the scan
        frames (evicted by a later video, or over budget)."""
        from ..ops.preprocess import pack_frames_i420, pack_frames_rgb

        size = self.engine.cfg.image_size
        i420 = settings.SCAN_TRANSFER == "i420" and size % 4 == 0
        sel = np.unique(np.asarray(idx, np.int64))
        order: List[int] = []

        def chunks():
            off = 0
            for bgr, _ts in self.reader.stream_frames(
                    video_path, chunk=settings.STREAM_CHUNK_FRAMES,
                    finish=lambda f, t: f):
                lo, off = off, off + len(bgr)
                take = sel[(sel >= lo) & (sel < off)] - lo
                if len(take) == 0:
                    continue
                order.extend((take + lo).tolist())
                part = np.ascontiguousarray(bgr[take])
                yield (pack_frames_i420(part, size, src="bgr") if i420
                       else pack_frames_rgb(part[..., ::-1], size))

        try:
            emb = self.engine.embed_stream(rebatch(
                chunks(), settings.STREAM_CHUNK_FRAMES))
        except Exception as exc:  # noqa: BLE001 — caller rescans dense
            logger.warning("Backfill decode failed for %s: %s",
                           video_path, exc)
            return None
        if len(emb) != len(sel) or list(sel) != order:
            return None
        # map back to the caller's (possibly unsorted) idx order
        pos = {int(g): i for i, g in enumerate(order)}
        return np.asarray(emb, np.float32)[
            [pos[int(g)] for g in np.asarray(idx, np.int64)]]

    # ------------------------------------------------------------------
    def process_video(self, video_path: str, query: str,
                      top_k: Optional[int] = None,
                      threshold: Optional[float] = None,
                      video_id: Optional[str] = None) -> List[Dict]:
        top_k = top_k or settings.TOP_K_RESULTS
        threshold = (settings.CONFIDENCE_THRESHOLD if threshold is None
                     else threshold)

        emb, ts = self.frame_embeddings(video_path, video_id,
                                        rows="scan")
        n = len(emb)
        mids = window_middle_indices(n, settings.WINDOW_SIZE,
                                     settings.WINDOW_STRIDE)
        wts = window_timestamps(ts, settings.WINDOW_SIZE,
                                settings.WINDOW_STRIDE)
        if len(mids) == 0:
            return []

        with trace("phase1.score_topk"):
            # ids → text tower → fused score + window top-k (kernel) on the
            # bucket-padded resident table; the text embedding lands in
            # the engine's LRU
            k = min(top_k, len(mids))
            vals, idx = self.engine.query_window_topk(
                query, emb, mids.astype(np.int32), k)

        results = []
        for v, i in zip(vals, idx):
            if np.isfinite(v) and v >= threshold:
                results.append({
                    "timestamp": float(wts[int(i)]),
                    "confidence": float(v),
                    "phase": self.phase_name,
                    "window_index": int(i),
                })
        logger.info("Phase 1: %d/%d windows above threshold %.2f for %r",
                    len(results), len(mids), threshold, query)
        return results

    def process_queries(self, video_path: str, queries: List[str],
                        top_k: Optional[int] = None,
                        threshold: Optional[float] = None,
                        video_id: Optional[str] = None
                        ) -> Dict[str, List[Dict]]:
        """Multi-query scan: ONE embedding table, one fused score +
        top-k launch for all queries — marginal cost per extra query ≈
        one text encode."""
        top_k = top_k or settings.TOP_K_RESULTS
        threshold = (settings.CONFIDENCE_THRESHOLD if threshold is None
                     else threshold)
        emb, ts = self.frame_embeddings(video_path, video_id,
                                        rows="scan")
        mids = window_middle_indices(len(emb), settings.WINDOW_SIZE,
                                     settings.WINDOW_STRIDE)
        wts = window_timestamps(ts, settings.WINDOW_SIZE,
                                settings.WINDOW_STRIDE)
        if len(mids) == 0:
            return {q: [] for q in queries}
        q_emb = self.engine.embed_texts(queries)          # [Q, D]
        with trace("phase1.score_topk"):
            k = min(top_k, len(mids))
            demb, dvalid, dmids = self.engine.resident_table(
                emb, mids.astype(np.int32))
            vals, idx = window_topk_multi(
                demb, dvalid, torch.from_numpy(q_emb).to(demb.device),
                dmids, k=k)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        out: Dict[str, List[Dict]] = {}
        for qi, query in enumerate(queries):
            out[query] = [{
                "timestamp": float(wts[int(i)]),
                "confidence": float(v),
                "phase": self.phase_name,
                "window_index": int(i),
            } for v, i in zip(vals[qi], idx[qi])
                if np.isfinite(v) and v >= threshold]
        return out


def _default_video_id(video_path: str) -> str:
    from pathlib import Path

    return Path(video_path).stem
