"""Reference-image → video matching in six modes (counterpart of
``avede_tpu/services/image_matcher.py``):

- ``traditional``: pHash gate → CLIP ranking → SSIM, HSV histogram and
  ORB on the CLIP survivors → composite ``0.4·clip + 0.25·ssim +
  0.2·hist + 0.1·feat + 0.05·hash``;
- ``fast_match``: CLIP alone;
- ``object_focused``: YOLO boxes of every sampled frame, their crops'
  CLIP embeddings against the reference's;
- ``cross_domain``: lighting- and colour-invariant features on the CLIP
  survivors;
- ``hybrid``: traditional + cross-domain + object ensemble;
- ``smart_match``: the reference image's characteristics pick the
  ensemble weights; timestamp fusion with a diversity bonus.

CLIP similarity of every sampled frame is one product of the cached
frame-embedding table (``ClipEngine.embed_frames``: the I420 patch
embed and flash attention on the card) with the reference's embedding
(``embed_images``); the host stages touch only the CLIP survivors.
Results are cached per (video, image md5, mode, threshold).
"""

from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..io.embedding_cache import EmbeddingCache, table_tag
from ..io.video_reader import VideoReader
from ..ops import image_feats as F
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from .cross_domain_matcher import CrossDomainMatcher

logger = get_logger(__name__)

COMPOSITE = {"clip": 0.40, "ssim": 0.25, "hist": 0.20, "feat": 0.10,
             "hash": 0.05}
HASH_MAX_DISTANCE = 20        # stage-1 pHash gate (of 64 bits)
CLIP_STAGE_KEEP = 40          # CLIP survivors entering host stages


def _phash_distances(image: np.ndarray, frames: np.ndarray) -> np.ndarray:
    """Hamming distance of the reference's hash to every frame's (the
    JAX package's C++ ``phash_batch``, vectorised in ``ops/hostops``)."""
    import cv2

    from ..ops import hostops

    gray = np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames])
    ref_gray = cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    hashes = hostops.phash_batch(gray)
    ref = int(hostops.phash_batch(ref_gray[None])[0])
    return hostops.hamming_batch(ref, hashes)


class ImageMatcher:
    def __init__(self, engine: ClipEngine,
                 reader: Optional[VideoReader] = None,
                 cross_domain: Optional[CrossDomainMatcher] = None,
                 yolo=None,
                 cache: Optional[EmbeddingCache] = None) -> None:
        self.engine = engine
        self.reader = reader or VideoReader()
        self.cross_domain = cross_domain or CrossDomainMatcher()
        self._yolo = yolo
        self.cache = cache if cache is not None else (
            EmbeddingCache() if settings.EMBEDDING_CACHE_ENABLED else None)
        self._results: Dict[str, List[Dict]] = {}
        self.stats = {"matches_run": 0, "seconds": 0.0}

    @property
    def yolo(self):
        if self._yolo is None:
            from .detector import YoloService

            self._yolo = YoloService(device=self.engine.device)
        return self._yolo

    # ------------------------------------------------------------------
    def _frame_data(self, video_path: str, video_id: Optional[str]):
        frames, ts = self.reader.extract_frames(video_path)
        vid = video_id or video_path
        emb = None
        # table_tag, NOT bare model_tag: Phase1 writes the same
        # <video_id>.npz — divergent tags would make text-scan and
        # image-match perpetually clobber each other's warm entry
        tag = table_tag(self.engine.model_tag)
        if self.cache is not None and video_id is not None:
            ent = self.cache.get_entry(video_id, tag,
                                       self.reader.sample_rate)
            if ent is not None and len(ent[0]) == len(frames):
                table, _ts, valid = ent
                if valid is None:
                    emb = table
                else:
                    # sparse cold-scan entry: the frames are already in
                    # hand here, so embed ONLY the missing rows and
                    # upgrade the entry to complete — no full re-embed
                    missing = np.where(~valid)[0]
                    rows = self.engine.embed_frames(frames[missing])
                    emb = self.cache.complete_rows(
                        video_id, tag, self.reader.sample_rate,
                        rows, missing, frame_hw=frames.shape[1:3])
        if emb is None:
            emb = self.engine.embed_frames(frames)
            if self.cache is not None and video_id is not None:
                emb = self.cache.put(
                    video_id, emb, ts, tag,
                    frames.shape[1:3], self.reader.sample_rate)
        return frames, ts, emb

    def _result_key(self, video_id: str, image: np.ndarray, mode: str,
                    threshold: float) -> str:
        h = hashlib.md5(image.tobytes()).hexdigest()[:16]
        return f"{video_id}|{h}|{mode}|{threshold:.3f}"

    # ------------------------------------------------------------------
    def match_image_to_video(self, video_path: str, image: np.ndarray,
                             mode: str = "smart_match",
                             target_class: Optional[str] = None,
                             top_k: Optional[int] = None,
                             threshold: Optional[float] = None,
                             video_id: Optional[str] = None) -> List[Dict]:
        t0 = time.time()
        top_k = top_k or settings.TOP_K_RESULTS
        if mode not in settings.MATCHING_MODES:
            raise ValueError(f"unknown matching mode '{mode}' "
                             f"(expected one of {settings.MATCHING_MODES})")
        if threshold is None:
            threshold = settings.MATCHING_THRESHOLDS.get(mode, 0.6)

        key = self._result_key(video_id or video_path, image, mode,
                               threshold)
        if key in self._results:
            return self._results[key][:top_k]

        frames, ts, emb = self._frame_data(video_path, video_id)
        ref_emb = self.engine.embed_images([image])[0]
        clip_sims = emb @ ref_emb

        if mode == "fast_match":
            matches = self._fast(frames, ts, clip_sims, threshold)
        elif mode == "traditional":
            matches = self._traditional(image, frames, ts, clip_sims,
                                        threshold)
        elif mode == "cross_domain":
            matches = self._cross(image, frames, ts, clip_sims, threshold)
        elif mode == "object_focused":
            matches = self._object(image, frames, ts, threshold,
                                   target_class)
        elif mode == "hybrid":
            matches = self._hybrid(image, frames, ts, clip_sims, threshold,
                                   target_class)
        else:
            matches = self._smart(image, frames, ts, clip_sims, threshold,
                                  target_class)

        matches.sort(key=lambda m: m["similarity"], reverse=True)
        matches = matches[: max(top_k * 2, top_k)]
        self._results[key] = matches
        self.stats["matches_run"] += 1
        self.stats["seconds"] += time.time() - t0
        return matches[:top_k]

    # ------------------------------------------------------------------
    @staticmethod
    def _mk(i: int, ts: Sequence[float], sim: float, method: str,
            **extra) -> Dict:
        return {"frame_index": int(i), "timestamp": float(ts[i]),
                "similarity": float(sim), "confidence": float(sim),
                "method": method, **extra}

    def _fast(self, frames, ts, clip_sims, threshold) -> List[Dict]:
        idx = np.nonzero(clip_sims >= threshold)[0]
        return [self._mk(i, ts, clip_sims[i], "fast_match",
                         breakdown={"clip": float(clip_sims[i])})
                for i in idx]

    def _traditional(self, image, frames, ts, clip_sims,
                     threshold) -> List[Dict]:
        # stage 1: pHash gate (C++ hostops batch path when built)
        dists = _phash_distances(image, frames)
        # stage 2: CLIP ranking of hash survivors; keep top CLIP_STAGE_KEEP
        mask = dists <= HASH_MAX_DISTANCE
        if not mask.any():
            mask = np.ones_like(mask)       # degrade: hash gate too tight
        cand = np.nonzero(mask)[0]
        cand = cand[np.argsort(clip_sims[cand])[::-1][:CLIP_STAGE_KEEP]]
        ref_hist = F.hsv_histogram(image)
        out = []
        for i in cand:
            s_ssim = max(F.ssim(image, frames[i]), 0.0)
            s_hist = max(F.histogram_correlation(
                ref_hist, F.hsv_histogram(frames[i])), 0.0)
            s_feat, _ = F.orb_match_score(image, frames[i])
            s_hash = 1.0 - dists[i] / 64.0
            sim = (COMPOSITE["clip"] * max(clip_sims[i], 0.0)
                   + COMPOSITE["ssim"] * s_ssim
                   + COMPOSITE["hist"] * s_hist
                   + COMPOSITE["feat"] * s_feat
                   + COMPOSITE["hash"] * s_hash)
            if sim >= threshold:
                out.append(self._mk(
                    i, ts, sim, "traditional",
                    breakdown={"clip": float(clip_sims[i]),
                               "ssim": s_ssim, "hist": s_hist,
                               "feat": s_feat, "hash": s_hash}))
        return out

    def _cross(self, image, frames, ts, clip_sims, threshold) -> List[Dict]:
        # CLIP pre-rank to bound host feature work, then cross-domain
        cand = np.argsort(clip_sims)[::-1][:CLIP_STAGE_KEEP]
        hits = self.cross_domain.match_against_frames(
            image, frames[cand], threshold=threshold)
        return [self._mk(int(cand[h["frame_index"]]), ts, h["similarity"],
                         "cross_domain", breakdown=h["breakdown"])
                for h in hits]

    def _object(self, image, frames, ts, threshold,
                target_class) -> List[Dict]:
        from .detector import extract_object_embeddings

        ref_emb = self.engine.embed_images([image])[0]
        dets_per_frame = self.yolo.detect(frames, conf_threshold=0.25)
        out = []
        for i, dets in enumerate(dets_per_frame):
            if target_class:
                dets = [d for d in dets if d["class_name"] == target_class]
            if not dets:
                continue
            crops = extract_object_embeddings(
                self.engine, frames[i], [d["bbox"] for d in dets])
            sims = crops @ ref_emb
            j = int(np.argmax(sims))
            if sims[j] >= threshold:
                out.append(self._mk(
                    i, ts, sims[j], "object_focused",
                    bbox=dets[j]["bbox"],
                    object_class=dets[j]["class_name"],
                    breakdown={"object_clip": float(sims[j]),
                               "detector_conf": dets[j]["confidence"]}))
        return out

    def _hybrid(self, image, frames, ts, clip_sims, threshold,
                target_class) -> List[Dict]:
        trad = self._traditional(image, frames, ts, clip_sims,
                                 threshold * 0.8)
        cross = self._cross(image, frames, ts, clip_sims, threshold * 0.8)
        obj = self._object(image, frames, ts, threshold * 0.8, target_class)
        return self._fuse([(trad, 0.4), (cross, 0.3), (obj, 0.3)],
                          ts, threshold, "hybrid")

    def _smart(self, image, frames, ts, clip_sims, threshold,
               target_class) -> List[Dict]:
        """Ensemble whose weights follow the reference image's
        characteristics (grayscale, background complexity)."""
        chars = F.analyze_image(image)
        if chars["is_grayscale"] > 0.5:
            weights = [(self._cross(image, frames, ts, clip_sims,
                                    threshold * 0.7), 0.5),
                       (self._traditional(image, frames, ts, clip_sims,
                                          threshold * 0.7), 0.3),
                       (self._object(image, frames, ts, threshold * 0.7,
                                     target_class), 0.2)]
        elif chars["background_complexity"] > 0.5:
            weights = [(self._object(image, frames, ts, threshold * 0.7,
                                     target_class), 0.5),
                       (self._cross(image, frames, ts, clip_sims,
                                    threshold * 0.7), 0.3),
                       (self._traditional(image, frames, ts, clip_sims,
                                          threshold * 0.7), 0.2)]
        else:
            weights = [(self._traditional(image, frames, ts, clip_sims,
                                          threshold * 0.7), 0.4),
                       (self._object(image, frames, ts, threshold * 0.7,
                                     target_class), 0.3),
                       (self._cross(image, frames, ts, clip_sims,
                                    threshold * 0.7), 0.3)]
        out = self._fuse(weights, ts, threshold, "smart_match")
        for m in out:
            m["image_characteristics"] = chars
        return out

    @staticmethod
    def _fuse(method_results, ts, threshold, method_name) -> List[Dict]:
        """Timestamp fusion with a diversity bonus: weighted mean of the
        methods' scores at the same frame, +10% per extra agreeing method
        (at most +30%)."""
        by_frame: Dict[int, List] = {}
        for results, weight in method_results:
            for m in results:
                by_frame.setdefault(m["frame_index"], []).append(
                    (m, weight))
        fused = []
        for fi, entries in by_frame.items():
            wsum = sum(w for _, w in entries)
            score = sum(m["similarity"] * w for m, w in entries) / wsum
            diversity = min(1.0 + 0.1 * (len(entries) - 1), 1.3)
            score = min(score * diversity, 1.0)
            if score >= threshold:
                base = dict(entries[0][0])
                base.update({"similarity": float(score),
                             "confidence": float(score),
                             "method": method_name,
                             "methods_agreeing": len(entries)})
                fused.append(base)
        return fused
