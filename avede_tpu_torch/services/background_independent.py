"""Background-independent object features and matching (counterpart of
``avede_tpu/services/background_independent.py``).

A box seeds GrabCut on the whole frame; the background of the box's
crop is pushed toward a fixed fill; the crop is embedded by the CLIP
engine (and by EfficientNet-B0 when ``FEATURE_EXTRACTOR_WEIGHTS`` names
its weights), with colour means in four colour spaces and a 20-d shape
descriptor of the mask; features compare by a weighted cosine.
``match_in_video`` serves ``POST /api/background-independence``.

GrabCut, the colour conversions and the contour moments stay on the
host through cv2, as in the JAX package. GrabCut's GMM initialisation
draws from cv2's global RNG, so two runs on one image can differ unless
``cv2.setRNGSeed`` is called before each; the service does not seed, as
the JAX package does not.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.video_reader import VideoReader
from ..models.convert import load_params
from ..models.effnet import EffNetConfig, effnet_b0, init_effnet
from ..ops import image_feats as F
from ..ops.preprocess import imagenet_preprocess
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.platform import resolve_device

logger = get_logger(__name__)


def grabcut_mask(image: np.ndarray, bbox: Sequence[float],
                 iterations: int = 3) -> Optional[np.ndarray]:
    """bbox-seeded GrabCut on the whole image → bool mask (True =
    foreground); None for a box under 4 px a side or when cv2 refuses."""
    import cv2

    h, w = image.shape[:2]
    x0 = int(np.clip(bbox[0], 0, w - 2))
    y0 = int(np.clip(bbox[1], 0, h - 2))
    x1 = int(np.clip(bbox[2], x0 + 1, w))
    y1 = int(np.clip(bbox[3], y0 + 1, h))
    if x1 - x0 < 4 or y1 - y0 < 4:
        return None
    mask = np.zeros((h, w), np.uint8)
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(image, mask, (x0, y0, x1 - x0, y1 - y0), bgd, fgd,
                    iterations, cv2.GC_INIT_WITH_RECT)
    except cv2.error:
        return None
    fg = (mask == cv2.GC_FGD) | (mask == cv2.GC_PR_FGD)
    if not fg.any():
        fg[y0:y1, x0:x1] = True
    return fg


def shape_descriptor(mask: np.ndarray) -> np.ndarray:
    """[20] of the mask's largest outer contour: area, perimeter,
    aspect, solidity, extent; log-scaled Hu moments; circularity and
    polygon corner count; the mean centroid → contour distance in six
    angular bins over the largest distance."""
    import cv2

    m8 = mask.astype(np.uint8)
    contours, _ = cv2.findContours(m8, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    out = np.zeros(20)
    if not contours:
        return out
    c = max(contours, key=cv2.contourArea)
    area = cv2.contourArea(c)
    perim = cv2.arcLength(c, True)
    x, y, w, h = cv2.boundingRect(c)
    hull = cv2.convexHull(c)
    hull_area = max(cv2.contourArea(hull), 1e-6)
    out[0] = min(area / mask.size, 1.0)
    out[1] = min(perim / (2 * (mask.shape[0] + mask.shape[1])), 1.0)
    out[2] = min(w / max(h, 1), 4.0) / 4.0
    out[3] = min(area / hull_area, 1.0)              # solidity
    out[4] = min(area / max(w * h, 1), 1.0)          # extent
    mom = cv2.moments(c)
    hu = cv2.HuMoments(mom).reshape(-1)
    out[5:12] = -np.sign(hu) * np.log10(np.abs(hu) + 1e-30) / 40.0
    # circularity 4πA/P²: circle 1.0, square .785, triangle .60
    out[12] = float(np.clip(4 * np.pi * area / max(perim ** 2, 1e-6),
                            0.0, 1.0))
    # polygon corner count (approx at 2% perimeter tolerance)
    approx = cv2.approxPolyDP(c, 0.02 * perim, True)
    out[13] = min(len(approx), 12) / 12.0
    # radial contour profile: centroid→contour distance at 6 angular
    # bins, normalized by the max radius
    if mom["m00"] > 0:
        cx, cy = mom["m10"] / mom["m00"], mom["m01"] / mom["m00"]
        pts = c.reshape(-1, 2).astype(np.float64)
        d = np.hypot(pts[:, 0] - cx, pts[:, 1] - cy)
        ang = np.arctan2(pts[:, 1] - cy, pts[:, 0] - cx)
        rmax = max(d.max(), 1e-6)
        for b in range(6):
            lo = -np.pi + b * np.pi / 3
            sel = (ang >= lo) & (ang < lo + np.pi / 3)
            out[14 + b] = d[sel].mean() / rmax if sel.any() else 0.0
    return out


class EffNetExtractor:
    """EfficientNet-B0 crop features on ``device`` (``cuda`` unless the
    CPU is asked for), float32. Weights: ``state_dict``, else the
    ``.npz`` at ``weights_path`` (the JAX package's ``save_params``
    format, read by ``load_params``), else random from seed 0."""

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 weights_path: Optional[str] = None,
                 cfg: Optional[EffNetConfig] = None, image_size: int = 224,
                 device: Optional[str] = None) -> None:
        self.cfg = cfg or effnet_b0()
        self.image_size = image_size
        self.device = resolve_device(device)
        model = init_effnet(self.cfg, seed=0)
        if state_dict is None and weights_path:
            state_dict = load_params(weights_path)
            logger.info("EfficientNet weights loaded from %s", weights_path)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device, self.cfg.torch_dtype).eval()

    @torch.inference_mode()
    def embed_crops(self, crops: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 crops (any sizes) → L2-normalized [N, D] features: each
        resized to the model square by cv2 (bilinear), one forward."""
        import cv2

        s = self.image_size
        sized = np.stack([cv2.resize(c, (s, s)) for c in crops])
        x = torch.from_numpy(sized).to(self.device)
        return self.model(imagenet_preprocess(x, size=s)).cpu().numpy()


_EFFNET_CACHE: Dict[Tuple[str, str], EffNetExtractor] = {}


def get_effnet_extractor(device: Optional[str] = None
                         ) -> Optional[EffNetExtractor]:
    """The process-wide extractor for ``settings.FEATURE_EXTRACTOR_WEIGHTS``
    on ``device``, or None when no weights are configured: services are
    built per request on some paths, and each would reload the file."""
    path = settings.FEATURE_EXTRACTOR_WEIGHTS
    if not path:
        return None
    key = (path, str(resolve_device(device)))
    if key not in _EFFNET_CACHE:
        _EFFNET_CACHE[key] = EffNetExtractor(weights_path=path,
                                             device=key[1])
    return _EFFNET_CACHE[key]


class BackgroundIndependentService:
    def __init__(self, engine: ClipEngine,
                 reader: Optional[VideoReader] = None,
                 detector=None,
                 effnet: Optional[EffNetExtractor] = None) -> None:
        self.engine = engine
        self.reader = reader or VideoReader()
        self._detector = detector
        self.effnet = effnet if effnet is not None else \
            get_effnet_extractor(engine.device)

    # ------------------------------------------------------------------
    def extract_features(self, image: np.ndarray, bbox: Sequence[float],
                         removal_strength: float = 0.8
                         ) -> Optional[Dict]:
        """Segment → background-suppressed crop → CLIP (and EfficientNet)
        embedding, colour means and shape descriptor; None where GrabCut
        gives no mask or the crop is empty."""
        import cv2

        mask = grabcut_mask(image, bbox)
        if mask is None:
            return None
        x0, y0, x1, y1 = [int(v) for v in bbox]
        x0, y0 = max(x0, 0), max(y0, 0)
        crop = image[y0:y1, x0:x1].copy()
        crop_mask = mask[y0:y1, x0:x1]
        if crop.size == 0:
            return None
        # the background goes toward one canonical fill (CLIP's mean
        # pixel) by removal_strength, so the same object embeds the same
        # on any background; the fill is ≈ 0 after CLIP normalisation
        fill = np.array([123.0, 117.0, 104.0], np.float32)
        soft = crop.astype(np.float32)
        soft[~crop_mask] = ((1 - removal_strength) * soft[~crop_mask]
                            + removal_strength * fill)
        soft = soft.astype(np.uint8)

        emb = self.engine.embed_images([soft])[0]
        effnet_emb = (self.effnet.embed_crops([soft])[0]
                      if self.effnet is not None else None)
        color_feats = []
        for code in (None, cv2.COLOR_RGB2HSV, cv2.COLOR_RGB2LAB,
                     cv2.COLOR_RGB2YUV):
            conv = soft if code is None else cv2.cvtColor(soft, code)
            masked = conv[crop_mask] if crop_mask.any() else conv.reshape(
                -1, 3)
            color_feats.append(masked.mean(0) / 255.0)
        shape = shape_descriptor(crop_mask)
        out = {"embedding": emb,
               "color": np.concatenate(color_feats),
               "shape": shape,
               "mask_coverage": float(crop_mask.mean())}
        if effnet_emb is not None:
            out["effnet"] = effnet_emb
        return out

    @staticmethod
    def feature_similarity(a: Dict, b: Dict) -> float:
        """Cosines mapped to [0, 1] and fused 0.6 embedding / 0.2 colour /
        0.2 shape; when both sides carry EfficientNet features the
        embedding's 0.6 splits 0.4 CLIP / 0.2 EfficientNet."""
        s_emb = (F.cosine_sim(a["embedding"], b["embedding"]) + 1) / 2
        s_col = (F.cosine_sim(a["color"], b["color"]) + 1) / 2
        s_shp = (F.cosine_sim(a["shape"], b["shape"]) + 1) / 2
        if "effnet" in a and "effnet" in b:
            s_eff = (F.cosine_sim(a["effnet"], b["effnet"]) + 1) / 2
            return float(0.4 * s_emb + 0.2 * s_eff
                         + 0.2 * s_col + 0.2 * s_shp)
        return float(0.6 * s_emb + 0.2 * s_col + 0.2 * s_shp)

    # ------------------------------------------------------------------
    def match_in_video(self, video_path: str, queries: Sequence[str],
                       background_removal_strength: float = 0.8,
                       confidence_threshold: float = 0.3,
                       top_k: int = 15,
                       sample_rate: Optional[int] = None,
                       video_id: Optional[str] = None,
                       detector=None, **_ignored) -> Dict:
        """Text queries → background-independent matches across the
        video: CLIP-grid candidates of 8-frame batches (up to 8 a frame),
        each segmented and re-scored 0.5 detection + 0.5 background-free
        crop ↔ query cosine."""
        t0 = time.time()
        if detector is None:
            if self._detector is None:
                from .universal_detector import UniversalDetector

                self._detector = UniversalDetector(self.engine)
            detector = self._detector
        text = self.engine.embed_texts(list(queries))

        results: List[Dict] = []
        stats = {"candidates": 0, "segmented": 0}
        n_frames = 0
        for fb, ts_batch in self.reader.stream_batches(
                video_path, 8, sample_rate=sample_rate,
                max_frames=min(settings.MAX_FRAMES, 60)):
            dets_per_frame = detector.detect_unlimited_objects(
                fb, list(queries), detection_mode="clip",
                conf_threshold=confidence_threshold * 0.5, adaptive=False)
            for i, dets in enumerate(dets_per_frame):
                for d in dets[:8]:
                    stats["candidates"] += 1
                    feat = self.extract_features(
                        fb[i], d["bbox"],
                        removal_strength=background_removal_strength)
                    if feat is None:
                        continue
                    stats["segmented"] += 1
                    sims = feat["embedding"] @ text.T
                    qi = int(np.argmax(sims))
                    score = float(0.5 * d["confidence"]
                                  + 0.5 * max(sims[qi], 0.0))
                    if score >= confidence_threshold:
                        results.append({
                            "bbox": d["bbox"],
                            "timestamp": float(ts_batch[i]),
                            "frame_index": n_frames + i,
                            "query": queries[qi],
                            "confidence": score,
                            "bg_similarity": float(sims[qi]),
                            "mask_coverage": feat["mask_coverage"],
                            "shape_descriptor":
                                feat["shape"][:5].tolist(),
                            "method": "background_independent",
                        })
            n_frames += len(fb)

        results.sort(key=lambda r: r["confidence"], reverse=True)
        results = results[:top_k]
        return {
            "results": results,
            "total_found": len(results),
            "background_independence_stats": {
                **stats,
                "removal_strength": background_removal_strength,
                "processing_time": time.time() - t0,
            },
            "metadata": {"frames_processed": n_frames},
        }
