"""Person re-identification: detector, features and whole-video search
(counterpart of ``avede_tpu/services/person_detector.py``).

A reference image's person is matched against every person YOLO finds
in the sampled frames of a video by a convex mix of three cues
(``PERSON_FEATURE_WEIGHTS``, default 0.6 face, 0.3 body, 0.1 visual):

- face: a learned identity cue when weights are configured — the
  appearance encoder on the head region (``APPEARANCE_WEIGHTS``) and the
  face encoder on a face box (``FACE_EMBED_WEIGHTS``) found by cv2's
  ``FaceDetectorYN`` (``FACE_MODEL_PATH``) or a one-class YOLO on the
  person crop (``FACE_DETECTOR_WEIGHTS``) — else a 64×64 gray-crop vector
  of a geometric head estimate;
- body: silhouette geometry of a GrabCut mask of the person crop;
- visual: the CLIP embedding of the person crop.

Device work: person YOLO in batches, CLIP crop embeddings
(``extract_object_embeddings`` → ``ClipEngine.embed_images``: flash
attention at L = 50; crops enter the tower through the model's own
patchify-matmul, not the I420 patch embed), the appearance and face
encoders and the face YOLO, all on the engine's device. Host work stays
on the host with cv2, as in the JAX package: lighting normalisation,
GrabCut, resizes, the gray-crop vector, the ONNX face detector.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.video_reader import VideoReader, probe_video
from ..models.appearance import AppearanceEmbedder, face_embed_config
from ..models.yolo import YoloConfig
from ..ops.dedup import FrameDeduper
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger

logger = get_logger(__name__)

# what a weight file that does not fit its model raises at load
_LOAD_ERRORS = (OSError, ValueError, KeyError, RuntimeError)


def fit_fusion_weights(sims: Sequence[Dict[str, float]],
                       labels: Sequence[bool],
                       steps: int = 400, lr: float = 0.5,
                       l2: float = 1e-3,
                       keys: Tuple[str, ...] = ("face", "body",
                                                "visual"),
                       fallback: Optional[Dict[str, float]] = None
                       ) -> Dict[str, float]:
    """Learn the face/body/visual fusion weights from labeled matches:
    logistic regression over the per-cue cosines of scored candidates,
    the coefficients clipped at zero and L1-normalised into the convex
    weights ``similarity()`` takes.

    ``sims``: per-candidate cue cosines under ``keys``; ``labels``:
    whether the candidate really is the queried person. Pass ``("identity",
    "face", "body", "visual")`` to fit the raw cues apart: ``similarity()``
    switches to its 4-way mix when the weights carry an ``identity`` key.
    Degenerate inputs (no rows, one class, or no positively predictive
    cue) return ``fallback`` (default: the settings weights)."""
    fallback = dict(settings.PERSON_FEATURE_WEIGHTS
                    if fallback is None else fallback)
    X = np.array([[float(s.get(k) or 0.0) for k in keys]
                  for s in sims], np.float64)
    y = np.asarray(labels, np.float64)
    if len(X) == 0 or float(y.min()) == float(y.max()):
        return fallback
    mu, sd = X.mean(0), X.std(0) + 1e-6
    xn = (X - mu) / sd
    w = np.zeros(len(keys))
    b = 0.0
    for _ in range(steps):
        p = 1.0 / (1.0 + np.exp(-(xn @ w + b)))
        w -= lr * (xn.T @ (p - y) / len(y) + l2 * w)
        b -= lr * float(np.mean(p - y))
    # back to cosine units; an anti-predictive cue is clipped to zero
    raw = np.maximum(w / sd, 0.0)
    if raw.sum() <= 0:
        return fallback
    raw /= raw.sum()
    return {k: float(v) for k, v in zip(keys, raw)}


@dataclasses.dataclass
class PersonMatch:
    timestamp: float
    frame_index: int
    bbox: List[float]
    similarity: float
    face_similarity: float
    body_similarity: float
    visual_similarity: float
    detection_method: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# lighting normalisation
# ---------------------------------------------------------------------------

def normalize_lighting(image: np.ndarray) -> np.ndarray:
    """Gray-world white balance, CLAHE on L, auto gamma toward mid-gray
    (uint8 RGB in and out)."""
    import cv2

    img = image.astype(np.float32)
    means = img.reshape(-1, 3).mean(0)
    img = np.clip(img * (means.mean() / np.maximum(means, 1e-3)), 0, 255)
    img = img.astype(np.uint8)
    lab = cv2.cvtColor(img, cv2.COLOR_RGB2LAB)
    clahe = cv2.createCLAHE(clipLimit=2.0, tileGridSize=(8, 8))
    lab[..., 0] = clahe.apply(lab[..., 0])
    img = cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)
    mean = max(img.mean() / 255.0, 1e-3)
    gamma = float(np.clip(np.log(0.5) / np.log(mean), 0.5, 2.0))
    lut = (np.power(np.arange(256) / 255.0, gamma) * 255).astype(np.uint8)
    return lut[img]


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------

def face_region(bbox: List[float]) -> List[float]:
    """Head-region estimate inside a person box."""
    x0, y0, x1, y1 = bbox
    h = y1 - y0
    w = x1 - x0
    fh = h / 7.0
    cx = (x0 + x1) / 2
    return [cx - w * 0.25, y0, cx + w * 0.25, y0 + fh * 1.4]


def crop(frame: np.ndarray, bbox: Sequence[float]) -> np.ndarray:
    h, w = frame.shape[:2]
    x0 = int(np.clip(bbox[0], 0, w - 1))
    y0 = int(np.clip(bbox[1], 0, h - 1))
    x1 = int(np.clip(bbox[2], x0 + 1, w))
    y1 = int(np.clip(bbox[3], y0 + 1, h))
    return frame[y0:y1, x0:x1]


def face_feature(face_crop: np.ndarray) -> Optional[np.ndarray]:
    """64×64 gray vector, mean removed, unit norm; None for a crop under
    4 px a side or a flat one."""
    import cv2

    if face_crop.size == 0 or min(face_crop.shape[:2]) < 4:
        return None
    g = cv2.cvtColor(face_crop, cv2.COLOR_RGB2GRAY)
    g = cv2.resize(g, (64, 64)).astype(np.float32).reshape(-1)
    g = g - g.mean()
    n = np.linalg.norm(g)
    return g / n if n > 0 else None


def _silhouette(crop: np.ndarray) -> Optional[np.ndarray]:
    """Bool foreground mask: GrabCut seeded by an inset rect, with a
    distance-from-border-colour fallback. The crop is downscaled to at
    most 96 px high first, which bounds GrabCut's cost."""
    import cv2

    h, w = crop.shape[:2]
    if h < 8 or w < 6:
        return None
    if h > 96:
        crop = cv2.resize(crop, (max(6, int(w * 96 / h)), 96))
        h, w = crop.shape[:2]
    from .background_independent import grabcut_mask

    mask = grabcut_mask(crop, [w * 0.06, h * 0.02, w * 0.94, h * 0.98],
                        iterations=2)
    if mask is not None and 0.05 < mask.mean() < 0.95:
        return mask
    border = np.concatenate([crop[0], crop[-1], crop[:, 0], crop[:, -1]])
    bg = border.reshape(-1, 3).astype(np.float32).mean(0)
    dist = np.linalg.norm(crop.astype(np.float32) - bg, axis=-1)
    fallback = dist > 40.0
    return fallback if fallback.any() else None


def body_feature(person_crop: np.ndarray, bbox: Sequence[float]
                 ) -> np.ndarray:
    """Clothing-colour-invariant silhouette geometry, 17 values: box
    aspect, shoulder/hip and head/shoulder width ratios, torso and leg
    mass, and a 12-bin row-width profile of the GrabCut silhouette. All
    zeros without a silhouette (``_cos`` then drops the cue)."""
    import cv2

    x0, y0, x1, y1 = bbox
    aspect = (y1 - y0) / max(x1 - x0, 1e-3)
    feat = np.zeros(17, np.float32)
    mask = _silhouette(person_crop) if person_crop.size else None
    if mask is None:
        return feat
    feat[0] = min(aspect / 4.0, 1.0)
    h = mask.shape[0]
    widths = mask.mean(axis=1).astype(np.float32)          # [h] in 0..1
    head_w = widths[: max(1, int(0.15 * h))].mean()
    shoulder_w = widths[int(0.10 * h): max(int(0.10 * h) + 1,
                                           int(0.35 * h))].max()
    hip_w = widths[int(0.45 * h): max(int(0.45 * h) + 1,
                                      int(0.65 * h))].mean()
    feat[1] = min(shoulder_w / max(hip_w, 1e-3), 3.0) / 3.0
    feat[2] = min(head_w / max(shoulder_w, 1e-3), 2.0) / 2.0
    split = int(0.55 * h)
    feat[3] = float(mask[:split].mean())                   # torso mass
    feat[4] = float(mask[split:].mean())                   # leg mass
    feat[5:] = cv2.resize(widths.reshape(-1, 1), (1, 12)).reshape(-1)
    return feat


def _cos(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> Optional[float]:
    if a is None or b is None:
        return None
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return None
    return float(np.dot(a, b) / (na * nb))


def _embed_where_ok(embedder, crops: List[np.ndarray]
                    ) -> List[Optional[np.ndarray]]:
    """Embed the crops of at least 4 px a side in one call; None for the
    others."""
    ok = [c.size > 0 and min(c.shape[:2]) >= 4 for c in crops]
    emb = embedder.embed([c for c, k in zip(crops, ok) if k])
    out: List[Optional[np.ndarray]] = []
    j = 0
    for k in ok:
        out.append(emb[j] if k else None)
        j += k
    return out


# ---------------------------------------------------------------------------
# detector
# ---------------------------------------------------------------------------

class PersonDetector:
    """Person boxes and per-person features (face, body, visual) on the
    engine's device. The YOLO, appearance, face-detector and face-
    embedder models may be passed in; by default each is loaded from its
    setting when the file exists (the person YOLO: ``YoloService``'s own
    defaults)."""

    def __init__(self, engine: ClipEngine, yolo=None,
                 appearance=None, face_yolo=None,
                 face_embedder=None,
                 fusion_weights: Optional[Dict[str, float]] = None
                 ) -> None:
        self.engine = engine
        self.device = engine.device
        self.fusion_weights = {
            k: float(v)
            for k, v in (fusion_weights
                         or settings.PERSON_FEATURE_WEIGHTS).items()}
        self._yolo = yolo
        self._yn = self._load_face_yn()
        self.appearance = appearance or self._load_appearance()
        self._face_yolo = face_yolo or self._load_face_detector()
        self.face_embedder = face_embedder or self._load_face_embedder()

    def _load(self, path: Optional[str], what: str, build):
        """``build(state_dict)`` from the ``.npz`` at ``path`` (a
        setting), or None where no file is set or it does not fit."""
        if not (path and Path(path).exists()):
            return None
        from ..models.convert import load_params

        try:
            model = build(load_params(path))
        except _LOAD_ERRORS:
            logger.warning("%s load failed; its fallback is in use", what,
                           exc_info=True)
            return None
        logger.info("%s loaded from %s", what, path)
        return model

    def _load_appearance(self):
        """Re-ID encoder gated on ``APPEARANCE_WEIGHTS``."""
        return self._load(settings.APPEARANCE_WEIGHTS, "Appearance encoder",
                          lambda sd: AppearanceEmbedder(
                              state_dict=sd, device=self.device))

    def _load_face_detector(self):
        """Face-region detector gated on ``FACE_DETECTOR_WEIGHTS``
        (YOLOv8n geometry, 1 class, 64 px, f32)."""
        from .detector import YoloService

        return self._load(settings.FACE_DETECTOR_WEIGHTS, "Face detector",
                          lambda sd: YoloService(
                              cfg=YoloConfig(num_classes=1, scale="n",
                                             img_size=64),
                              state_dict=sd, class_names=["face"],
                              device=self.device))

    def _load_face_embedder(self):
        """Face embedding gated on ``FACE_EMBED_WEIGHTS`` (the appearance
        encoder at the 32 px face geometry)."""
        return self._load(settings.FACE_EMBED_WEIGHTS, "Face embedding",
                          lambda sd: AppearanceEmbedder(
                              face_embed_config(), state_dict=sd,
                              device=self.device))

    @property
    def yolo(self):
        if self._yolo is None:
            from .detector import YoloService

            self._yolo = YoloService(device=self.device)
        return self._yolo

    @staticmethod
    def _load_face_yn():
        """cv2.FaceDetectorYN gated on a configured ONNX model file."""
        path = settings.FACE_MODEL_PATH
        if not (path and Path(path).exists()):
            return None
        import cv2

        if not hasattr(cv2, "FaceDetectorYN"):
            return None
        try:
            return cv2.FaceDetectorYN.create(path, "", (320, 320))
        except cv2.error:
            logger.warning("FaceDetectorYN load failed; geometric face "
                           "fallback in use", exc_info=True)
        return None

    def detect_persons(self, frames: np.ndarray,
                       conf_threshold: float = 0.3
                       ) -> List[List[Dict]]:
        """Batched person detection → per-frame [{bbox, confidence,
        method}]."""
        out = []
        for frame_dets in self.yolo.detect(frames, conf_threshold):
            out.append([{"bbox": d["bbox"], "confidence": d["confidence"],
                         "method": "yolo"}
                        for d in frame_dets if d["class_name"] == "person"])
        return out

    def find_faces(self, frame: np.ndarray,
                   person_bbox: List[float]) -> List[float]:
        return self.find_faces_scored(frame, person_bbox)[0]

    def find_faces_scored(self, frame: np.ndarray,
                          person_bbox: List[float]):
        """``(face_bbox, detector_confidence)``: FaceDetectorYN when an
        ONNX is configured, else the face-region YOLO on the person crop,
        else the geometric head estimate with confidence 0.0 (the fusion
        fades the face cue by it)."""
        if self._yn is not None:
            import cv2

            region = crop(frame, person_bbox)
            if region.size:
                self._yn.setInputSize((region.shape[1], region.shape[0]))
                _, faces = self._yn.detect(
                    cv2.cvtColor(region, cv2.COLOR_RGB2BGR))
                if faces is not None and len(faces):
                    fx, fy, fw, fh = faces[0][:4]
                    score = (float(faces[0][14])
                             if len(faces[0]) > 14 else 1.0)
                    return ([person_bbox[0] + fx, person_bbox[1] + fy,
                             person_bbox[0] + fx + fw,
                             person_bbox[1] + fy + fh],
                            min(max(score, 0.0), 1.0))
        if self._face_yolo is not None:
            region = crop(frame, person_bbox)
            if region.size and min(region.shape[:2]) >= 8:
                dets = self._face_yolo.detect(region[None],
                                              conf_threshold=0.15)[0]
                if dets:
                    best = max(dets, key=lambda d: d["confidence"])
                    fx0, fy0, fx1, fy1 = best["bbox"]
                    x0 = person_bbox[0] + max(fx0, 0.0)
                    y0 = person_bbox[1] + max(fy0, 0.0)
                    return ([x0, y0,
                             person_bbox[0] + fx1,
                             person_bbox[1] + fy1],
                            min(max(float(best["confidence"]), 0.0),
                                1.0))
        return face_region(person_bbox), 0.0

    def extract_features(self, frame: np.ndarray,
                         bboxes: List[List[float]]) -> List[Dict]:
        from ..utils.synthetic import head_crop
        from .detector import extract_object_embeddings

        norm = normalize_lighting(frame)
        visual = extract_object_embeddings(self.engine, norm, bboxes) \
            if bboxes else np.zeros((0, self.engine.cfg.projection_dim))
        # the learned cues embed the RAW frame: gray-world balance shifts
        # skin and hair hues with the scene, and the encoders learned
        # lighting invariance in training
        identity = None
        if self.appearance is not None and bboxes:
            identity = _embed_where_ok(
                self.appearance, [head_crop(frame, b) for b in bboxes])
        face_emb = face_boxes = face_confs = None
        if bboxes:
            scored = [self.find_faces_scored(norm, b) for b in bboxes]
            face_boxes = [s[0] for s in scored]
            face_confs = [s[1] for s in scored]
            if self.face_embedder is not None:
                face_emb = _embed_where_ok(
                    self.face_embedder, [crop(frame, fb)
                                         for fb in face_boxes])
        out = []
        for i, (bbox, vis) in enumerate(zip(bboxes, visual)):
            if face_emb is not None:
                face = face_emb[i]
            elif identity is None:
                # nothing learned: the gray-crop vector of the face box
                face = face_feature(crop(norm, face_boxes[i]))
            else:
                # the identity cue carries the face term alone
                face = None
            out.append({
                "bbox": bbox,
                "identity": identity[i] if identity is not None else None,
                "face": face,
                "face_conf": (face_confs[i] if face_confs is not None
                              else 0.0),
                "body": body_feature(crop(norm, bbox), bbox),
                "visual": vis,
            })
        return out

    def similarity(self, ref: Dict, cand: Dict) -> Dict[str, float]:
        """Convex face/body/visual mix by ``self.fusion_weights``; missing
        cues renormalise the rest.

        The face term fuses the learned identity cues: with both the
        appearance cosine and the face-embedding cosine, the latter is
        weighted by the face detector's confidence (the lesser of
        reference and candidate); a lone cue keeps weight 1. Weights
        with an ``identity`` key select the 4-way mix, where identity and
        face carry their own weights and the face weight is faded by that
        confidence; the reported ``*_similarity`` keys keep the 3-way
        schema (face = the composite term)."""
        id_cos = _cos(ref.get("identity"), cand.get("identity"))
        face_cos = _cos(ref.get("face"), cand.get("face"))
        if id_cos is not None and face_cos is not None:
            w = min(float(ref.get("face_conf") or 0.0),
                    float(cand.get("face_conf") or 0.0))
            face_term = (id_cos + w * face_cos) / (1.0 + w)
        elif id_cos is not None:
            face_term = id_cos
        else:
            face_term = face_cos
        sims = {"face": (float(face_term) if face_term is not None
                         else None),
                "body": _cos(ref.get("body"), cand.get("body")),
                "visual": _cos(ref.get("visual"), cand.get("visual"))}
        reported = {f"{k}_similarity": float(max(v, 0.0))
                    if v is not None else 0.0 for k, v in sims.items()}
        weights = self.fusion_weights
        if "identity" in weights:
            conf = min(float(ref.get("face_conf") or 0.0),
                       float(cand.get("face_conf") or 0.0))
            raw = {"identity": id_cos, "face": face_cos,
                   "body": sims["body"], "visual": sims["visual"]}
            eff = {k: weights.get(k, 0.0) * (conf if k == "face"
                                             else 1.0) for k in raw}
            total = sum(eff[k] for k, v in raw.items() if v is not None)
            combined = (sum(eff[k] * max(v, 0.0)
                            for k, v in raw.items() if v is not None)
                        / total) if total > 0 else 0.0
            return {"similarity": float(combined), **reported}
        total_w = sum(weights.get(k, 0.0)
                      for k, v in sims.items() if v is not None)
        if total_w == 0:
            return {"similarity": 0.0, **{f"{k}_similarity": 0.0
                                          for k in sims}}
        combined = sum(weights.get(k, 0.0) * max(v, 0.0)
                       for k, v in sims.items()
                       if v is not None) / total_w
        return {"similarity": float(combined), **reported}

    def find_person_in_frame(self, frame: np.ndarray, reference: Dict,
                             threshold: Optional[float] = None
                             ) -> List[Dict]:
        """Detections in one frame scored against the reference's
        features, kept at or above the threshold."""
        thr = (settings.PERSON_SIMILARITY_THRESHOLD if threshold is None
               else threshold)
        dets = self.detect_persons(frame[None])[0]
        if not dets:
            return []
        feats = self.extract_features(frame, [d["bbox"] for d in dets])
        out = []
        for d, f in zip(dets, feats):
            sims = self.similarity(reference, f)
            if sims["similarity"] >= thr:
                out.append({**d, **sims})
        return out

    def process_reference(self, image: np.ndarray) -> Dict:
        """Features of the best person region of the reference image.
        Candidates are the whole image and every detection, ranked by a
        person-aspect prior (h/w ≈ 2.2) with the detector's confidence as
        a small tiebreak: a tight person crop keeps the whole image, a
        full scene picks the detected person."""
        h, w = image.shape[:2]

        def aspect_score(b) -> float:
            bw, bh = b[2] - b[0], b[3] - b[1]
            if bw <= 0 or bh <= 0:
                return 0.0
            a = bh / bw
            return 1.0 if 1.6 <= a <= 3.2 else \
                max(0.0, 1.0 - abs(a - 2.2) / 2.2)

        cands = [([0.0, 0.0, float(w), float(h)], 0.0)]
        for d in self.detect_persons(image[None], conf_threshold=0.2)[0]:
            cands.append((d["bbox"], float(d["confidence"])))
        bbox = max(cands,
                   key=lambda c: aspect_score(c[0]) + 0.1 * c[1])[0]
        return self.extract_features(image, [bbox])[0]


# ---------------------------------------------------------------------------
# whole-video search
# ---------------------------------------------------------------------------

class PersonSearchService:
    def __init__(self, engine: ClipEngine,
                 detector: Optional[PersonDetector] = None,
                 reader: Optional[VideoReader] = None) -> None:
        self.engine = engine
        self.detector = detector or PersonDetector(engine)
        self.reader = reader or VideoReader()
        self.stop_event = threading.Event()

    def process_video_for_person(
            self, video_path: str, reference_image: np.ndarray,
            similarity_threshold: Optional[float] = None,
            frame_skip: Optional[int] = None,
            temporal_consistency: bool = True,
            save_annotated_frames: bool = False,
            progress_callback: Optional[Callable[[float], None]] = None,
            batch_size: Optional[int] = None,
            output_dir: Optional[str] = None) -> Dict:
        """Every sampled frame (every ``frame_skip``-th) streamed in
        batches: persons detected per batch, features and similarities
        per frame; near-duplicate frames (``SCAN_DEDUP_EPS``) run once
        per run of duplicates. Then the temporal filter, annotated frames
        and the report."""
        t0 = time.time()
        thr = (settings.PERSON_SIMILARITY_THRESHOLD
               if similarity_threshold is None else similarity_threshold)
        skip = frame_skip or settings.PERSON_FRAME_SKIP
        batch = batch_size or settings.PERSON_BATCH_SIZE
        self.stop_event.clear()

        ref = self.detector.process_reference(reference_image)
        expected = self.reader.expected_sample_count(
            video_path, sample_rate=skip)
        eps = settings.SCAN_DEDUP_EPS
        deduper = FrameDeduper(eps) if eps > 0 else None

        # per unique frame: (above-threshold candidates, any-person flag)
        uniq: List[Tuple[List, bool]] = []
        chunks: List[np.ndarray] = []
        timestamps: List[float] = []
        for raw, ts in self.reader.stream_batches(video_path, batch,
                                                  sample_rate=skip):
            chunks.append(raw)
            timestamps.extend(ts)
            if self.stop_event.is_set():
                logger.info("Person search stopped by request")
                break
            fb = deduper.filter(raw) if deduper is not None else raw
            if len(fb):
                for i, dets in enumerate(self.detector.detect_persons(fb)):
                    entry: List = []
                    if dets:
                        feats = self.detector.extract_features(
                            fb[i], [d["bbox"] for d in dets])
                        for d, f in zip(dets, feats):
                            sims = self.detector.similarity(ref, f)
                            if sims["similarity"] >= thr:
                                entry.append((d, sims))
                    uniq.append((entry, bool(dets)))
            if progress_callback:
                progress_callback(min(len(timestamps)
                                      / max(expected, 1), 1.0))

        matches: List[PersonMatch] = []
        frames_with_persons = 0
        mapping = (deduper.mapping if deduper is not None
                   else list(range(len(timestamps))))
        for fi, m in enumerate(mapping):
            if m >= len(uniq):          # a stop cut the scan short
                break
            entry, has_person = uniq[m]
            if has_person:
                frames_with_persons += 1
            for d, sims in entry:
                matches.append(PersonMatch(
                    timestamp=float(timestamps[fi]),
                    frame_index=fi,
                    bbox=[float(v) for v in d["bbox"]],
                    similarity=sims["similarity"],
                    face_similarity=sims["face_similarity"],
                    body_similarity=sims["body_similarity"],
                    visual_similarity=sims["visual_similarity"],
                    detection_method=d["method"]))

        if temporal_consistency and len(matches) > 2:
            matches = self._temporal_filter(matches)

        annotated: List[str] = []
        if save_annotated_frames and matches:
            frames = (np.concatenate(chunks, axis=0) if len(chunks) > 1
                      else chunks[0])
            annotated = self._save_annotated(frames, matches, output_dir)

        report = self._report(matches, len(timestamps),
                              frames_with_persons, time.time() - t0, thr)
        return {"matches": [m.to_dict() for m in matches],
                "total_found": len(matches),
                "results": [m.to_dict() for m in matches],
                "summary": report,
                "annotated_frames": annotated}

    def stop(self) -> None:
        self.stop_event.set()

    def process_video_segment(self, video_path: str,
                              reference_image: np.ndarray,
                              start_time: float, end_time: float,
                              **kwargs) -> Dict:
        """Person search kept to [start, end] seconds of the video."""
        meta = probe_video(video_path)
        out = self.process_video_for_person(video_path, reference_image,
                                            **kwargs)
        matches = [m for m in out["matches"]
                   if start_time <= m["timestamp"] <= end_time]
        out["matches"] = matches
        out["results"] = matches
        out["total_found"] = len(matches)
        out["summary"]["segment"] = [start_time,
                                     min(end_time, meta.duration)]
        return out

    @staticmethod
    def _temporal_filter(matches: List[PersonMatch]) -> List[PersonMatch]:
        """Keep matches at or above ``PERSON_TEMPORAL_KEEP_RATIO`` of the
        windowed mean similarity (``PERSON_TEMPORAL_WINDOW`` matches)."""
        window = settings.PERSON_TEMPORAL_WINDOW
        ratio = settings.PERSON_TEMPORAL_KEEP_RATIO
        matches = sorted(matches, key=lambda m: m.timestamp)
        sims = np.asarray([m.similarity for m in matches])
        kept = []
        for i, m in enumerate(matches):
            lo = max(i - window // 2, 0)
            hi = min(i + window // 2 + 1, len(matches))
            if m.similarity >= ratio * sims[lo:hi].mean():
                kept.append(m)
        return kept

    @staticmethod
    def _save_annotated(frames: np.ndarray, matches: List[PersonMatch],
                        output_dir: Optional[str]) -> List[str]:
        import cv2

        out_dir = Path(output_dir or settings.FRAME_DIR) / "annotated"
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for m in matches[:50]:
            frame = frames[m.frame_index].copy()
            x0, y0, x1, y1 = [int(v) for v in m.bbox]
            cv2.rectangle(frame, (x0, y0), (x1, y1), (0, 255, 0), 2)
            cv2.putText(frame, f"{m.similarity:.2f}", (x0, max(y0 - 5, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 255, 0), 1)
            p = out_dir / f"match_{m.frame_index:05d}.jpg"
            cv2.imwrite(str(p), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            paths.append(str(p))
        return paths

    @staticmethod
    def _report(matches: List[PersonMatch], n_frames: int,
                frames_with_persons: int, seconds: float,
                threshold: float) -> Dict:
        """Effectiveness report: counts, similarities, presence segments
        (matches more than 3 s apart split a segment), rate."""
        sims = [m.similarity for m in matches]
        segments = []
        if matches:
            ms = sorted(matches, key=lambda m: m.timestamp)
            seg_start = prev = ms[0].timestamp
            for m in ms[1:]:
                if m.timestamp - prev > 3.0:
                    segments.append([seg_start, prev])
                    seg_start = m.timestamp
                prev = m.timestamp
            segments.append([seg_start, prev])
        return {
            "frames_processed": n_frames,
            "frames_with_persons": frames_with_persons,
            "matches_found": len(matches),
            "similarity_threshold": threshold,
            "best_similarity": max(sims, default=0.0),
            "mean_similarity": float(np.mean(sims)) if sims else 0.0,
            "presence_segments": segments,
            "processing_seconds": seconds,
            "fps": n_frames / seconds if seconds > 0 else 0.0,
        }

    def export_results(self, results: Dict, path: str,
                       fmt: str = "json") -> str:
        """Write ``results`` as JSON, or its matches as CSV."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        if fmt == "json":
            p.write_text(json.dumps(results, indent=2))
        elif fmt == "csv":
            import csv

            with p.open("w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(["timestamp", "frame_index", "similarity",
                                 "face_similarity", "body_similarity",
                                 "visual_similarity", "bbox"])
                for m in results.get("matches", []):
                    writer.writerow([m["timestamp"], m["frame_index"],
                                     m["similarity"], m["face_similarity"],
                                     m["body_similarity"],
                                     m["visual_similarity"], m["bbox"]])
        else:
            raise ValueError(f"unknown export format {fmt}")
        return str(p)
