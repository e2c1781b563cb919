"""Synthetic ground truth (counterpart of ``avede_tpu/utils/synthetic.py``).

- ``draw_shape_scene`` — frames with 1..K coloured shapes and their
  boxes (the detector trainers and the ``detection`` / ``detection4k``
  eval modes);
- ``draw_person`` / ``draw_people`` — a procedural person whose IDENTITY
  features (skin tone, hair colour and shape, eye spacing, build) are
  fixed per identity while nuisance (background, clothing colour,
  lighting, position) varies per view, alone or in a crowd frame;
  ``head_crop`` is the head geometry the appearance encoder embeds;
- ``identity_batch``, ``face_detector_scene``, ``face_batch`` — the
  training views of the ``person`` eval mode's re-id encoder, face-region
  detector and face embedder.

The same numpy draws in the same order as the JAX package's, so one seed
gives the same pixels (and JPEG round trips) in both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

SHAPE_CLASSES = ["square", "circle", "triangle", "stripe"]
SHAPE_COLORS = [(220, 40, 40), (40, 200, 60), (50, 80, 220),
                (230, 220, 40)]


def draw_shape_scene(rng: np.random.Generator, size: int = 64,
                     max_boxes: int = 3,
                     min_r: int = 5, max_r: int = 11,
                     hw: Optional[Tuple[int, int]] = None,
                     non_overlapping: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """→ (img uint8 [H,W,3], boxes [M,4] xyxy, labels [M], mask [M]).

    ``hw`` gives rectangular frames (e.g. 4K 2160×3840 for the tiled
    small-object benchmark); ``non_overlapping`` rejects placements
    whose boxes intersect an earlier one — overlap-free ground truth
    keeps detection-assignment and greedy matching well-posed."""
    import cv2

    H, W = hw if hw is not None else (size, size)
    img = rng.integers(20, 60, (H, W, 3)).astype(np.uint8)
    n = int(rng.integers(1, max_boxes + 1))
    boxes = np.zeros((max_boxes, 4), np.float32)
    labels = np.zeros((max_boxes,), np.int32)
    mask = np.zeros((max_boxes,), bool)
    placed = 0
    for _ in range(n * 8 if non_overlapping else n):
        if placed >= n:
            break
        r = int(rng.integers(min_r, max_r))
        cx = int(rng.integers(r + 2, W - r - 2))
        cy = int(rng.integers(r + 2, H - r - 2))
        box = (cx - r, cy - r, cx + r, cy + r)
        if non_overlapping and any(
                box[0] < boxes[j][2] and boxes[j][0] < box[2]
                and box[1] < boxes[j][3] and boxes[j][1] < box[3]
                for j in range(placed)):
            continue
        cls = int(rng.integers(0, len(SHAPE_CLASSES)))
        color = SHAPE_COLORS[cls]
        if cls == 0:
            cv2.rectangle(img, (cx - r, cy - r), (cx + r, cy + r),
                          color, -1)
        elif cls == 1:
            cv2.circle(img, (cx, cy), r, color, -1)
        elif cls == 2:
            pts = np.array([[cx, cy - r], [cx - r, cy + r],
                            [cx + r, cy + r]])
            cv2.fillPoly(img, [pts], color)
        else:
            stripe_h = max(3, r // 3)
            cv2.rectangle(img, (cx - r, cy - stripe_h),
                          (cx + r, cy + stripe_h), color, -1)
            box = (cx - r, cy - stripe_h, cx + r, cy + stripe_h)
        boxes[placed] = box
        labels[placed] = cls
        mask[placed] = True
        placed += 1
    return img, boxes, labels, mask


def make_identity(rng: np.random.Generator) -> Dict:
    """Identity-defining parameters (held fixed across views)."""
    return {
        "skin": tuple(int(v) for v in
                      (rng.integers(160, 230), rng.integers(120, 190),
                       rng.integers(90, 160))),
        "hair": tuple(int(v) for v in rng.integers(10, 120, 3)),
        "hair_h": float(rng.uniform(0.18, 0.42)),   # fringe depth
        "eye_dx": float(rng.uniform(0.16, 0.30)),   # eye spacing
        "head_aspect": float(rng.uniform(0.75, 1.0)),
        "build": float(rng.uniform(0.5, 0.95)),     # shoulder width frac
    }


def with_outfit(identity: Dict, rng: np.random.Generator) -> Dict:
    """Identity + a fixed outfit (torso/leg clothing colors): within a
    single video a person keeps their clothes, so per-video evals wrap
    identities with this to make body appearance signal rather than
    per-frame noise. Training views (``identity_batch``) keep clothing
    random so the learned embedding stays outfit-invariant."""
    out = dict(identity)
    out["clothing"] = tuple(int(v) for v in rng.integers(30, 230, 3))
    out["legc"] = tuple(int(v) for v in rng.integers(30, 230, 3))
    return out


def draw_person(identity: Dict, rng: np.random.Generator,
                frame_hw: Tuple[int, int] = (128, 128),
                center: Optional[Tuple[int, int]] = None,
                person_h: Optional[int] = None,
                parts: Optional[Dict] = None
                ) -> Tuple[np.ndarray, List[float]]:
    """One VIEW of an identity → (frame uint8 [H,W,3], person bbox).

    Nuisance per view: background texture/level, clothing color,
    brightness, position, scale jitter. ``parts`` (optional dict) is
    filled with ground-truth part boxes (``face``).
    """
    import cv2

    H, W = frame_hw
    bg_level = int(rng.integers(30, 160))
    frame = np.clip(bg_level
                    + rng.integers(-25, 25, (H, W, 3)), 0, 255
                    ).astype(np.uint8)
    ph = person_h or int(rng.integers(int(H * 0.55), int(H * 0.8)))
    pw = int(ph * 0.45)
    cx = (center[0] if center
          else int(rng.integers(pw // 2 + 2, W - pw // 2 - 2)))
    cy = (center[1] if center
          else int(rng.integers(ph // 2 + 2, H - ph // 2 - 2)))
    bbox = _draw_person_into(frame, identity, rng, (cx, cy), ph,
                             parts=parts)

    # lighting nuisance: global gain
    gain = float(rng.uniform(0.7, 1.3))
    frame = np.clip(frame.astype(np.float32) * gain, 0, 255
                    ).astype(np.uint8)
    return frame, bbox


def _draw_person_into(frame: np.ndarray, identity: Dict,
                      rng: np.random.Generator,
                      center: Tuple[int, int], ph: int,
                      parts: Optional[Dict] = None) -> List[float]:
    """Composite one identity view into an existing frame → bbox.
    With ``parts`` (a dict), also records ground-truth part boxes —
    ``parts["face"]`` is the head-ellipse bbox, the training target for
    the learned face-region detector (the role cv2.FaceDetectorYN's
    ONNX plays when one is configured)."""
    import cv2

    cx, cy = center
    pw = int(ph * 0.45)
    x0, y0 = cx - pw // 2, cy - ph // 2
    x1, y1 = x0 + pw, y0 + ph

    head_h = int(ph * 0.22)
    head_w = int(head_h * identity["head_aspect"])
    hx, hy = cx, y0 + head_h // 2
    if parts is not None:
        parts["face"] = [float(hx - head_w / 2), float(hy - head_h / 2),
                         float(hx + head_w / 2), float(hy + head_h / 2)]
    clothing = identity.get("clothing") \
        or tuple(int(v) for v in rng.integers(30, 230, 3))

    # torso (clothing — nuisance)
    tw = int(pw * identity["build"])
    cv2.rectangle(frame, (cx - tw // 2, y0 + head_h),
                  (cx + tw // 2, y1 - int(ph * 0.3)), clothing, -1)
    # legs (clothing 2)
    legc = identity.get("legc") \
        or tuple(int(v) for v in rng.integers(30, 230, 3))
    cv2.rectangle(frame, (cx - tw // 3, y1 - int(ph * 0.3)),
                  (cx + tw // 3, y1), legc, -1)
    # head (identity: skin, aspect)
    cv2.ellipse(frame, (hx, hy), (head_w // 2, head_h // 2), 0, 0, 360,
                identity["skin"], -1)
    # hair (identity: color, fringe depth)
    fh = int(head_h * identity["hair_h"])
    cv2.ellipse(frame, (hx, hy - head_h // 2 + fh // 2),
                (head_w // 2, max(fh // 2, 1)), 0, 180, 360,
                identity["hair"], -1)
    # eyes (identity: spacing)
    ex = int(head_w * identity["eye_dx"])
    for sx in (-ex, ex):
        cv2.circle(frame, (hx + sx, hy), max(head_h // 12, 1),
                   (20, 20, 20), -1)
    return [float(x0), float(y0), float(x1), float(y1)]


def draw_people(identities: List[Dict], rng: np.random.Generator,
                frame_hw: Tuple[int, int] = (128, 128),
                person_h_range: Tuple[int, int] = (60, 90)
                ) -> Tuple[np.ndarray, List[List[float]]]:
    """One CROWD frame: every identity composited at a non-overlapping
    position (a crowded surveillance-style scene). Shared background + shared
    lighting gain; clothing still varies per person per frame.

    → (frame uint8 [H, W, 3], bboxes aligned with ``identities``)."""
    import cv2  # noqa: F401 — _draw_person_into needs it imported

    H, W = frame_hw
    bg_level = int(rng.integers(30, 160))
    frame = np.clip(bg_level
                    + rng.integers(-25, 25, (H, W, 3)), 0, 255
                    ).astype(np.uint8)
    bboxes: List[List[float]] = []
    occupied: List[Tuple[int, int, int, int]] = []
    for ident in identities:
        for _ in range(40):
            ph = int(rng.integers(*person_h_range))
            pw = int(ph * 0.45)
            cx = int(rng.integers(pw // 2 + 2, W - pw // 2 - 2))
            cy = int(rng.integers(ph // 2 + 2, H - ph // 2 - 2))
            box = (cx - pw // 2, cy - ph // 2,
                   cx + pw // 2, cy + ph // 2)
            if not any(box[0] < o[2] and o[0] < box[2]
                       and box[1] < o[3] and o[1] < box[3]
                       for o in occupied):
                break
        occupied.append(box)
        bboxes.append(_draw_person_into(frame, ident, rng, (cx, cy),
                                        ph))
    gain = float(rng.uniform(0.7, 1.3))
    frame = np.clip(frame.astype(np.float32) * gain, 0, 255
                    ).astype(np.uint8)
    return frame, bboxes


def head_crop(frame: np.ndarray, bbox: List[float]) -> np.ndarray:
    """Head region of a person box (top ~28%, horizontally centered) —
    where identity lives; clothing (nuisance) is excluded. Mirrors
    ``services/person_detector.face_region`` geometry."""
    x0, y0, x1, y1 = bbox
    h = y1 - y0
    w = x1 - x0
    cx = (x0 + x1) / 2
    r = [cx - w * 0.3, y0, cx + w * 0.3, y0 + h * 0.28]
    xi0 = int(np.clip(r[0], 0, frame.shape[1] - 2))
    yi0 = int(np.clip(r[1], 0, frame.shape[0] - 2))
    xi1 = int(np.clip(r[2], xi0 + 1, frame.shape[1]))
    yi1 = int(np.clip(r[3], yi0 + 1, frame.shape[0]))
    return frame[yi0:yi1, xi0:xi1]


def jitter_bbox(bbox: List[float], rng: np.random.Generator,
                frac: float = 0.08) -> List[float]:
    """Perturb each box edge by N(0, frac)·(w|h) — the noise profile of
    a real detector box (the trained 128-px person detector lands at
    mean IoU ≈0.86, i.e. edges off by 5-10% of the box dims)."""
    x0, y0, x1, y1 = bbox
    w, h = x1 - x0, y1 - y0
    dx0, dy0, dx1, dy1 = rng.normal(0.0, frac, 4)
    return [x0 + dx0 * w, y0 + dy0 * h, x1 + dx1 * w, y1 + dy1 * h]


def identity_batch(identities: List[Dict], rng: np.random.Generator,
                   crop_size: int = 64, codec_aug: bool = True,
                   box_jitter: float = 0.08
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Two aligned augmented HEAD-crop views per identity → (a, b)
    float [B, S, S, 3] in [0,1] for NT-Xent training. Head crops, not
    whole-person: clothing varies per view by design, so whole-person
    positives would look more different than negatives and the
    embedding collapses.

    ``codec_aug`` JPEG-round-trips half the crops at quality 35-90:
    deployed frames arrive through a lossy video codec, and an encoder
    trained only on clean renders keys on high-frequency detail the
    codec destroys.

    ``box_jitter`` perturbs the person box before the head crop is
    taken: at search time head crops come from DETECTOR boxes, not
    ground truth, so the encoder must tolerate the detector's edge
    noise (≈8% of box dims at IoU 0.86) or identity similarity
    collapses on exactly the boxes the service produces."""
    import cv2

    views = []
    for _ in range(2):
        crops = []
        for ident in identities:
            frame, bbox = draw_person(ident, rng)
            if box_jitter > 0:
                bbox = jitter_bbox(bbox, rng, box_jitter)
            crop = head_crop(frame, bbox)
            crop = cv2.resize(crop, (crop_size, crop_size),
                              interpolation=cv2.INTER_AREA)
            if codec_aug and rng.random() < 0.5:
                q = int(rng.integers(35, 90))
                _, enc = cv2.imencode(
                    ".jpg", crop, [cv2.IMWRITE_JPEG_QUALITY, q])
                crop = cv2.imdecode(enc, cv2.IMREAD_COLOR)
            crops.append(crop)
        views.append(np.stack(crops).astype(np.float32) / 255.0)
    return views[0], views[1]


def crop_bbox(frame: np.ndarray, bbox: List[float]) -> np.ndarray:
    """Clamped integer crop of a float bbox."""
    x0 = int(np.clip(bbox[0], 0, frame.shape[1] - 2))
    y0 = int(np.clip(bbox[1], 0, frame.shape[0] - 2))
    x1 = int(np.clip(bbox[2], x0 + 1, frame.shape[1]))
    y1 = int(np.clip(bbox[3], y0 + 1, frame.shape[0]))
    return frame[y0:y1, x0:x1]


def face_detector_scene(rng: np.random.Generator, size: int = 64
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """One training scene for the learned face-REGION detector: a
    person crop (slightly jittered, as the serving path sees detector
    person boxes) resized to ``size``, with the ground-truth face box
    mapped into crop coordinates. YOLO-style (img, boxes[1,4],
    labels[1], mask[1]) so ``_train_tiny_yolo`` machinery is reused
    unchanged. Mirrors how ``PersonDetector.find_faces`` applies the
    detector: on the person region, not the whole frame."""
    import cv2

    parts: Dict = {}
    ident = make_identity(rng)
    frame, bbox = draw_person(ident, rng, frame_hw=(128, 128),
                              parts=parts)
    pb = jitter_bbox(bbox, rng, 0.06)
    x0 = int(np.clip(pb[0], 0, frame.shape[1] - 2))
    y0 = int(np.clip(pb[1], 0, frame.shape[0] - 2))
    x1 = int(np.clip(pb[2], x0 + 1, frame.shape[1]))
    y1 = int(np.clip(pb[3], y0 + 1, frame.shape[0]))
    region = frame[y0:y1, x0:x1]
    sy = size / region.shape[0]
    sx = size / region.shape[1]
    img = cv2.resize(region, (size, size),
                     interpolation=cv2.INTER_AREA)
    fb = parts["face"]
    face = np.array([(fb[0] - x0) * sx, (fb[1] - y0) * sy,
                     (fb[2] - x0) * sx, (fb[3] - y0) * sy], np.float32)
    face = np.clip(face, 0, size - 1)
    boxes = face[None]
    mask = np.array([face[2] > face[0] + 1 and face[3] > face[1] + 1])
    return img, boxes, np.zeros((1,), np.int32), mask


def face_batch(identities: List[Dict], rng: np.random.Generator,
               crop_size: int = 32, codec_aug: bool = True,
               box_jitter: float = 0.10
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Two aligned augmented FACE-crop views per identity → (a, b)
    float [B, S, S, 3] in [0,1] for NT-Xent training of the face
    embedding. Same augmentation rationale as ``identity_batch`` (codec
    round-trips, box jitter matching the face detector's edge noise),
    but crops the ground-truth FACE box — skin tone, head aspect, eye
    spacing and fringe line are the identity signal; torso clothing
    never enters the crop."""
    import cv2

    views = []
    for _ in range(2):
        crops = []
        for ident in identities:
            parts: Dict = {}
            frame, _ = draw_person(ident, rng, parts=parts)
            fb = parts["face"]
            if box_jitter > 0:
                fb = jitter_bbox(fb, rng, box_jitter)
            crop = crop_bbox(frame, fb)
            crop = cv2.resize(crop, (crop_size, crop_size),
                              interpolation=cv2.INTER_AREA)
            if codec_aug and rng.random() < 0.5:
                q = int(rng.integers(35, 90))
                _, enc = cv2.imencode(
                    ".jpg", crop, [cv2.IMWRITE_JPEG_QUALITY, q])
                crop = cv2.imdecode(enc, cv2.IMREAD_COLOR)
            crops.append(crop)
        views.append(np.stack(crops).astype(np.float32) / 255.0)
    return views[0], views[1]
