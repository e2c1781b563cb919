"""Synthetic people for person search (counterpart of the person half
of ``avede_tpu/utils/synthetic.py``).

``draw_person`` draws a procedural person whose IDENTITY features (skin
tone, hair colour and shape, eye spacing, build) are fixed per identity
while nuisance (background, clothing colour, lighting, position) varies
per view; ``draw_people`` composites several identities into one crowd
frame. The tests and ``chip_smoke.py`` make person videos with them, and
``head_crop`` is the head geometry the appearance encoder embeds. The
same numpy draws in the same order as the JAX package's, so one seed
gives the same pixels in both.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


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
