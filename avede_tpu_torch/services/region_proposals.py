"""Region proposals for focused small-object scanning (counterpart of
``avede_tpu/services/region_proposals.py``).

Three proposal sources, all on the host through cv2 and numpy as in the
JAX package:

- **saliency**: spectral-residual saliency (numpy FFT);
- **motion**: Farnebäck dense optical flow → thresholded magnitude →
  connected components with motion vectors;
- **edge**: edge-energy blobs of the Sobel magnitude map.

Ranking: type weights, a small-size preference, an aspect penalty, then
a greedy IoU suppression and a temporal-consistency boost against the
recent frames' proposals. The IoU matrices are the port's
``ops/boxes.pairwise_iou`` on CPU tensors: the lists are host-sized.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.boxes import pairwise_iou
from ..utils.config import settings
from ..utils.logging import get_logger

logger = get_logger(__name__)

TYPE_WEIGHTS = {"saliency": 1.0, "motion": 1.2, "edge": 0.8}


def spectral_residual_saliency(gray: np.ndarray) -> np.ndarray:
    """Hou-Zhang spectral residual saliency map in [0, 1]."""
    import cv2

    small = cv2.resize(gray, (64, 64)).astype(np.float64)
    f = np.fft.fft2(small)
    log_amp = np.log(np.abs(f) + 1e-9)
    phase = np.angle(f)
    avg = cv2.blur(log_amp, (3, 3))
    residual = log_amp - avg
    sal = np.abs(np.fft.ifft2(np.exp(residual + 1j * phase))) ** 2
    sal = cv2.GaussianBlur(sal, (9, 9), 2.5)
    sal = (sal - sal.min()) / max(sal.max() - sal.min(), 1e-9)
    return cv2.resize(sal, (gray.shape[1], gray.shape[0]))


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 xyxy [N, 4] × [M, 4] → IoU [N, M] (numpy)."""
    return pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _boxes_from_mask(mask: np.ndarray, kind: str, min_area: int = 16
                     ) -> List[Dict]:
    import cv2

    n, labels, stats, _ = cv2.connectedComponentsWithStats(
        mask.astype(np.uint8))
    out = []
    for i in range(1, n):
        x, y, w, h, area = stats[i]
        if area >= min_area:
            out.append({"bbox": [float(x), float(y),
                                 float(x + w), float(y + h)],
                        "score": float(min(area / 4096.0 + 0.2, 1.0)),
                        "type": kind})
    return out


class RegionProposalService:
    def __init__(self, max_proposals: Optional[int] = None,
                 history: int = 3) -> None:
        self.max_proposals = max_proposals or settings.RPN_MAX_PROPOSALS
        self._history: Deque[List[Dict]] = deque(maxlen=history)
        self._prev_gray: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    def saliency_proposals(self, gray: np.ndarray) -> List[Dict]:
        sal = spectral_residual_saliency(gray)
        thr = sal.mean() + 1.5 * sal.std()
        return _boxes_from_mask(sal > thr, "saliency")

    def motion_proposals(self, gray: np.ndarray) -> List[Dict]:
        import cv2

        if self._prev_gray is None or self._prev_gray.shape != gray.shape:
            return []
        flow = cv2.calcOpticalFlowFarneback(
            self._prev_gray, gray, None, 0.5, 3, 15, 3, 5, 1.2, 0)
        mag = np.linalg.norm(flow, axis=-1)
        thr = np.percentile(mag, 85)
        props = _boxes_from_mask(mag > max(thr, 0.5), "motion")
        for p in props:
            x0, y0, x1, y1 = [int(v) for v in p["bbox"]]
            region = flow[y0:y1, x0:x1]
            if region.size:
                p["motion_vector"] = [float(region[..., 0].mean()),
                                      float(region[..., 1].mean())]
        return props

    def edge_proposals(self, gray: np.ndarray) -> List[Dict]:
        import cv2

        gx = cv2.Sobel(gray, cv2.CV_32F, 1, 0)
        gy = cv2.Sobel(gray, cv2.CV_32F, 0, 1)
        mag = cv2.GaussianBlur(np.sqrt(gx * gx + gy * gy), (5, 5), 0)
        thr = mag.mean() + 2.0 * mag.std()
        return _boxes_from_mask(mag > thr, "edge")

    # ------------------------------------------------------------------
    def generate_proposals(self, frame: np.ndarray) -> List[Dict]:
        import cv2

        gray = (cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
                if frame.ndim == 3 else frame)
        props = (self.saliency_proposals(gray)
                 + self.motion_proposals(gray)
                 + self.edge_proposals(gray))
        self._prev_gray = gray
        props = self._rank(props, frame.shape[:2])
        props = self._nms(props)
        props = self._temporal_boost(props)
        self._history.append(props)
        return props[: self.max_proposals]

    def _rank(self, props: List[Dict], hw: Tuple[int, int]) -> List[Dict]:
        h, w = hw
        for p in props:
            x0, y0, x1, y1 = p["bbox"]
            area_frac = (x1 - x0) * (y1 - y0) / max(h * w, 1)
            size_pref = 1.0 if area_frac < 0.05 else max(
                1.0 - (area_frac - 0.05) * 4, 0.2)   # prefer small
            bw, bh = max(x1 - x0, 1), max(y1 - y0, 1)
            aspect = max(bw / bh, bh / bw)
            aspect_pen = 1.0 if aspect < 3 else 0.7
            p["score"] = float(p["score"] * TYPE_WEIGHTS[p["type"]]
                               * size_pref * aspect_pen)
        return sorted(props, key=lambda p: p["score"], reverse=True)

    def _nms(self, props: List[Dict], iou_thr: float = 0.5) -> List[Dict]:
        if len(props) <= 1:
            return props
        boxes = np.asarray([p["bbox"] for p in props], np.float32)
        iou = _iou(boxes, boxes)
        kept = []
        for i in range(len(props)):
            if all(iou[i, j] <= iou_thr for j in kept):
                kept.append(i)
        return [props[i] for i in kept]

    def _temporal_boost(self, props: List[Dict],
                        iou_thr: float = 0.3) -> List[Dict]:
        """+20% score when a proposal overlaps one from recent frames."""
        past = [p for frame in self._history for p in frame]
        if not past or not props:
            return props
        cur = np.asarray([p["bbox"] for p in props], np.float32)
        old = np.asarray([p["bbox"] for p in past], np.float32)
        iou = _iou(cur, old)
        for i, p in enumerate(props):
            if (iou[i] > iou_thr).any():
                p["score"] = float(min(p["score"] * 1.2, 1.0))
                p["temporally_consistent"] = True
        return sorted(props, key=lambda p: p["score"], reverse=True)

    def reset(self) -> None:
        self._history.clear()
        self._prev_gray = None
