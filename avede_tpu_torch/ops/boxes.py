"""Box utilities on tensors (counterpart of ``avede_tpu/ops/boxes.py``).

Boxes are ``[..., 4]`` xyxy float32 unless noted; every function keeps
the leading dimensions.
"""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[..., N, 4]`` × ``[..., M, 4]`` → ``[..., N, M]`` IoU."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def clip_boxes(boxes: torch.Tensor, w: float, h: float) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0.0, w),
                        boxes[..., 1].clamp(0.0, h),
                        boxes[..., 2].clamp(0.0, w),
                        boxes[..., 3].clamp(0.0, h)], -1)
