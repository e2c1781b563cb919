"""Fixed-shape non-maximum suppression (counterpart of
``avede_tpu/ops/nms.py``).

Inputs and outputs are padded to ``max_out``; suppressed or empty slots
carry score ``-inf`` and a False validity flag. Greedy NMS is computed
as the fixed point of one vectorised step over the ``[N, N]``
suppression matrix, as in the JAX package: the greedy answer is the
unique solution of ``alive(j) = valid(j) & not any(i < j: alive(i) &
iou(i, j) > thr)``, so iterating the whole recurrence converges to it in
suppression-chain-depth steps (at most N + 1), not N sequential ones.
Every function takes one frame (``[N, 4]``, ``[N]``) or a batch
(``[B, N, 4]``, ``[B, N]``); a batch iterates until every frame has
converged, and a converged frame never changes again.

Orders break ties to the lower index, as ``jnp.argsort`` and
``lax.top_k`` do: every sort here is ``torch.sort(stable=True)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .boxes import pairwise_iou


def _stable_desc(scores: torch.Tensor) -> torch.Tensor:
    """Indices that sort ``scores`` descending, ties to the lower index."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float, max_out: int, presorted: bool = False,
               return_indices: bool = False):
    """Greedy class-agnostic NMS.

    boxes ``[(B,) N, 4]`` xyxy; scores ``[(B,) N]`` (-inf marks padding)
    → (boxes ``[(B,) max_out, 4]``, scores, valid), score-sorted; with
    ``return_indices`` a fourth output gives each kept slot's index into
    the input order (0 on invalid slots). ``presorted=True`` skips the
    input sort (scores already descending)."""
    single = scores.dim() == 1
    if single:
        boxes, scores = boxes[None], scores[None]
    b, n = scores.shape
    if presorted:
        order = torch.arange(n, device=scores.device).expand(b, n)
    else:
        order = _stable_desc(scores)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(b, n, 4))
    scores_s = torch.gather(scores, 1, order)
    upper = torch.ones(n, n, dtype=torch.bool, device=scores.device).triu(1)
    sup = (pairwise_iou(boxes_s, boxes_s) > iou_threshold) & upper
    alive0 = scores_s > float("-inf")
    alive = alive0
    for _ in range(n + 1):
        suppressed = (sup & alive[..., :, None]).any(dim=-2)
        new = alive0 & ~suppressed
        if torch.equal(new, alive):
            break
        alive = new
    kept = torch.where(alive, scores_s, torch.full_like(scores_s,
                                                        float("-inf")))
    k = min(max_out, n)
    top = _stable_desc(kept)[..., :k]
    out_scores = torch.gather(kept, 1, top)
    out_boxes = torch.gather(boxes_s, 1, top[..., None].expand(b, k, 4))
    out_idx = torch.gather(order, 1, top)
    if max_out > n:                 # keep the padded output contract
        pad = max_out - n
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(b, pad, 4)], 1)
        out_scores = torch.cat([out_scores, out_scores.new_full(
            (b, pad), float("-inf"))], 1)
        out_idx = torch.cat([out_idx, out_idx.new_zeros(b, pad)], 1)
    valid = out_scores > float("-inf")
    out = (out_boxes, out_scores, valid)
    if return_indices:
        out = out + (torch.where(valid, out_idx, torch.zeros_like(out_idx)),)
    return tuple(t[0] for t in out) if single else out


def nms_per_class(boxes: torch.Tensor, scores: torch.Tensor,
                  classes: torch.Tensor, iou_threshold: float, max_out: int,
                  presorted: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Per-class NMS by the coordinate-offset trick: each frame's boxes
    move by −lo + c × span, with lo the frame's least coordinate (0 when
    none is negative) and span its coordinate range + 1, so one
    class-agnostic pass suppresses only within a class; the class and
    the coordinates come back from the shift → (boxes, scores, classes,
    valid)."""
    lo = boxes.amin(dim=(-2, -1), keepdim=True).clamp(max=0.0)
    span = boxes.amax(dim=(-2, -1), keepdim=True) - lo + 1.0  # per frame
    shifted = boxes - lo + classes.float()[..., None] * span
    ob, os_, valid = nms_padded(shifted, scores, iou_threshold, max_out,
                                presorted=presorted)
    # a kept box's x0 − lo lies in [0, span), so floor(x0 / span) of the
    # shifted x0 is its class. Boxes with x0 < 0 (YOLO's decoded boxes
    # are not clipped) are why lo is subtracted: the JAX package's
    # nms_per_class shifts by c × (max + 1) alone and returns such a
    # class c >= 1 box as class c − 1 with every coordinate moved. With
    # every coordinate >= 0, lo is 0 and the arithmetic is the JAX
    # package's.
    span_out = span[..., 0]
    cls_out = torch.floor(ob[..., 0] / span_out).clamp(min=0)
    boxes_out = ob - cls_out[..., None] * span + lo
    return boxes_out, os_, cls_out.to(classes.dtype), valid
