"""OWL-ViT detection training (counterpart of
``avede_tpu/parallel/train_owl.py``): per-patch assignment, BCE + box
L1 + IoU, on one device.

Loss (statically shaped, anchor-free FCOS-style assignment):

- assignment: every patch whose grid centre lies INSIDE a ground-truth
  box is positive for that box (the nearest-centre box wins where boxes
  overlap; each box's nearest patch is forced positive, so boxes smaller
  than a grid cell still train; a patch with no candidate takes box 0,
  as ``argmin`` over all-``inf`` does in JAX and torch);
- classification: BCE on the per-patch per-query logits with an FCOS
  centerness target normalised per box (its best patch trains to 1,
  off-centre duplicates lower, at least 0.25), positives weighted by
  ``POS_WEIGHT``;
- box: L1 on the positive patches' cxcywh in normalised coordinates,
  plus ``1 − IoU``, weighted by ``BOX_WEIGHT``.

Query ids are fixed class-name token ids: the text tower learns to embed
each name, so serving routes the same names through the text tower.
Training needs ``use_flash=False`` (plain attention: the hand-written
kernel has no backward); serving turns flash on.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.owlvit import OwlViTConfig, OwlViTDetector, init_owlvit
from ..ops.preprocess import clip_preprocess
from .optim import LearningRate, adam
from .train import (Metrics, TrainState, _apply, _f32_convs, _no_mesh,
                    _on_device, _refuse_flash)
from .train_det import sigmoid_binary_cross_entropy

POS_WEIGHT = 30.0
BOX_WEIGHT = 5.0


def owl_detection_loss(logits: torch.Tensor, pboxes: torch.Tensor,
                       cfg: OwlViTConfig, gt_boxes: torch.Tensor,
                       gt_labels: torch.Tensor, gt_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, Metrics]:
    """logits ``[B, P, Q]`` · pboxes ``[B, P, 4]`` cxcywh in [0, 1] ·
    gt_boxes ``[B, M, 4]`` xyxy normalised · gt_labels ``[B, M]`` query
    index · gt_mask ``[B, M]`` → (loss, {"cls", "box"})."""
    g, dev = cfg.grid, logits.device
    p_idx = torch.arange(g * g, device=dev)
    pcx = ((p_idx % g).float() + 0.5)[None, :, None] / g       # [1, P, 1]
    pcy = ((p_idx // g).float() + 0.5)[None, :, None] / g
    gb = gt_boxes.float()
    gm = gt_mask.bool()[:, None, :]                            # [B, 1, M]
    x0, y0 = gb[:, None, :, 0], gb[:, None, :, 1]              # [B, 1, M]
    x1, y1 = gb[:, None, :, 2], gb[:, None, :, 3]

    gcx = (gb[..., 0] + gb[..., 2]) / 2                        # [B, M]
    gcy = (gb[..., 1] + gb[..., 3]) / 2
    d2 = (pcx - gcx[:, None]) ** 2 + (pcy - gcy[:, None]) ** 2  # [B, P, M]
    inside = (pcx > x0) & (pcx < x1) & (pcy > y0) & (pcy < y1) & gm
    # each box's nearest patch is always positive
    nearest = d2.argmin(1)                                     # [B, M]
    forced = (p_idx[None, :, None] == nearest[:, None, :]) & gm
    cand = inside | forced
    pos = cand.any(-1)                                         # [B, P]
    best_m = torch.where(cand, d2, torch.full_like(d2, float("inf"))
                         ).argmin(-1)                          # [B, P]

    # FCOS centerness per (patch, box), normalised per box
    l_ = (pcx - x0).clamp(min=1e-6)
    r_ = (x1 - pcx).clamp(min=1e-6)
    t_ = (pcy - y0).clamp(min=1e-6)
    b_ = (y1 - pcy).clamp(min=1e-6)
    ctr = torch.sqrt((torch.minimum(l_, r_) / torch.maximum(l_, r_))
                     * (torch.minimum(t_, b_) / torch.maximum(t_, b_)))
    ctr = torch.where(cand, ctr, torch.zeros_like(ctr))
    ctr = ctr / ctr.amax(1, keepdim=True).clamp(min=1e-6)
    quality = ctr.gather(-1, best_m[..., None])[..., 0] * pos
    quality = torch.where(pos, quality.clamp(min=0.25),
                          torch.zeros_like(quality))

    tgt = (F.one_hot(gt_labels.long().gather(1, best_m), logits.shape[-1])
           * quality[..., None]).to(logits.dtype)
    bce = sigmoid_binary_cross_entropy(logits, tgt)
    w = torch.where(tgt > 0, torch.full_like(tgt, POS_WEIGHT),
                    torch.ones_like(tgt))
    cls_l = (bce * w).sum((1, 2)) / w.sum((1, 2))

    idx = best_m[..., None].expand(*best_m.shape, 4)
    tbox = torch.stack([gcx, gcy, gb[..., 2] - gb[..., 0],
                        gb[..., 3] - gb[..., 1]], -1).gather(1, idx)
    l1 = (pboxes - tbox).abs().sum(-1)                         # [B, P]
    # direct IoU term: L1 alone leaves a bias toward the patch centre
    # that lets duplicate boxes slip under the NMS threshold
    px0 = pboxes[..., 0] - pboxes[..., 2] / 2
    py0 = pboxes[..., 1] - pboxes[..., 3] / 2
    px1 = pboxes[..., 0] + pboxes[..., 2] / 2
    py1 = pboxes[..., 1] + pboxes[..., 3] / 2
    tb = gb.gather(1, idx)
    ix = (torch.minimum(px1, tb[..., 2])
          - torch.maximum(px0, tb[..., 0])).clamp(min=0)
    iy = (torch.minimum(py1, tb[..., 3])
          - torch.maximum(py0, tb[..., 1])).clamp(min=0)
    inter = ix * iy
    union = ((px1 - px0).clamp(min=0) * (py1 - py0).clamp(min=0)
             + (tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1]) - inter)
    iou = inter / union.clamp(min=1e-9)
    posf = pos.float()
    npos = posf.sum(-1).clamp(min=1.0)
    box_l = ((l1 + (1.0 - iou)) * posf).sum(-1) / npos
    loss = cls_l.mean() + BOX_WEIGHT * box_l.mean()
    return loss, {"cls": cls_l.mean().detach(), "box": box_l.mean().detach()}


def create_owl_train_state(cfg: Optional[OwlViTConfig] = None,
                           learning_rate: LearningRate = 1e-3,
                           seed: int = 0, device=None
                           ) -> Tuple[OwlViTDetector, TrainState]:
    """OWL-ViT from ``seed`` on ``device`` in the config's dtype (which
    must have ``use_flash=False``), with ``clip_by_global_norm(5.0)`` and
    ``adam(learning_rate)``; ``learning_rate`` may be a schedule."""
    cfg = cfg or OwlViTConfig()
    _refuse_flash(cfg)
    model = _on_device(lambda: init_owlvit(cfg, seed=seed), cfg, device)
    return model, TrainState(model, adam(model.parameters(), learning_rate,
                                         clip_norm=5.0))


def make_owl_train_step(model: OwlViTDetector, query_ids, mesh=None
                        ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, frames_u8, gt_boxes, gt_labels, gt_mask) → (state,
    {"loss", "cls", "box", "grad_norm"})``: uint8 frames ``[B, H, W, 3]``
    preprocessed as the serving path does (``clip_preprocess``: central
    square, CLIP normalisation), the ground truth as
    :func:`owl_detection_loss` takes it. ``query_ids`` ``[Q, L]`` are the
    fixed class-name token ids (the label space)."""
    _no_mesh(mesh)
    _refuse_flash(model.cfg)
    cfg = model.cfg
    ids = torch.as_tensor(query_ids,
                          device=next(model.parameters()).device)

    def step(state: TrainState, frames_u8, gt_boxes, gt_labels, gt_mask
             ) -> Tuple[TrainState, Metrics]:
        px = clip_preprocess(frames_u8, size=cfg.image_size)
        logits, pboxes = state.module(px, ids)
        loss, parts = owl_detection_loss(logits, pboxes, cfg, gt_boxes,
                                         gt_labels, gt_mask)
        norm = _apply(state, loss)
        return state, {"loss": loss.detach(), **parts, "grad_norm": norm}

    return _f32_convs(step)
