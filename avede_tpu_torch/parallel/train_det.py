"""YOLO detection training (counterpart of
``avede_tpu/parallel/train_det.py``): a simplified task-aligned
assignment, Distribution Focal Loss + IoU + BCE, on one device.

Loss (YOLOv8-style, statically shaped; ground truth padded to a fixed
``max_boxes`` per image, ``gt_mask`` marking the real rows):

- assignment: an anchor is positive when its centre lies inside a
  ground-truth box; among several, the highest-IoU box wins (an all-zero
  IoU row takes box 0, as ``argmax`` does in numpy, JAX and torch);
- classification: BCE on sigmoid logits, target the IoU of the anchor's
  predicted box with its box (quality focal style) at the box's class.
  The JAX package does not stop that target's gradient, so here too it
  reaches the predicted boxes through the target: the BCE is written out
  (``-t·log σ(x) − (1 − t)·log σ(−x)``, optax's
  ``sigmoid_binary_cross_entropy``) rather than taken from
  ``F.binary_cross_entropy_with_logits``;
- box: DFL on the two bins beside the true ltrb distance, plus
  ``1 − IoU`` of the expected box.

BatchNorm stays frozen, as in the JAX package: its ``ConvBN`` normalises
with the running statistics in training too and the step applies no
``mutable`` collection, so only BatchNorm's scale and bias train. The
port's ``FrozenBatchNorm`` keeps its statistics as buffers, which no step
changes.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.yolo import YoloConfig, YoloV8, init_yolo
from ..ops.boxes import pairwise_iou
from .optim import LearningRate, adam
from .train import (Metrics, TrainState, _apply, _f32_convs, _no_mesh,
                    _on_device)


def _level_anchors(cfg: YoloConfig, strides: Sequence[int] = (8, 16, 32),
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor centres (px) ``[A, 2]`` and each anchor's stride ``[A]``
    for every head cell, level by level, row-major."""
    centers, strs = [], []
    for s in strides:
        g = cfg.img_size // s
        ar = torch.arange(g, dtype=torch.float32, device=device) + 0.5
        ys, xs = torch.meshgrid(ar, ar, indexing="ij")
        centers.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1) * s)
        strs.append(torch.full((g * g,), float(s), device=device))
    return torch.cat(centers), torch.cat(strs)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                                 ) -> torch.Tensor:
    """optax's elementwise ``-t·log σ(x) − (1 − t)·log σ(−x)``; the
    gradient reaches ``labels`` too."""
    return -labels * F.logsigmoid(logits) \
        - (1.0 - labels) * F.logsigmoid(-logits)


def yolo_detection_loss(outs, cfg: YoloConfig, gt_boxes: torch.Tensor,
                        gt_labels: torch.Tensor, gt_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, Metrics]:
    """outs: the per-level raw head outputs of ``YoloV8.forward``.
    gt_boxes ``[B, M, 4]`` xyxy px · gt_labels ``[B, M]`` int ·
    gt_mask ``[B, M]`` bool → (loss, {"cls", "dfl", "iou"})."""
    dev = outs[0][0].device
    anchors, strides = _level_anchors(cfg, device=dev)      # [A,2], [A]
    box_logits = torch.cat(
        [b.reshape(b.shape[0], -1, 4 * cfg.reg_max) for b, _ in outs], 1)
    cls_logits = torch.cat(
        [c.reshape(c.shape[0], -1, cfg.num_classes) for _, c in outs], 1)
    bsz, a = cls_logits.shape[:2]
    proj = torch.arange(cfg.reg_max, dtype=torch.float32, device=dev)
    gb = gt_boxes.float()
    gm = gt_mask.bool()

    dist = box_logits.reshape(bsz, a, 4, cfg.reg_max)
    exp_ltrb = dist.softmax(-1) @ proj                      # [B, A, 4]
    st = strides[None, :, None]
    pred_boxes = torch.cat([anchors[None] - exp_ltrb[..., :2] * st,
                            anchors[None] + exp_ltrb[..., 2:] * st], -1)

    # inside test [B, A, M]
    cx, cy = anchors[None, :, 0:1], anchors[None, :, 1:2]
    inside = ((cx > gb[:, None, :, 0]) & (cx < gb[:, None, :, 2])
              & (cy > gb[:, None, :, 1]) & (cy < gb[:, None, :, 3])
              & gm[:, None, :])
    iou = pairwise_iou(pred_boxes, gb) * inside             # [B, A, M]
    best_gt = iou.argmax(-1)                                # [B, A]
    pos = inside.any(-1).float()                            # [B, A]
    quality = iou.amax(-1)       # ties share the gradient, as in JAX

    tgt_box = gb.gather(1, best_gt[..., None].expand(bsz, a, 4))
    tgt_cls = gt_labels.long().gather(1, best_gt)

    # classification: quality-focal BCE (target = IoU at the assigned
    # class for positives, 0 elsewhere)
    onehot = F.one_hot(tgt_cls, cfg.num_classes).float()
    cls_tgt = onehot * (quality * pos)[..., None]
    cls_l = sigmoid_binary_cross_entropy(cls_logits, cls_tgt
                                         ).sum(-1).mean(-1)

    # box losses on positives only
    t_ltrb = torch.stack([anchors[None, :, 0] - tgt_box[..., 0],
                          anchors[None, :, 1] - tgt_box[..., 1],
                          tgt_box[..., 2] - anchors[None, :, 0],
                          tgt_box[..., 3] - anchors[None, :, 1]], -1) \
        / strides[None, :, None]
    t_ltrb = t_ltrb.clamp(0.0, cfg.reg_max - 1.01)
    lo = torch.floor(t_ltrb)
    w_hi = t_ltrb - lo
    logp = F.log_softmax(dist, -1)
    lo_i = lo.long()[..., None]
    dfl = -(logp.gather(-1, lo_i)[..., 0] * (1 - w_hi)
            + logp.gather(-1, lo_i + 1)[..., 0] * w_hi)
    npos = pos.sum(-1).clamp(min=1.0)
    dfl_l = (dfl.mean(-1) * pos).sum(-1) / npos
    iou_pred = iou.gather(-1, best_gt[..., None])[..., 0]
    iou_l = ((1.0 - iou_pred) * pos).sum(-1) / npos
    loss = cls_l.mean() + 0.4 * dfl_l.mean() + 2.0 * iou_l.mean()
    return loss, {"cls": cls_l.mean().detach(), "dfl": dfl_l.mean().detach(),
                  "iou": iou_l.mean().detach()}


def create_yolo_train_state(cfg: Optional[YoloConfig] = None,
                            learning_rate: LearningRate = 2e-3,
                            seed: int = 0, device=None
                            ) -> Tuple[YoloV8, TrainState]:
    """YOLOv8 from ``seed`` on ``device`` in the config's dtype, with
    ``clip_by_global_norm(5.0)`` and ``adam(learning_rate)``;
    ``learning_rate`` may be a schedule."""
    cfg = cfg or YoloConfig()
    model = _on_device(lambda: init_yolo(cfg, seed=seed), cfg, device)
    return model, TrainState(model, adam(model.parameters(), learning_rate,
                                         clip_norm=5.0))


def make_yolo_train_step(model: YoloV8, mesh=None
                         ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, images, gt_boxes, gt_labels, gt_mask) → (state,
    {"loss", "cls", "dfl", "iou", "grad_norm"})``: images uint8 (or
    0..255 float) ``[B, S, S, 3]`` at the config's ``img_size``, the
    ground truth as :func:`yolo_detection_loss` takes it, all on the
    model's device."""
    _no_mesh(mesh)
    cfg = model.cfg

    def step(state: TrainState, images, gt_boxes, gt_labels, gt_mask
             ) -> Tuple[TrainState, Metrics]:
        outs = state.module(images.float() / 255.0)
        loss, parts = yolo_detection_loss(outs, cfg, gt_boxes, gt_labels,
                                          gt_mask)
        norm = _apply(state, loss)
        return state, {"loss": loss.detach(), **parts, "grad_norm": norm}

    return _f32_convs(step)
