"""Temporal grounding head, UniVTG-style (counterpart of
``avede_tpu/models/univtg.py``).

Video + text → per-frame saliency logit and (left, right) boundary
offsets in frame units (softplus ≥ 0). Inputs are the cached CLIP frame
embeddings and the CLIP text embedding: the text is fused FiLM-style
after projection, learned positions are added, and a non-causal pre-LN
transformer (tanh-approximate GELU, flax ``nn.gelu``'s default) runs
over the frames with a key-padding mask. Padded frames score
``finfo(f32).min``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum
from .layers import Transformer, seeded_init


@dataclasses.dataclass(frozen=True)
class TemporalGroundingConfig:
    input_dim: int = 512            # CLIP projection dim
    hidden: int = 256
    depth: int = 4
    heads: int = 4
    max_frames: int = 1024          # matches the MAX_FRAMES cap
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def tiny_grounding_config(input_dim: int = 32) -> TemporalGroundingConfig:
    return TemporalGroundingConfig(input_dim=input_dim, hidden=32, depth=2,
                                   heads=2, max_frames=128)


class TemporalGroundingHead(nn.Module):
    def __init__(self, cfg: TemporalGroundingConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.video_proj = nn.Linear(cfg.input_dim, cfg.hidden)
        self.text_proj = nn.Linear(cfg.input_dim, cfg.hidden)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_frames, cfg.hidden))
        self.encoder = Transformer(cfg.hidden, cfg.depth, cfg.heads,
                                   mlp_ratio=4.0, activation="gelu")
        self.saliency = nn.Linear(cfg.hidden, 1)
        self.boundaries = nn.Linear(cfg.hidden, 2)

    def forward(self, frame_emb: torch.Tensor, text_emb: torch.Tensor,
                valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frame_emb [B, N, D], text_emb [B, D], valid bool [B, N] →
        (f32 saliency logits [B, N], f32 offsets [B, N, 2] ≥ 0)."""
        dt = self.position_embedding.dtype
        b, n, _ = frame_emb.shape
        v = self.video_proj(frame_emb.to(dt))
        t = self.text_proj(text_emb.to(dt))[:, None, :]
        x = v * (1.0 + t) + t + self.position_embedding[:n]
        mask = (valid if valid is not None else
                torch.ones(b, n, dtype=torch.bool, device=x.device))
        x = self.encoder(x, mask=mask)
        sal = self.saliency(x)[..., 0].float()
        off = F.softplus(self.boundaries(x)).float()
        sal = sal.masked_fill(~mask, torch.finfo(torch.float32).min)
        return sal, off


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """Per-element sigmoid binary cross-entropy, optax's
    ``sigmoid_binary_cross_entropy`` in the form ``relu(x) - x·z +
    log1p(exp(-|x|))``: finite, with a finite gradient, at the head's
    ``finfo.min`` masked logits, so ``torch.where`` can mask it without
    putting NaN into the gradient."""
    x, z = logits, labels.to(logits.dtype)
    return F.relu(x) - x * z + torch.log1p(torch.exp(-x.abs()))


def grounding_loss(saliency: torch.Tensor, offsets: torch.Tensor,
                   sal_labels: torch.Tensor, off_labels: torch.Tensor,
                   valid: torch.Tensor, group=None) -> torch.Tensor:
    """BCE on saliency over the valid frames + L1 on the boundary
    offsets over the foreground frames (label > 0.5), each a mean over
    its frames (at least 1) — ``avede_tpu/models/univtg.py:89-99``.
    With ``group`` (the data ranks of a sharded step) the inputs are one
    shard of the batch: the frame counts are the whole batch's, summed
    over the group, so the ranks' results add up to the whole batch's
    loss."""
    valid = valid.bool()
    zero = saliency.new_zeros(())
    fg = (sal_labels > 0.5) & valid
    n_valid, n_fg = valid.sum(), fg.sum()
    if group is not None:
        n_valid, n_fg = all_reduce_sum(torch.stack([n_valid, n_fg]), group)
    bce = torch.where(valid, sigmoid_bce(saliency, sal_labels), zero)
    bce = bce.sum() / n_valid.clamp(min=1)
    l1 = (offsets - off_labels).abs().sum(-1)
    l1 = torch.where(fg, l1, zero).sum() / n_fg.clamp(min=1)
    return bce + l1


def init_grounding(cfg: Optional[TemporalGroundingConfig] = None,
                   seed: int = 0) -> TemporalGroundingHead:
    """Head with deterministic random weights from ``seed``
    (``layers.seeded_init``)."""
    return seeded_init(TemporalGroundingHead(
        cfg or TemporalGroundingConfig()), seed)
