"""Learnable segmentation model, a compact U-Net (counterpart of
``avede_tpu/models/segmenter.py``).

Box-conditioned binary mask prediction: pixels ``[N, S, S, 3]`` in [0, 1]
plus a rendered box prior ``[N, S, S]`` (the prompt, as SAM's box) →
mask logits ``[N, S, S]`` in float32. The JAX package's layout is kept at
the call (channels last); inside, the model runs NCHW.

As in the JAX package: 3×3 convolutions pad "SAME" (one pixel each
side), GroupNorm is flax's (``min(8, C)`` groups, epsilon 1e-6, the
variance as ``E[x²] − E[x]²`` clipped at 0, scale folded into the
reciprocal square root), 2×2 max pooling, nearest ×2 upsampling, and the
decoder concatenates [upsampled, skip]. Module names follow flax's
(``enc<d>``, ``mid``, ``dec<d>``, each ``c1``, ``n1``, ``c2``, ``n2``;
``out``), so ``models/convert.params_from_jax`` maps JAX's parameters
onto this one. The convolutions are ``F.conv2d``: the JAX package runs
no TPU kernel here either, and the model trains and serves through
plain PyTorch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.train_det import sigmoid_binary_cross_entropy
from ..utils.platform import resolve_device
from .layers import seeded_init


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    base: int = 32
    depth: int = 3
    image_size: int = 128
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def tiny_segmenter_config() -> SegmenterConfig:
    return SegmenterConfig(base=8, depth=2, image_size=32)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on NCHW: statistics over each group's
    channels and pixels, ``use_fast_variance``, epsilon 1e-6."""

    def __init__(self, num_groups: int, channels: int,
                 eps: float = 1e-6) -> None:
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        g = x.reshape(n, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = torch.clamp((g * g).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        per_ch = c // self.num_groups
        mean = mean.repeat_interleave(per_ch, 1)[..., None]    # [N, C, 1, 1]
        mul = torch.rsqrt(var + self.eps).repeat_interleave(per_ch, 1
                                                            )[..., None]
        mul = mul * self.weight[None, :, None, None]
        return (x - mean) * mul + self.bias[None, :, None, None]


class ConvBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int) -> None:
        super().__init__()
        self.c1 = nn.Conv2d(in_ch, ch, 3, padding=1)
        self.n1 = GroupNorm(min(8, ch), ch)
        self.c2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.n2 = GroupNorm(min(8, ch), ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.n1(self.c1(x)))
        return F.silu(self.n2(self.c2(x)))


class UNetSegmenter(nn.Module):
    def __init__(self, cfg: SegmenterConfig) -> None:
        super().__init__()
        self.cfg = cfg
        in_ch, ch = 4, cfg.base
        for d in range(cfg.depth):
            self.add_module(f"enc{d}", ConvBlock(in_ch, ch))
            in_ch, ch = ch, ch * 2
        self.mid = ConvBlock(in_ch, ch)
        for d in reversed(range(cfg.depth)):
            # the upsampled 2·ch channels, then the skip's ch
            self.add_module(f"dec{d}", ConvBlock(3 * (ch // 2), ch // 2))
            ch //= 2
        self.out = nn.Conv2d(ch, 1, 1)

    def forward(self, pixels: torch.Tensor,
                box_prior: torch.Tensor) -> torch.Tensor:
        """pixels [N, S, S, 3] in [0, 1]; box_prior [N, S, S] in {0, 1} →
        mask logits [N, S, S] (float32)."""
        dt = self.cfg.torch_dtype
        x = torch.cat([pixels.to(dt), box_prior[..., None].to(dt)], -1)
        x = x.permute(0, 3, 1, 2)
        skips: List[torch.Tensor] = []
        for d in range(self.cfg.depth):
            x = getattr(self, f"enc{d}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = self.mid(x)
        for d in reversed(range(self.cfg.depth)):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = getattr(self, f"dec{d}")(torch.cat([x, skips[d]], 1))
        return self.out(x)[:, 0].float()


def segmentation_loss(logits: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """BCE (optax's log-sigmoid form) + soft Dice."""
    bce = sigmoid_binary_cross_entropy(logits, masks).mean()
    p = torch.sigmoid(logits)
    inter = (p * masks).sum((1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (p.sum((1, 2)) + masks.sum((1, 2))
                                      + 1.0)
    return bce + dice.mean()


def render_box_prior(shape: Tuple[int, int], bbox,
                     size: int) -> np.ndarray:
    """bbox (source pixels) → binary prior at the model resolution."""
    h, w = shape
    prior = np.zeros((size, size), np.float32)
    x0 = int(bbox[0] / w * size)
    y0 = int(bbox[1] / h * size)
    x1 = max(int(bbox[2] / w * size), x0 + 1)
    y1 = max(int(bbox[3] / h * size), y0 + 1)
    prior[y0:y1, x0:x1] = 1.0
    return prior


def init_segmenter(cfg: Optional[SegmenterConfig] = None, seed: int = 0,
                   device: Union[str, torch.device, None] = None
                   ) -> UNetSegmenter:
    """Model on ``device`` (``cuda`` unless the caller asks for the CPU)
    with deterministic random weights from ``seed``: normal(0,
    fan_in^-1/2) conv kernels, zero conv biases, identity GroupNorm."""
    model = UNetSegmenter(cfg or SegmenterConfig())
    norms = tuple(name for name, _ in model.named_parameters()
                  if ".n1." in name or ".n2." in name)
    seeded_init(model, seed, (nn.Conv2d,), skip=norms)
    return model.to(resolve_device(device), model.cfg.torch_dtype)
