"""EfficientNet-B0 feature extractor (counterpart of
``avede_tpu/models/effnet.py``).

The stem, the 16 MBConv blocks of the B0 table with squeeze-excite, the
1280-channel head, a spatial mean and an L2 norm: 1280-d re-ID features
of object crops; no classifier. Module names follow the JAX package's
(``stem``, ``s<stage>_b<block>`` with ``expand_conv``, ``dw_conv``,
``se.reduce`` / ``se.expand``, ``project_conv``; ``head``), so
``models/convert.params_from_jax`` maps its ``params`` and
``batch_stats`` onto this one, and ``convert_effnet_state_dict`` maps
the public HF ``google/efficientnet-b0`` checkpoint's keys.

As in the JAX package: stride-2 convolutions pad TF-"SAME"-style, one
pixel less on the top and left (``(p − 1, p)`` on each axis), which
symmetric padding would shift by one pixel; BatchNorm is the inference
form with flax's epsilon 1e-3; the squeeze-excite width is a quarter of
the block's *input* channels; the model computes in float32. The
convolutions, the depthwise ones included (``groups = C``), are
``F.conv2d``: the JAX package's are XLA's, not a Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import seeded_init
from .yolo import FrozenBatchNorm

# (expand_ratio, kernel, stride, out_channels, repeats) — the B0 table
B0_STAGES: List[Tuple[int, int, int, int, int]] = [
    (1, 3, 1, 16, 1),
    (6, 3, 2, 24, 2),
    (6, 5, 2, 40, 2),
    (6, 3, 2, 80, 3),
    (6, 5, 1, 112, 3),
    (6, 5, 2, 192, 4),
    (6, 3, 1, 320, 1),
]


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    width_mult: float = 1.0
    depth_mult: float = 1.0
    feature_dim: int = 1280
    se_ratio: float = 0.25
    bn_eps: float = 1e-3
    dtype: str = "float32"

    def ch(self, c: int) -> int:
        c = c * self.width_mult
        new = max(8, int(c + 4) // 8 * 8)
        if new < 0.9 * c:
            new += 8
        return new

    def reps(self, r: int) -> int:
        return int(math.ceil(r * self.depth_mult))

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def effnet_b0() -> EffNetConfig:
    return EffNetConfig()


def tiny_effnet_config() -> EffNetConfig:
    return EffNetConfig(width_mult=0.25, depth_mult=0.34, feature_dim=64)


class ConvBNAct(nn.Module):
    """Bias-free conv → inference BatchNorm → SiLU (``act``)."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1,
                 groups: int = 1, act: bool = True,
                 eps: float = 1e-3) -> None:
        super().__init__()
        p = k // 2
        # F.pad order: (left, right, top, bottom)
        self.pad = (p - 1, p, p - 1, p) if s == 2 else (p, p, p, p)
        self.stride, self.groups, self.act = s, groups, act
        self.conv = nn.Conv2d(c_in, c_out, k, s, 0, groups=groups,
                              bias=False)
        self.bn = FrozenBatchNorm(c_out, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(F.pad(x, self.pad)))
        return F.silu(x) if self.act else x


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int) -> None:
        super().__init__()
        self.reduce = nn.Conv2d(c, reduced, 1)
        self.expand = nn.Conv2d(reduced, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    def __init__(self, cfg: EffNetConfig, c_in: int, c_out: int,
                 expand: int, k: int, s: int) -> None:
        super().__init__()
        mid = c_in * expand
        self.expand = expand
        if expand != 1:
            self.expand_conv = ConvBNAct(c_in, mid, 1, eps=cfg.bn_eps)
        self.dw_conv = ConvBNAct(mid, mid, k, s, groups=mid, eps=cfg.bn_eps)
        self.se = SqueezeExcite(mid, max(1, int(c_in * cfg.se_ratio)))
        self.project_conv = ConvBNAct(mid, c_out, 1, act=False,
                                      eps=cfg.bn_eps)
        self.residual = s == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.expand_conv(x) if self.expand != 1 else x
        h = self.project_conv(self.se(self.dw_conv(h)))
        return x + h if self.residual else h


class EfficientNet(nn.Module):
    """ImageNet-normalized pixels NHWC [N, S, S, 3] → unit features
    float32 [N, feature_dim]."""

    def __init__(self, cfg: EffNetConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.stem = ConvBNAct(3, cfg.ch(32), 3, 2, eps=cfg.bn_eps)
        self.block_names: List[str] = []
        c = cfg.ch(32)
        for si, (e, k, s, c_out, r) in enumerate(B0_STAGES):
            for ri in range(cfg.reps(r)):
                name = f"s{si}_b{ri}"
                self.add_module(name, MBConv(cfg, c, cfg.ch(c_out), e, k,
                                             s if ri == 0 else 1))
                self.block_names.append(name)
                c = cfg.ch(c_out)
        self.head = ConvBNAct(c, cfg.feature_dim, 1, eps=cfg.bn_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = pixels.permute(0, 3, 1, 2).to(self.stem.conv.weight.dtype)
        x = self.stem(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        feats = self.head(x).mean(dim=(2, 3)).float()
        return feats / (feats.norm(dim=-1, keepdim=True) + 1e-9)


def convert_effnet_state_dict(sd: Mapping[str, torch.Tensor],
                              cfg: Optional[EffNetConfig] = None
                              ) -> Dict[str, torch.Tensor]:
    """HF ``EfficientNetModel`` state dict (``google/efficientnet-b0``'s
    keys) → this model's state dict. Both are torch layouts, so only the
    names change (the JAX package's converter transposes to Flax)."""
    cfg = cfg or effnet_b0()
    out: Dict[str, torch.Tensor] = {}

    def conv_bn(dst: str, conv_key: str, bn_key: str) -> None:
        out[f"{dst}.conv.weight"] = sd[f"{conv_key}.weight"]
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.bn.{leaf}"] = sd[f"{bn_key}.{leaf}"]

    conv_bn("stem", "embeddings.convolution", "embeddings.batchnorm")
    b = 0
    for si, (e, _k, _s, _c, r) in enumerate(B0_STAGES):
        for ri in range(cfg.reps(r)):
            s, d = f"encoder.blocks.{b}", f"s{si}_b{ri}"
            if e != 1:
                conv_bn(f"{d}.expand_conv", f"{s}.expansion.expand_conv",
                        f"{s}.expansion.expand_bn")
            conv_bn(f"{d}.dw_conv", f"{s}.depthwise_conv.depthwise_conv",
                    f"{s}.depthwise_conv.depthwise_norm")
            for proj in ("reduce", "expand"):
                for leaf in ("weight", "bias"):
                    out[f"{d}.se.{proj}.{leaf}"] = \
                        sd[f"{s}.squeeze_excite.{proj}.{leaf}"]
            conv_bn(f"{d}.project_conv", f"{s}.projection.project_conv",
                    f"{s}.projection.project_bn")
            b += 1
    conv_bn("head", "encoder.top_conv", "encoder.top_bn")
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in
            out.items()}


def init_effnet(cfg: Optional[EffNetConfig] = None,
                seed: int = 0) -> EfficientNet:
    """Model with deterministic random weights from ``seed`` (no
    checkpoint ships): normal(0, fan_in^-1/2) conv kernels, zero conv
    biases, identity BatchNorm."""
    model = EfficientNet(cfg or effnet_b0())
    bn = tuple(name for name, _ in model.named_parameters()
               if ".bn." in f".{name}")
    return seeded_init(model, seed, (nn.Conv2d,), skip=bn)
