"""YOLOv8 detector (counterpart of ``avede_tpu/models/yolo.py``).

CSPDarknet backbone (C2f blocks + SPPF) → PAN-FPN neck → decoupled
anchor-free head with Distribution Focal Loss box regression
(``reg_max`` = 16), scaled by the n/s/m/l/x depth and width multiples.
Module names follow the JAX package's (ultralytics layer indices:
``b0``…``b9``, ``n12``…``n21``, ``head_box_<level>_<j>``), so
``models/convert.params_from_jax`` maps its ``params`` and
``batch_stats`` onto this one; ``convert_yolov8_state_dict`` turns an
ultralytics state dict into that pair.

The public forward takes NHWC and returns NHWC head outputs, as the JAX
package's; inside, the convolutions run NCHW (``F.conv2d``: the JAX
package's convolutions are XLA's, not a Pallas kernel). BatchNorm is the
inference form with flax's epsilon 1e-3 (torch's default is 1e-5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import seeded_init

# COCO class names (the output contract of the YOLO path)
COCO_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

SCALES = {
    # depth, width, max_channels
    "n": (0.34, 0.25, 1024),
    "s": (0.34, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    num_classes: int = 80
    scale: str = "n"
    reg_max: int = 16
    img_size: int = 640
    dtype: str = "float32"

    @property
    def depth(self) -> float:
        return SCALES[self.scale][0]

    @property
    def width(self) -> float:
        return SCALES[self.scale][1]

    @property
    def max_ch(self) -> int:
        return SCALES[self.scale][2]

    def ch(self, c: int) -> int:
        """Scaled channel count (ultralytics make_divisible by 8)."""
        return int(math.ceil(min(c, self.max_ch) * self.width / 8) * 8)

    def n(self, d: int) -> int:
        return max(round(d * self.depth), 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def yolov8n(num_classes: int = 80) -> YoloConfig:
    return YoloConfig(num_classes=num_classes, scale="n")


def tiny_yolo_config() -> YoloConfig:
    """Reduced input for fast CPU tests (architecture unchanged)."""
    return YoloConfig(num_classes=4, scale="n", img_size=64)


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm over NCHW channels: flax's ``scale``/``bias``
    params and ``mean``/``var`` statistics as ``weight``/``bias`` and
    ``running_mean``/``running_var``."""

    def __init__(self, c: int, eps: float = BN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class ConvBN(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int = 1,
                 s: int = 1) -> None:
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, k // 2, bias=False)
        self.bn = FrozenBatchNorm(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, shortcut: bool = True) -> None:
        super().__init__()
        self.cv1 = ConvBN(c_in, c_out, 3)
        self.cv2 = ConvBN(c_out, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c_in: int, c_out: int, n: int = 1,
                 shortcut: bool = False) -> None:
        super().__init__()
        self.c = c = c_out // 2
        self.cv1 = ConvBN(c_in, 2 * c, 1)
        for i in range(n):
            self.add_module(f"m_{i}", Bottleneck(c, c, shortcut))
        self.n = n
        self.cv2 = ConvBN((2 + n) * c, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m_{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    def __init__(self, c_in: int, c_out: int) -> None:
        super().__init__()
        c = c_in // 2
        self.cv1 = ConvBN(c_in, c, 1)
        self.cv2 = ConvBN(4 * c, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        p1 = F.max_pool2d(y, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([y, p1, p2, p3], 1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest ×2 (``jax.image.resize(..., "nearest")`` at twice the
    size reads source pixel i // 2)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YoloV8(nn.Module):
    """NHWC frames → per-level raw head outputs (box logits
    ``[B, H, W, 4·reg_max]``, class logits ``[B, H, W, nc]``, float32)
    at strides 8/16/32."""

    def __init__(self, cfg: YoloConfig) -> None:
        super().__init__()
        self.cfg = cfg
        ch, n = cfg.ch, cfg.n
        self.b0 = ConvBN(3, ch(64), 3, 2)
        self.b1 = ConvBN(ch(64), ch(128), 3, 2)
        self.b2 = C2f(ch(128), ch(128), n(3), True)
        self.b3 = ConvBN(ch(128), ch(256), 3, 2)
        self.b4 = C2f(ch(256), ch(256), n(6), True)
        self.b5 = ConvBN(ch(256), ch(512), 3, 2)
        self.b6 = C2f(ch(512), ch(512), n(6), True)
        self.b7 = ConvBN(ch(512), ch(1024), 3, 2)
        self.b8 = C2f(ch(1024), ch(1024), n(3), True)
        self.b9 = SPPF(ch(1024), ch(1024))
        self.n12 = C2f(ch(1024) + ch(512), ch(512), n(3), False)
        self.n15 = C2f(ch(512) + ch(256), ch(256), n(3), False)
        self.n16 = ConvBN(ch(256), ch(256), 3, 2)
        self.n18 = C2f(ch(256) + ch(512), ch(512), n(3), False)
        self.n19 = ConvBN(ch(512), ch(512), 3, 2)
        self.n21 = C2f(ch(512) + ch(1024), ch(1024), n(3), False)
        c2 = max(16, ch(256) // 4, 4 * cfg.reg_max)
        c3 = max(ch(256), min(cfg.num_classes, 100))
        for i, c_in in enumerate((ch(256), ch(512), ch(1024))):
            self.add_module(f"head_box_{i}_0", ConvBN(c_in, c2, 3))
            self.add_module(f"head_box_{i}_1", ConvBN(c2, c2, 3))
            self.add_module(f"head_box_{i}_2",
                            nn.Conv2d(c2, 4 * cfg.reg_max, 1))
            self.add_module(f"head_cls_{i}_0", ConvBN(c_in, c3, 3))
            self.add_module(f"head_cls_{i}_1", ConvBN(c3, c3, 3))
            self.add_module(f"head_cls_{i}_2",
                            nn.Conv2d(c3, cfg.num_classes, 1))

    def forward(self, x: torch.Tensor
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        dt = self.b0.conv.weight.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        x = self.b2(self.b1(self.b0(x)))
        p3 = self.b4(self.b3(x))
        p4 = self.b6(self.b5(p3))
        p5 = self.b9(self.b8(self.b7(p4)))
        n4 = self.n12(torch.cat([_upsample2(p5), p4], 1))
        n3 = self.n15(torch.cat([_upsample2(n4), p3], 1))
        n4b = self.n18(torch.cat([self.n16(n3), n4], 1))
        n5 = self.n21(torch.cat([self.n19(n4b), p5], 1))
        outs = []
        for i, feat in enumerate((n3, n4b, n5)):
            head = [getattr(self, f"head_{kind}_{i}_{j}")
                    for kind in ("box", "cls") for j in range(3)]
            b = head[2](head[1](head[0](feat)))
            c = head[5](head[4](head[3](feat)))
            outs.append((b.permute(0, 2, 3, 1).float(),
                         c.permute(0, 2, 3, 1).float()))
        return outs


def decode_predictions(outs: List[Tuple[torch.Tensor, torch.Tensor]],
                       cfg: YoloConfig,
                       strides: Sequence[int] = (8, 16, 32)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw head outputs → (boxes ``[B, A, 4]`` xyxy px, class probs
    ``[B, A, nc]``): DFL softmax over ``reg_max`` bins → expected ltrb
    distance per side, times the stride, around anchor centers."""
    all_boxes, all_cls = [], []
    for (box, cls), stride in zip(outs, strides):
        b, h, w, _ = box.shape
        proj = torch.arange(cfg.reg_max, dtype=torch.float32,
                            device=box.device)
        dist = box.reshape(b, h * w, 4, cfg.reg_max).softmax(-1) @ proj
        ys = torch.arange(h, dtype=torch.float32, device=box.device) + 0.5
        xs = torch.arange(w, dtype=torch.float32, device=box.device) + 0.5
        cy, cx = torch.meshgrid(ys, xs, indexing="ij")
        anchors = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)
        x0y0 = (anchors - dist[..., :2]) * stride
        x1y1 = (anchors + dist[..., 2:]) * stride
        all_boxes.append(torch.cat([x0y0, x1y1], -1))
        all_cls.append(torch.sigmoid(cls.reshape(b, h * w,
                                                 cfg.num_classes)))
    return torch.cat(all_boxes, 1), torch.cat(all_cls, 1)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """Float NHWC → ``[N, size, size, C]``, bilinear with antialiasing on
    a downscale, as ``jax.image.resize(..., "bilinear")`` (a triangle
    filter widened by the scale factor, half-pixel centers, weights
    renormalised at the borders)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", antialias=True, align_corners=False)
    return y.permute(0, 2, 3, 1)


def init_yolo(cfg: Optional[YoloConfig] = None, seed: int = 0) -> YoloV8:
    """Model with deterministic random weights from ``seed`` (no
    checkpoint ships): normal(0, fan_in^-1/2) conv kernels, zero conv
    biases, identity BatchNorm (unit scale and variance, zero bias and
    mean), as flax initialises them."""
    model = YoloV8(cfg or yolov8n())
    bn = tuple(name for name, _ in model.named_parameters()
               if ".bn." in f".{name}")
    return seeded_init(model, seed, (nn.Conv2d,), skip=bn)


# ---------------------------------------------------------------------------
# conversion from an ultralytics state_dict export
# ---------------------------------------------------------------------------

_UL_BACKBONE = {0: "b0", 1: "b1", 2: "b2", 3: "b3", 4: "b4", 5: "b5",
                6: "b6", 7: "b7", 8: "b8", 9: "b9", 12: "n12", 15: "n15",
                16: "n16", 18: "n18", 19: "n19", 21: "n21"}


def convert_yolov8_state_dict(sd: Mapping[str, Any], cfg: YoloConfig
                              ) -> Tuple[Dict, Dict]:
    """ultralytics ``model.state_dict()`` (keys ``model.<i>.*``) → the
    JAX package's ``(params, batch_stats)`` trees
    (``avede_tpu/models/yolo.py:270``), array for array;
    ``models.convert.params_from_jax({"params": ..., "batch_stats":
    ...})`` takes them to this model. The ultralytics ``.pt`` pickle needs
    the ultralytics package to open: export the raw tensors first
    (``torch.save(dict(model.model.state_dict()), path)``)."""
    from .convert import _np, _set

    params: Dict = {}
    stats: Dict = {}

    def conv_bn(src: str, dst: str) -> None:
        _set(params, f"{dst}/conv/kernel",
             np.transpose(_np(sd[f"{src}.conv.weight"]), (2, 3, 1, 0)))
        _set(params, f"{dst}/bn/scale", _np(sd[f"{src}.bn.weight"]))
        _set(params, f"{dst}/bn/bias", _np(sd[f"{src}.bn.bias"]))
        _set(stats, f"{dst}/bn/mean", _np(sd[f"{src}.bn.running_mean"]))
        _set(stats, f"{dst}/bn/var", _np(sd[f"{src}.bn.running_var"]))

    def c2f(src: str, dst: str, n: int) -> None:
        conv_bn(f"{src}.cv1", f"{dst}/cv1")
        conv_bn(f"{src}.cv2", f"{dst}/cv2")
        for i in range(n):
            conv_bn(f"{src}.m.{i}.cv1", f"{dst}/m_{i}/cv1")
            conv_bn(f"{src}.m.{i}.cv2", f"{dst}/m_{i}/cv2")

    c2f_n = {2: cfg.n(3), 4: cfg.n(6), 6: cfg.n(6), 8: cfg.n(3),
             12: cfg.n(3), 15: cfg.n(3), 18: cfg.n(3), 21: cfg.n(3)}
    for idx, dst in _UL_BACKBONE.items():
        src = f"model.{idx}"
        if idx in c2f_n:
            c2f(src, dst, c2f_n[idx])
        elif idx == 9:
            conv_bn(f"{src}.cv1", f"{dst}/cv1")
            conv_bn(f"{src}.cv2", f"{dst}/cv2")
        else:
            conv_bn(src, dst)

    # head: model.22.cv2 (box) / cv3 (cls), 3 levels x (0, 1 ConvBN + a
    # plain conv)
    for lvl in range(3):
        for j in (0, 1):
            conv_bn(f"model.22.cv2.{lvl}.{j}", f"head_box_{lvl}_{j}")
            conv_bn(f"model.22.cv3.{lvl}.{j}", f"head_cls_{lvl}_{j}")
        for cv, kind in (("cv2", "box"), ("cv3", "cls")):
            src = f"model.22.{cv}.{lvl}.2"
            _set(params, f"head_{kind}_{lvl}_2/kernel",
                 np.transpose(_np(sd[f"{src}.weight"]), (2, 3, 1, 0)))
            _set(params, f"head_{kind}_{lvl}_2/bias", _np(sd[f"{src}.bias"]))
    return params, stats
