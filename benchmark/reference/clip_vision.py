"""Plain f32 reference of CLIP's image side as the ingest path defines it:
decoded uint8 RGB frames → the compact I420 transfer codec → OpenAI
CLIP's vision tower (open_clip ``ViT-B-32``) → unit embeddings.

The codec, written again from its definition (the host pack: central
square crop, an area resize, full-range BT.601 in 10-bit fixed point,
2×2 chroma means; the device unpack: chroma repeated 2×2, BT.601 back to
RGB, clipped):

- crop: the central ``s × s`` square, ``s`` the shorter side;
- area resize ``s → S``: each output pixel the mean of the source
  pixels it covers, each weighted by the length of its overlap (float32
  weights), rounded half to even; an exact halving is
  ``(a + b + c + d + 2) >> 2``;
- Y, U, V: ``(Σ c_i · x_i + offset + 512) >> 10``, clipped to 0..255,
  with ``c = rint(1024 · M)`` of the BT.601 matrix ``M`` and offsets
  ``rint(1024 · (0, 128, 128))``;
- U and V halved by the exact rule; the packed frame is Y's ``S`` rows,
  then U's and V's ``S/2 × S/2`` planes as ``S/4`` rows of ``S`` each;
- unpack: ``r = y + 1.402 v``, ``g = y - 0.344136 u - 0.714136 v``,
  ``b = y + 1.772 u`` (``u``, ``v`` less 128, each repeated over its
  2 × 2 block), clipped to [0, 255], /255, CLIP's mean and std.

The tower: a bias-free patch projection, the class token, learned
positions, a LayerNorm, pre-LN blocks (softmax attention, quick-GELU
MLP), a LayerNorm on the class token, a bias-free projection, normalised
to unit length. Weights are a dict under ``clip_text.param_spec``'s
names, read in f32 with TF32 off. ``lowp="fp8"`` rounds every operand of
every product to fp8: the control.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .lowp import fp8

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
BT601 = ((0.299, 0.587, 0.114),
         (-0.168736, -0.331264, 0.5),
         (0.5, -0.418688, -0.081312))
FIXED_BITS = 10


def area_weights(src: int, dst: int) -> torch.Tensor:
    """[dst, src] float32: output pixel ``d`` covers ``[d·r, (d+1)·r)``
    of the source (``r = src / dst``), source pixel ``k`` weighs its
    overlap with that over ``r``."""
    r = src / dst
    w = torch.zeros(dst, src, dtype=torch.float64)
    for d in range(dst):
        lo, hi = d * r, (d + 1) * r
        for k in range(math.floor(lo), min(math.ceil(hi), src)):
            w[d, k] = (min(hi, k + 1) - max(lo, k)) / r
    return w.float()


def halve(x: torch.Tensor) -> torch.Tensor:
    """uint8 [N, 2h, 2w] → [N, h, w]: ``(a + b + c + d + 2) >> 2``."""
    s = x.to(torch.int32)
    s = s[:, 0::2, 0::2] + s[:, 0::2, 1::2] + s[:, 1::2, 0::2] \
        + s[:, 1::2, 1::2]
    return ((s + 2) >> 2).to(torch.uint8)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [N, s, s, 3] → [N, size, size, 3] by the area rule."""
    s = x.shape[1]
    if s == size:
        return x
    if s == 2 * size:
        return torch.stack([halve(x[..., c]) for c in range(3)], dim=-1)
    if s < size:
        raise ValueError(f"the codec does not upscale ({s} → {size})")
    w = area_weights(s, size).to(x.device, torch.float64)
    y = torch.einsum("ys,nstc->nytc", w, x.to(torch.float64))
    y = torch.einsum("xt,nytc->nyxc", w, y)
    return torch.round(y).clamp(0, 255).to(torch.uint8)


def pack_i420(frames: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 RGB [N, H, W, 3] → packed I420 uint8 [N, size·3/2, size]."""
    n, h, w, _ = frames.shape
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    rgb = resize(frames[:, top:top + s, left:left + s], size).to(torch.int32)
    m = torch.tensor(BT601, dtype=torch.float64)
    coef = torch.round(m * (1 << FIXED_BITS)).to(torch.int32)
    off = torch.round(torch.tensor([0.0, 128.0, 128.0], dtype=torch.float64)
                      * (1 << FIXED_BITS)).to(torch.int32) \
        + (1 << (FIXED_BITS - 1))
    planes = []
    for i in range(3):
        acc = (rgb[..., 0] * int(coef[i, 0]) + rgb[..., 1] * int(coef[i, 1])
               + rgb[..., 2] * int(coef[i, 2]) + int(off[i]))
        planes.append((acc >> FIXED_BITS).clamp(0, 255).to(torch.uint8))
    q = size // 4
    return torch.cat([planes[0], halve(planes[1]).reshape(n, q, size),
                      halve(planes[2]).reshape(n, q, size)], dim=1)


def unpack_i420(packed: torch.Tensor) -> torch.Tensor:
    """Packed I420 uint8 [N, S·3/2, S] → CLIP-normalised f32
    [N, S, S, 3]."""
    n, _, s = packed.shape
    h = s // 2
    y = packed[:, :s].float()
    u = packed[:, s:s + s // 4].reshape(n, h, h).float() - 128.0
    v = packed[:, s + s // 4:].reshape(n, h, h).float() - 128.0
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
    rgb = torch.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v,
                       y + 1.772 * u], dim=-1).clamp(0.0, 255.0) / 255.0
    mean = torch.tensor(CLIP_MEAN, device=packed.device)
    std = torch.tensor(CLIP_STD, device=packed.device)
    return (rgb - mean) / std


class ClipVision:
    """The reference vision tower over a weight dict (any device; f32)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict,
                 lowp: Optional[str] = None) -> None:
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown control precision {lowp!r}")
        self.w = weights
        self.cfg = cfg
        self.round = fp8 if lowp == "fp8" else (lambda t: t)

    def _p(self, name: str) -> torch.Tensor:
        return self.w[f"vision.{name}"].float()

    def _lin(self, name: str, x: torch.Tensor, bias: bool = True
             ) -> torch.Tensor:
        y = self.round(x) @ self.round(self._p(f"{name}.weight")).T
        return y + self._p(f"{name}.bias") if bias else y

    def _ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self._p(f"{name}.weight"),
                            self._p(f"{name}.bias"), self.cfg["ln_eps"])

    def encode(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised f32 [N, S, S, 3] → unit f32 [N, projection]."""
        cfg, r = self.cfg, self.round
        n, s = pixels.shape[:2]
        p, d, heads = cfg["patch_size"], cfg["vision_dim"], \
            cfg["vision_heads"]
        g, hd = s // p, d // heads
        # patches in the conv weight's (channel, row, column) order
        x = pixels.permute(0, 3, 1, 2).reshape(n, 3, g, p, g, p)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(n, g * g, 3 * p * p)
        x = r(x) @ r(self._p("patch_embedding.weight").reshape(d, -1)).T
        cls = self._p("class_embedding").expand(n, 1, d)
        x = torch.cat([cls, x], dim=1) + self._p("position_embedding")
        x = self._ln("pre_layernorm", x)
        length = x.shape[1]
        split = (lambda t: t.view(n, length, heads, hd).transpose(1, 2))
        for i in range(cfg["vision_depth"]):
            b = f"encoder.layers.{i}"
            h = self._ln(f"{b}.layer_norm1", x)
            q, k, v = (split(self._lin(f"{b}.self_attn.{t}", h))
                       for t in ("q_proj", "k_proj", "v_proj"))
            a = (r(q) @ r(k).transpose(-1, -2)) / math.sqrt(hd)
            o = (r(torch.softmax(a, dim=-1)) @ r(v)).transpose(1, 2)
            x = x + self._lin(f"{b}.self_attn.out_proj",
                              o.reshape(n, length, d))
            h = self._lin(f"{b}.mlp.fc1", self._ln(f"{b}.layer_norm2", x))
            x = x + self._lin(f"{b}.mlp.fc2", h * torch.sigmoid(1.702 * h))
        pooled = self._ln("post_layernorm", x[:, 0])
        e = self._lin("projection", pooled, bias=False)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    def embed_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 RGB [N, H, W, 3] → unit f32 [N, projection] through the
        codec."""
        return self.encode(unpack_i420(pack_i420(frames,
                                                 self.cfg["image_size"])))
