"""OWL-ViT open-vocabulary detector (counterpart of
``avede_tpu/models/owlvit.py``; HF ``google/owlvit-base-patch32``
numerics).

- CLIP-style vision tower, post-LayerNorm over all tokens; with
  ``use_flash`` every layer's attention runs the hand-written
  ``flash_attention_blhd`` (B/32 at 768 px: L = 577, hd = 64);
- patch features merged with the class token (elementwise product +
  LayerNorm);
- class head: image features projected to the text width, unit-norm dot
  with the unit text query embeddings (in f32), learnable shift and
  ``elu + 1`` scale;
- box head: three Dense layers with exact GELU, plus the grid bias, then
  sigmoid → cxcywh in [0, 1].

Module names follow the JAX package's, so ``models/convert.
params_from_jax`` maps its tree onto this one;
``convert_owlvit_state_dict`` turns a HF ``OwlViTForObjectDetection``
state dict into that tree. The patch embedding is a
patchify + matrix product (a conv in the JAX package, not a Pallas
kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .clip import PatchEmbedding
from .layers import Transformer, seeded_init


@dataclasses.dataclass(frozen=True)
class OwlViTConfig:
    image_size: int = 768
    patch_size: int = 32
    vision_dim: int = 768
    vision_depth: int = 12
    vision_heads: int = 12
    text_dim: int = 512
    text_depth: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    max_text_len: int = 16
    projection_dim: int = 512
    ln_eps: float = 1e-5
    dtype: str = "float32"
    use_flash: bool = False   # hand-written flash attention (577 tokens)

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def owlvit_base_patch32() -> OwlViTConfig:
    return OwlViTConfig()


def tiny_owlvit_config() -> OwlViTConfig:
    return OwlViTConfig(image_size=32, patch_size=8, vision_dim=64,
                        vision_depth=2, vision_heads=4, text_dim=64,
                        text_depth=2, text_heads=4, vocab_size=100,
                        max_text_len=8, projection_dim=64)


class OwlVisionEncoder(nn.Module):
    """Pixels [N, S, S, 3] → token states [N, P+1, D] after the
    post-LayerNorm."""

    def __init__(self, cfg: OwlViTConfig) -> None:
        super().__init__()
        d = cfg.vision_dim
        self.patch_embedding = PatchEmbedding(d, cfg.patch_size)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, d))
        self.pre_layernorm = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.encoder = Transformer(d, cfg.vision_depth, cfg.vision_heads,
                                   ln_eps=cfg.ln_eps,
                                   use_flash=cfg.use_flash)
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.ln_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(pixels.to(self.class_embedding.dtype))
        cls = self.class_embedding.expand(x.shape[0], 1, x.shape[-1])
        x = torch.cat([cls, x], 1) + self.position_embedding
        x = self.encoder(self.pre_layernorm(x))
        return self.post_layernorm(x)


class OwlTextEncoder(nn.Module):
    """ids [Q, L] → query embeddings [Q, projection_dim] (not unit)."""

    def __init__(self, cfg: OwlViTConfig) -> None:
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_dim)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_text_len, cfg.text_dim))
        self.encoder = Transformer(cfg.text_dim, cfg.text_depth,
                                   cfg.text_heads, ln_eps=cfg.ln_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.text_dim, eps=cfg.ln_eps)
        self.text_projection = nn.Linear(cfg.text_dim, cfg.projection_dim,
                                         bias=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        x = self.token_embedding(ids) \
            + self.position_embedding[: ids.shape[1]]
        x = self.final_layer_norm(self.encoder(x, causal=True))
        pooled = x[torch.arange(x.shape[0], device=x.device),
                   ids.argmax(dim=-1)]
        return self.text_projection(pooled)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + 1e-6)


class OwlViTDetector(nn.Module):
    def __init__(self, cfg: OwlViTConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.vision = OwlVisionEncoder(cfg)
        self.text = OwlTextEncoder(cfg)
        self.merge_ln = nn.LayerNorm(cfg.vision_dim, eps=cfg.ln_eps)
        # HF's class head projects image features to the TEXT width
        self.cls_dense0 = nn.Linear(cfg.vision_dim, cfg.text_dim)
        self.logit_shift = nn.Linear(cfg.vision_dim, 1)
        self.logit_scale = nn.Linear(cfg.vision_dim, 1)
        self.box_dense0 = nn.Linear(cfg.vision_dim, cfg.vision_dim)
        self.box_dense1 = nn.Linear(cfg.vision_dim, cfg.vision_dim)
        self.box_dense2 = nn.Linear(cfg.vision_dim, 4)
        self.register_buffer("box_bias", self._box_bias(cfg.grid),
                             persistent=False)

    @staticmethod
    def _box_bias(g: int) -> torch.Tensor:
        """[G², 4] logit-space prior: each patch's grid position (x, y)
        and the cell size."""
        ar = torch.arange(1, g + 1, dtype=torch.float32)
        yy, xx = torch.meshgrid(ar, ar, indexing="ij")
        coords = (torch.stack([xx, yy], -1) / g).reshape(-1, 2).clamp(0, 1)
        coord_bias = torch.log(coords + 1e-4) - torch.log1p(-coords + 1e-4)
        size = torch.full_like(coord_bias, 1.0 / g)
        size_bias = torch.log(size + 1e-4) - torch.log1p(-size + 1e-4)
        return torch.cat([coord_bias, size_bias], -1)

    def image_features(self, pixels: torch.Tensor) -> torch.Tensor:
        """→ merged patch features [N, P, D]."""
        tokens = self.vision(pixels)
        return self.merge_ln(tokens[:, 1:, :] * tokens[:, :1, :])

    def forward(self, pixels: torch.Tensor, query_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (logits [N, P, Q] f32, boxes [N, P, 4] cxcywh in [0, 1])."""
        feats = self.image_features(pixels)
        queries = self.text(query_ids)
        img_n = _unit(self.cls_dense0(feats)).float()
        logits = img_n @ _unit(queries).float().T
        shift = self.logit_shift(feats).float()
        scale = F.elu(self.logit_scale(feats)).float() + 1.0
        logits = (logits + shift) * scale
        b = F.gelu(self.box_dense0(feats))
        b = F.gelu(self.box_dense1(b))
        b = self.box_dense2(b)
        boxes = torch.sigmoid(b.float() + self.box_bias)
        return logits, boxes


def init_owlvit(cfg: Optional[OwlViTConfig] = None, seed: int = 0
                ) -> OwlViTDetector:
    """Model with deterministic random weights from ``seed`` (no
    checkpoint ships)."""
    return seeded_init(OwlViTDetector(cfg or owlvit_base_patch32()), seed,
                       (nn.Linear, PatchEmbedding))


# ---------------------------------------------------------------------------
# conversion from HF OwlViTForObjectDetection
# ---------------------------------------------------------------------------

def convert_owlvit_state_dict(sd: Mapping[str, Any], vision_depth: int = 12,
                              text_depth: int = 12) -> Dict[str, Any]:
    """HF ``OwlViTForObjectDetection`` state dict → the JAX package's
    parameter tree (``avede_tpu/models/owlvit.py:211``), array for
    array; ``models.convert.params_from_jax`` takes it to this model."""
    from .convert import _convert_encoder_layers, _np, _set

    v, t = "owlvit.vision_model", "owlvit.text_model"
    p: Dict[str, Any] = {}
    _set(p, "vision/patch_embedding/kernel",
         _np(sd[f"{v}.embeddings.patch_embedding.weight"]
             ).transpose(2, 3, 1, 0))
    _set(p, "vision/class_embedding",
         _np(sd[f"{v}.embeddings.class_embedding"]).reshape(-1))
    _set(p, "vision/position_embedding",
         _np(sd[f"{v}.embeddings.position_embedding.weight"]))
    for ln in ("pre_layernorm", "post_layernorm"):
        _set(p, f"vision/{ln}/scale", _np(sd[f"{v}.{ln}.weight"]))
        _set(p, f"vision/{ln}/bias", _np(sd[f"{v}.{ln}.bias"]))
    _convert_encoder_layers(sd, p, f"{v}.encoder", "vision/encoder",
                            vision_depth)

    _set(p, "text/token_embedding/embedding",
         _np(sd[f"{t}.embeddings.token_embedding.weight"]))
    _set(p, "text/position_embedding",
         _np(sd[f"{t}.embeddings.position_embedding.weight"]))
    _convert_encoder_layers(sd, p, f"{t}.encoder", "text/encoder",
                            text_depth)
    _set(p, "text/final_layer_norm/scale",
         _np(sd[f"{t}.final_layer_norm.weight"]))
    _set(p, "text/final_layer_norm/bias",
         _np(sd[f"{t}.final_layer_norm.bias"]))
    _set(p, "text/text_projection/kernel",
         _np(sd["owlvit.text_projection.weight"]).T)

    _set(p, "merge_ln/scale", _np(sd["layer_norm.weight"]))
    _set(p, "merge_ln/bias", _np(sd["layer_norm.bias"]))
    for src, dst in (("class_head.dense0", "cls_dense0"),
                     ("class_head.logit_shift", "logit_shift"),
                     ("class_head.logit_scale", "logit_scale"),
                     ("box_head.dense0", "box_dense0"),
                     ("box_head.dense1", "box_dense1"),
                     ("box_head.dense2", "box_dense2")):
        _set(p, f"{dst}/kernel", _np(sd[f"{src}.weight"]).T)
        _set(p, f"{dst}/bias", _np(sd[f"{src}.bias"]))
    return p
