"""CLIP ViT-B/32 image and text encoders (counterpart of
``avede_tpu/models/clip.py``).

The same OpenAI CLIP architecture and numerics as the JAX package: a
ViT vision tower whose patch embedding has no bias, CLS plus position
embedding into ``pre_layernorm``, ``post_layernorm`` on CLS only, and
bias-free projections; a causal text tower pooled at ``argmax(ids)``.
Images are NHWC at the public functions, as in the JAX package. The
pixel path's patch embedding is a patchify plus matrix product (the
conv of the JAX package); the serving path enters the tower through
``encode_image_from_patches`` with the output of the hand-written
``fused_patch_embed`` kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.kernels import _patchify
from .layers import Transformer, seeded_init


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 32
    vision_dim: int = 768
    vision_depth: int = 12
    vision_heads: int = 12
    text_dim: int = 512
    text_depth: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    max_text_len: int = 77
    projection_dim: int = 512
    ln_eps: float = 1e-5
    dtype: str = "float32"
    use_flash: bool = False   # hand-written flash attention in the vision tower

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def vit_b32() -> CLIPConfig:
    return CLIPConfig()


def tiny_test_config() -> CLIPConfig:
    """Small config for fast CPU tests."""
    return CLIPConfig(image_size=32, patch_size=8, vision_dim=64,
                      vision_depth=2, vision_heads=4, text_dim=64,
                      text_depth=2, text_heads=4, vocab_size=256,
                      max_text_len=16, projection_dim=32)


class PatchEmbedding(nn.Module):
    """Bias-free P×P stride-P patch projection, weight OIHW [D, 3, P, P]
    as a conv's; computed as patchify + matrix product on NHWC input."""

    def __init__(self, dim: int, patch: int) -> None:
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.zeros(dim, 3, patch, patch))

    def kernel(self) -> torch.Tensor:
        """The weight as an HWIO [P, P, 3, D] kernel."""
        return self.weight.permute(2, 3, 1, 0)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """[N, S, S, 3] → [N, G², D]."""
        k = self.kernel()
        return _patchify(pixels, self.patch) @ k.reshape(-1, k.shape[-1])


class CLIPVisionEncoder(nn.Module):
    """ViT tower → pooled, projected image embedding (not unit-norm)."""

    def __init__(self, cfg: CLIPConfig) -> None:
        super().__init__()
        self.cfg = cfg
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
        self.projection = nn.Linear(d, cfg.projection_dim, bias=False)

    def forward(self, pixels: Optional[torch.Tensor] = None,
                patch_tokens: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """``pixels`` [N, S, S, 3] (CLIP-normalized) or ``patch_tokens``
        [N, G², D] (from ``fused_patch_embed``) → [N, projection] f32."""
        cfg = self.cfg
        dt = self.class_embedding.dtype
        if patch_tokens is not None:
            x = patch_tokens.to(dt)
        else:
            x = self.patch_embedding(pixels.to(dt))
        n = x.shape[0]
        cls = self.class_embedding.expand(n, 1, cfg.vision_dim)
        x = torch.cat([cls, x], dim=1) + self.position_embedding
        x = self.pre_layernorm(x)
        x = self.encoder(x)
        pooled = self.post_layernorm(x[:, 0, :])
        return self.projection(pooled).float()


class CLIPTextEncoder(nn.Module):
    """Causal text tower → EOT-pooled, projected text embedding."""

    def __init__(self, cfg: CLIPConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_dim)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_text_len, cfg.text_dim))
        self.encoder = Transformer(cfg.text_dim, cfg.text_depth,
                                   cfg.text_heads, ln_eps=cfg.ln_eps)
        self.final_layer_norm = nn.LayerNorm(cfg.text_dim, eps=cfg.ln_eps)
        self.projection = nn.Linear(cfg.text_dim, cfg.projection_dim,
                                    bias=False)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if ids.shape[1] > cfg.max_text_len:
            raise ValueError(
                f"token sequence length {ids.shape[1]} exceeds model "
                f"max_text_len {cfg.max_text_len}; tokenize with "
                f"Tokenizer(context_len={cfg.max_text_len})")
        ids = ids.long()
        x = self.token_embedding(ids) \
            + self.position_embedding[: ids.shape[1]]
        x = self.encoder(x, causal=True)
        x = self.final_layer_norm(x)
        eot = ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.projection(pooled).float()


class CLIPModel(nn.Module):
    """Joint model: image and text encoders plus the logit scale."""

    def __init__(self, cfg: CLIPConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.vision = CLIPVisionEncoder(cfg)
        self.text = CLIPTextEncoder(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    @staticmethod
    def _unit(emb: torch.Tensor) -> torch.Tensor:
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    def forward(self, pixels: torch.Tensor, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(unit-norm image embeddings, unit-norm text embeddings,
        ``exp(logit_scale)``): the contrastive trainer's forward."""
        return (self.encode_image(pixels), self.encode_text(ids),
                self.logit_scale.exp())

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self._unit(self.vision(pixels))

    def encode_image_from_patches(self, patch_tokens: torch.Tensor
                                  ) -> torch.Tensor:
        """Continue the vision tower from precomputed patch embeddings
        (the ``fused_patch_embed`` kernel's output)."""
        return self._unit(self.vision(patch_tokens=patch_tokens))

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self._unit(self.text(ids))


def init_clip(cfg: Optional[CLIPConfig] = None, seed: int = 0
              ) -> CLIPModel:
    """Model with deterministic random weights from ``seed`` (the repo
    ships no pretrained weights): normal(0, fan_in^-1/2) matrices,
    normal(0, 0.02) embeddings, unit LayerNorm scales, zero biases."""
    return seeded_init(CLIPModel(cfg or vit_b32()), seed,
                       (nn.Linear, PatchEmbedding), skip=("logit_scale",))
