"""BLIP-2 Q-Former image-text retrieval model (counterpart of
``avede_tpu/models/qformer.py``): HF ``Blip2ForImageTextRetrieval``'s
stage-1 retrieval half.

- The vision tower is the port's ``BlipVisionEncoder`` (fused qkv, exact
  GELU, LayerNorm eps 1e-5) at ViT-g widths: 1408 wide, 39 layers, 16
  heads of 88, 257 tokens at 224 px with patch 14. Its self-attention
  runs the hand-written ``flash_attention_blhd`` on the card (the bf16
  entry's hd = 88 instantiation); the JAX package computes it with
  einsums.
- The Q-Former is BERT post-LN (eps 1e-12, exact GELU): learned query
  tokens self-attend, cross-attend to the vision tokens in every layer
  ``i`` with ``i % cross_frequency == 0``, and pass their own FFN branch
  (``intermediate_query`` / ``output_query``); text tokens take the
  other branch (``intermediate`` / ``output``). Its attention (masked,
  hd = 64, at most 32 queries) stays plain torch with an f32 softmax, as
  the JAX package left it to einsum.
- ITC: the max over the query tokens of ``img · txt``, both normalised
  by ``norm + 1e-9``.

Parameter names follow the JAX package's, so ``models.convert.
params_from_jax`` carries its weights over; ``convert_blip2_state_dict``
reads HF's keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blip import BertAttention, BlipConfig, BlipVisionEncoder
from .layers import seeded_init


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    # vision tower (ViT-g in the BLIP-2 release)
    image_size: int = 224
    patch_size: int = 14
    vision_dim: int = 1408
    vision_depth: int = 39
    vision_heads: int = 16
    vision_mlp: int = 6144
    vision_ln_eps: float = 1e-5
    # q-former
    hidden: int = 768
    depth: int = 12
    heads: int = 12
    mlp: int = 3072
    cross_frequency: int = 2
    vocab_size: int = 30523
    max_pos: int = 512
    ln_eps: float = 1e-12
    use_text_input: bool = True
    num_query_tokens: int = 32
    projection_dim: int = 256
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def vision_cfg(self) -> BlipConfig:
        return BlipConfig(
            image_size=self.image_size, patch_size=self.patch_size,
            vision_dim=self.vision_dim, vision_depth=self.vision_depth,
            vision_heads=self.vision_heads, vision_mlp=self.vision_mlp,
            vision_ln_eps=self.vision_ln_eps,
            # text fields unused by the vision tower
            text_dim=self.hidden, text_depth=1, text_heads=1,
            text_mlp=self.mlp, dtype=self.dtype)

    @property
    def text_attn_cfg(self) -> BlipConfig:
        """Shape carrier for ``BertAttention``."""
        return BlipConfig(text_dim=self.hidden, text_heads=self.heads,
                          text_ln_eps=self.ln_eps, dtype=self.dtype)


def tiny_qformer_config() -> QFormerConfig:
    return QFormerConfig(image_size=32, patch_size=8, vision_dim=64,
                         vision_depth=2, vision_heads=4, vision_mlp=128,
                         hidden=64, depth=2, heads=4, mlp=128,
                         cross_frequency=2, vocab_size=100, max_pos=32,
                         num_query_tokens=4, projection_dim=24)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool) -> None:
        super().__init__()
        d, eps, acfg = cfg.hidden, cfg.ln_eps, cfg.text_attn_cfg
        self.has_cross = has_cross
        self.self_attn = BertAttention(acfg)
        self.self_output = nn.Linear(d, d)
        self.self_ln = nn.LayerNorm(d, eps=eps)
        if has_cross:
            self.cross_attn = BertAttention(acfg, kv_dim=cfg.vision_dim)
            self.cross_output = nn.Linear(d, d)
            self.cross_ln = nn.LayerNorm(d, eps=eps)
        self.intermediate_query = nn.Linear(d, cfg.mlp)
        self.output_query = nn.Linear(cfg.mlp, d)
        self.output_query_ln = nn.LayerNorm(d, eps=eps)
        self.intermediate = nn.Linear(d, cfg.mlp)
        self.output = nn.Linear(cfg.mlp, d)
        self.output_ln = nn.LayerNorm(d, eps=eps)

    def _ffn_query(self, h: torch.Tensor) -> torch.Tensor:
        y = self.output_query(F.gelu(self.intermediate_query(h)))
        return self.output_query_ln(h + y)

    def _ffn_text(self, h: torch.Tensor) -> torch.Tensor:
        y = self.output(F.gelu(self.intermediate(h)))
        return self.output_ln(h + y)

    def forward(self, x: torch.Tensor, vision: Optional[torch.Tensor],
                keep: Optional[torch.Tensor],
                query_length: int) -> torch.Tensor:
        o = self.self_attn(x, self.self_attn.kv(x), keep)
        x = self.self_ln(x + self.self_output(o))
        if query_length == 0:
            return self._ffn_text(x)
        q = x[:, :query_length]
        if self.has_cross:
            o = self.cross_attn(q, self.cross_attn.kv(vision))
            q = self.cross_ln(q + self.cross_output(o))
        out = self._ffn_query(q)
        if x.shape[1] > query_length:
            out = torch.cat([out, self._ffn_text(x[:, query_length:])], 1)
        return out


class QFormer(nn.Module):
    """The transformer stack over pre-embedded queries and/or text
    (``query_length`` of them queries)."""

    def __init__(self, cfg: QFormerConfig) -> None:
        super().__init__()
        self.input_ln = nn.LayerNorm(cfg.hidden, eps=cfg.ln_eps)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, has_cross=(i % cfg.cross_frequency == 0))
            for i in range(cfg.depth))

    def forward(self, embeds: torch.Tensor, vision: Optional[torch.Tensor],
                keep: Optional[torch.Tensor],
                query_length: int) -> torch.Tensor:
        x = self.input_ln(embeds)
        for layer in self.layers:
            x = layer(x, vision, keep, query_length)
        return x


def _unit(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


class Blip2Retrieval(nn.Module):
    """The ITC/ITM retrieval model. Images are NHWC (BLIP-normalised by
    the caller), as in the JAX package."""

    def __init__(self, cfg: QFormerConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden
        self.vision = BlipVisionEncoder(cfg.vision_cfg)
        self.qformer = QFormer(cfg)
        self.query_tokens = nn.Parameter(
            torch.zeros(cfg.num_query_tokens, d))
        self.word_embeddings = nn.Parameter(torch.zeros(cfg.vocab_size, d))
        self.position_embeddings = nn.Parameter(torch.zeros(cfg.max_pos, d))
        self.vision_projection = nn.Linear(d, cfg.projection_dim)
        self.text_projection = nn.Linear(d, cfg.projection_dim)
        self.itm_head = nn.Linear(d, 2)

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        """As ``nn.Module``'s, except that a state dict without the ITM
        head keeps this model's: HF checkpoints carry the head, the JAX
        package's init creates none (its ITC path never calls it)."""
        sd = dict(state_dict)
        for k, v in self.itm_head.state_dict().items():
            sd.setdefault(f"itm_head.{k}", v)
        return super().load_state_dict(sd, strict, assign)

    def image_embeds(self, pixels: torch.Tensor) -> torch.Tensor:
        """→ unit per-query embeddings, f32 [B, Q, proj]."""
        v = self.vision(pixels)
        q = self.query_tokens.expand(pixels.shape[0], -1, -1)
        out = self.qformer(q, v, None, self.cfg.num_query_tokens)
        return _unit(self.vision_projection(out))

    def text_embeds(self, ids: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ids [B, K] → unit CLS embedding, f32 [B, proj]; ``mask``
        (default ``ids != 0``) marks the keys attended to."""
        ids = ids.long()
        x = self.word_embeddings[ids] \
            + self.position_embeddings[: ids.shape[1]]
        if mask is None:
            mask = ids != 0
        out = self.qformer(x, None, mask.bool()[:, None, None, :], 0)
        return _unit(self.text_projection(out[:, 0]))

    def forward(self, pixels: torch.Tensor, ids: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ITC logits per image [B_img, B_txt]: the max over the query
        tokens."""
        img = self.image_embeds(pixels)
        txt = self.text_embeds(ids, mask)
        return torch.einsum("bqd,td->bqt", img, txt).amax(dim=1)


def init_blip2(cfg: Optional[QFormerConfig] = None, seed: int = 0
               ) -> Blip2Retrieval:
    """Model with deterministic random weights from ``seed``
    (``layers.seeded_init``, a ``torch.Generator``; the patch conv
    counts as a matrix)."""
    return seeded_init(Blip2Retrieval(cfg or QFormerConfig()), seed,
                       (nn.Linear, nn.Conv2d))


# ---------------------------------------------------------------------------
# conversion from HF Blip2ForImageTextRetrieval
# ---------------------------------------------------------------------------

def _t(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().float().numpy()
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def convert_blip2_state_dict(sd: Mapping[str, Any], cfg: QFormerConfig
                             ) -> Dict[str, torch.Tensor]:
    """HF ``Blip2ForImageTextRetrieval`` state dict → this model's. HF's
    Linear and conv weights are already torch's layout, so this is a
    renaming (plus the class and position embeddings' leading 1)."""
    out: Dict[str, torch.Tensor] = {}

    def put(dst: str, src: str) -> None:
        for leaf in ("weight", "bias"):
            out[f"{dst}.{leaf}"] = _t(sd[f"{src}.{leaf}"])

    emb = "vision_model.embeddings"
    put("vision.patch_embedding", f"{emb}.patch_embedding")
    out["vision.class_embedding"] = _t(sd[f"{emb}.class_embedding"]
                                       ).reshape(-1)
    out["vision.position_embedding"] = _t(sd[f"{emb}.position_embedding"])[0]
    for i in range(cfg.vision_depth):
        s, d = f"vision_model.encoder.layers.{i}", f"vision.layers.{i}"
        put(f"{d}.qkv", f"{s}.self_attn.qkv")
        put(f"{d}.projection", f"{s}.self_attn.projection")
        for ln in ("layer_norm1", "layer_norm2"):
            put(f"{d}.{ln}", f"{s}.{ln}")
        for fc in ("fc1", "fc2"):
            put(f"{d}.{fc}", f"{s}.mlp.{fc}")
    put("vision.post_layernorm", "vision_model.post_layernorm")

    out["query_tokens"] = _t(sd["query_tokens"])[0]
    out["word_embeddings"] = _t(sd["embeddings.word_embeddings.weight"])
    out["position_embeddings"] = _t(
        sd["embeddings.position_embeddings.weight"])
    put("qformer.input_ln", "qformer.layernorm")
    for i in range(cfg.depth):
        s, d = f"qformer.encoder.layer.{i}", f"qformer.layers.{i}"
        for proj in ("query", "key", "value"):
            put(f"{d}.self_attn.{proj}", f"{s}.attention.attention.{proj}")
        put(f"{d}.self_output", f"{s}.attention.output.dense")
        put(f"{d}.self_ln", f"{s}.attention.output.LayerNorm")
        if i % cfg.cross_frequency == 0:
            for proj in ("query", "key", "value"):
                put(f"{d}.cross_attn.{proj}",
                    f"{s}.crossattention.attention.{proj}")
            put(f"{d}.cross_output", f"{s}.crossattention.output.dense")
            put(f"{d}.cross_ln", f"{s}.crossattention.output.LayerNorm")
        put(f"{d}.intermediate_query", f"{s}.intermediate_query.dense")
        put(f"{d}.output_query", f"{s}.output_query.dense")
        put(f"{d}.output_query_ln", f"{s}.output_query.LayerNorm")
        if f"{s}.intermediate.dense.weight" in sd:
            put(f"{d}.intermediate", f"{s}.intermediate.dense")
            put(f"{d}.output", f"{s}.output.dense")
            put(f"{d}.output_ln", f"{s}.output.LayerNorm")
    for name in ("vision_projection", "text_projection", "itm_head"):
        put(name, name)
    return out
