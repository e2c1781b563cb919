"""Plain f32 reference of BLIP-2's image-text contrastive (ITC) score
(HF ``Blip2ForImageTextRetrieval``, stage-1 retrieval; LAVIS
``blip2_feature_extractor``), from the candidate frames' bytes to the
score of each frame against a query.

- Preprocess: uint8 frames, /255, a bicubic antialiased resize to the
  image size (aspect not kept), the CLIP mean and std.
- EVA ViT-g as HF's BLIP-2 vision model: a biased patch conv, the class
  token, learned positions, pre-LN blocks (fused qkv, softmax attention,
  exact GELU MLP, LayerNorm eps 1e-5), a final LayerNorm.
- Q-Former (BERT, post-LN, eps 1e-12, exact GELU): the learned queries
  self-attend, cross-attend to the vision tokens in every
  ``cross_frequency``-th layer and take the query FFN; the text ([CLS]
  query [SEP]) self-attends and takes the text FFN.
- ITC: the max over the queries of ``img · txt``, both normalised by
  ``norm + 1e-9``.

Weights are a dict of tensors under the names :func:`param_spec` lists;
every one is read in f32, and matrix products run with TF32 off. With
``lowp="fp8"`` every operand of every product is rounded to fp8 first:
that is the control, the same computation one step below bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .lowp import fp8

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _linear(prefix: str, n_out: int, n_in: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight", (n_out, n_in)), (f"{prefix}.bias", (n_out,))]


def _norm(prefix: str, d: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight", (d,)), (f"{prefix}.bias", (d,))]


def param_spec(cfg: Dict) -> List[Tuple[str, tuple]]:
    """Every weight's name and shape, in the layout the served model's
    state dict has."""
    dv, d, p = cfg["vision_dim"], cfg["hidden"], cfg["patch_size"]
    tokens = (cfg["image_size"] // p) ** 2 + 1
    out = [("query_tokens", (cfg["num_query_tokens"], d)),
           ("word_embeddings", (cfg["vocab_size"], d)),
           ("position_embeddings", (cfg["max_pos"], d)),
           ("vision.class_embedding", (dv,)),
           ("vision.position_embedding", (tokens, dv)),
           ("vision.patch_embedding.weight", (dv, 3, p, p)),
           ("vision.patch_embedding.bias", (dv,))]
    for i in range(cfg["vision_depth"]):
        s = f"vision.layers.{i}"
        out += _norm(f"{s}.layer_norm1", dv) + _linear(f"{s}.qkv", 3 * dv, dv)
        out += _linear(f"{s}.projection", dv, dv)
        out += _norm(f"{s}.layer_norm2", dv)
        out += _linear(f"{s}.fc1", cfg["vision_mlp"], dv)
        out += _linear(f"{s}.fc2", dv, cfg["vision_mlp"])
    out += _norm("vision.post_layernorm", dv) + _norm("qformer.input_ln", d)
    for i in range(cfg["depth"]):
        s = f"qformer.layers.{i}"
        for proj in ("query", "key", "value"):
            out += _linear(f"{s}.self_attn.{proj}", d, d)
        out += _linear(f"{s}.self_output", d, d) + _norm(f"{s}.self_ln", d)
        if i % cfg["cross_frequency"] == 0:
            out += _linear(f"{s}.cross_attn.query", d, d)
            out += _linear(f"{s}.cross_attn.key", d, dv)
            out += _linear(f"{s}.cross_attn.value", d, dv)
            out += _linear(f"{s}.cross_output", d, d)
            out += _norm(f"{s}.cross_ln", d)
        out += _linear(f"{s}.intermediate_query", cfg["mlp"], d)
        out += _linear(f"{s}.output_query", d, cfg["mlp"])
        out += _norm(f"{s}.output_query_ln", d)
        out += _linear(f"{s}.intermediate", cfg["mlp"], d)
        out += _linear(f"{s}.output", d, cfg["mlp"])
        out += _norm(f"{s}.output_ln", d)
    out += _linear("vision_projection", cfg["projection_dim"], d)
    out += _linear("text_projection", cfg["projection_dim"], d)
    out += _linear("itm_head", 2, d)
    return out


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-9)


class Blip2ITC:
    """The reference model over a weight dict (any device; f32)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict,
                 lowp: Optional[str] = None) -> None:
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown control precision {lowp!r}")
        self.w = weights
        self.cfg = cfg
        self.round = fp8 if lowp == "fp8" else (lambda t: t)

    def _p(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def _lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        r = self.round
        return r(x) @ r(self._p(f"{name}.weight")).T + self._p(f"{name}.bias")

    def _ln(self, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self._p(f"{name}.weight"),
                            self._p(f"{name}.bias"), eps)

    def _attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                heads: int) -> torch.Tensor:
        """[B, Lq, D] × [B, Lk, D] → softmax attention, [B, Lq, D]."""
        r = self.round
        b, lq, d = q.shape
        hd = d // heads
        split = (lambda t: t.unflatten(-1, (heads, hd)).transpose(1, 2))
        q, k, v = split(q), split(k), split(v)
        s = (r(q) @ r(k).transpose(-1, -2)) / math.sqrt(hd)
        o = r(torch.softmax(s, dim=-1)) @ r(v)
        return o.transpose(1, 2).reshape(b, lq, d)

    # -- image side -----------------------------------------------------
    def preprocess(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 [N, H, W, 3] → f32 [N, 3, S, S], normalised."""
        s = self.cfg["image_size"]
        x = frames.float().permute(0, 3, 1, 2) / 255.0
        if x.shape[-2:] != (s, s):
            x = F.interpolate(x, size=(s, s), mode="bicubic",
                              antialias=True, align_corners=False)
        mean = torch.tensor(CLIP_MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, device=x.device).view(1, 3, 1, 1)
        return (x - mean) / std

    def vision(self, px: torch.Tensor) -> torch.Tensor:
        cfg, r = self.cfg, self.round
        eps, heads = cfg["vision_ln_eps"], cfg["vision_heads"]
        x = F.conv2d(r(px), r(self._p("vision.patch_embedding.weight")),
                     self._p("vision.patch_embedding.bias"),
                     stride=cfg["patch_size"])
        x = x.flatten(2).transpose(1, 2)
        cls = self._p("vision.class_embedding").expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self._p("vision.position_embedding")
        for i in range(cfg["vision_depth"]):
            s = f"vision.layers.{i}"
            q, k, v = self._lin(f"{s}.qkv", self._ln(f"{s}.layer_norm1", x,
                                                     eps)).chunk(3, dim=-1)
            x = x + self._lin(f"{s}.projection",
                              self._attend(q, k, v, heads))
            h = F.gelu(self._lin(f"{s}.fc1",
                                 self._ln(f"{s}.layer_norm2", x, eps)))
            x = x + self._lin(f"{s}.fc2", h)
        return self._ln("vision.post_layernorm", x, eps)

    def _qformer_layer(self, i: int, x: torch.Tensor,
                       vision: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        eps, heads, s = cfg["ln_eps"], cfg["heads"], f"qformer.layers.{i}"
        a = f"{s}.self_attn"
        o = self._attend(self._lin(f"{a}.query", x), self._lin(f"{a}.key", x),
                         self._lin(f"{a}.value", x), heads)
        x = self._ln(f"{s}.self_ln", x + self._lin(f"{s}.self_output", o),
                     eps)
        if vision is None:               # text: the text FFN
            h = self._lin(f"{s}.output",
                          F.gelu(self._lin(f"{s}.intermediate", x)))
            return self._ln(f"{s}.output_ln", x + h, eps)
        if i % cfg["cross_frequency"] == 0:
            c = f"{s}.cross_attn"
            o = self._attend(self._lin(f"{c}.query", x),
                             self._lin(f"{c}.key", vision),
                             self._lin(f"{c}.value", vision), heads)
            x = self._ln(f"{s}.cross_ln",
                         x + self._lin(f"{s}.cross_output", o), eps)
        h = self._lin(f"{s}.output_query",
                      F.gelu(self._lin(f"{s}.intermediate_query", x)))
        return self._ln(f"{s}.output_query_ln", x + h, eps)

    def image_embeds(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 frames [N, H, W, 3] → unit [N, Q, projection]."""
        v = self.vision(self.preprocess(frames))
        x = self._p("query_tokens").expand(v.shape[0], -1, -1)
        x = self._ln("qformer.input_ln", x, self.cfg["ln_eps"])
        for i in range(self.cfg["depth"]):
            x = self._qformer_layer(i, x, v)
        return _unit(self._lin("vision_projection", x))

    # -- text side ------------------------------------------------------
    def text_embed(self, ids: torch.Tensor) -> torch.Tensor:
        """int64 ids [1, K] → unit [projection]."""
        x = self._p("word_embeddings")[ids[0]] \
            + self._p("position_embeddings")[: ids.shape[1]]
        x = self._ln("qformer.input_ln", x[None], self.cfg["ln_eps"])
        for i in range(self.cfg["depth"]):
            x = self._qformer_layer(i, x, None)
        return _unit(self._lin("text_projection", x[:, 0]))[0]

    def scores(self, frames: torch.Tensor, ids: torch.Tensor,
               block: int = 10) -> torch.Tensor:
        """Each frame's ITC score against the query, f32 [N]; the frames
        in blocks of ``block``."""
        txt = self.text_embed(ids)
        out = [(self.image_embeds(frames[i:i + block]) @ txt).amax(dim=1)
               for i in range(0, frames.shape[0], block)]
        return torch.cat(out)
