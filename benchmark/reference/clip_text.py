"""Plain f32 reference of OpenAI CLIP's text tower (open_clip
``ViT-B-32``'s text side): token and position embeddings, pre-LN
blocks with causal softmax attention and a quick-GELU MLP, a final
LayerNorm, the hidden state at the end-of-text token (the largest id),
a bias-free projection, normalised to unit length.

Weights are a dict under the names :func:`param_spec` lists (the whole
CLIP model's, since the served engine loads both towers); the text
tower's are read in f32, with TF32 off. ``lowp="fp8"`` rounds every
operand of every product to fp8: the control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .lowp import fp8


def _block(prefix: str, d: int, mlp: int) -> List[Tuple[str, tuple]]:
    out = [(f"{prefix}.layer_norm1.weight", (d,)),
           (f"{prefix}.layer_norm1.bias", (d,))]
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out += [(f"{prefix}.self_attn.{p}.weight", (d, d)),
                (f"{prefix}.self_attn.{p}.bias", (d,))]
    out += [(f"{prefix}.layer_norm2.weight", (d,)),
            (f"{prefix}.layer_norm2.bias", (d,)),
            (f"{prefix}.mlp.fc1.weight", (mlp, d)),
            (f"{prefix}.mlp.fc1.bias", (mlp,)),
            (f"{prefix}.mlp.fc2.weight", (d, mlp)),
            (f"{prefix}.mlp.fc2.bias", (d,))]
    return out


def param_spec(cfg: Dict) -> List[Tuple[str, tuple]]:
    """Every weight of the CLIP model (both towers and the logit scale)
    with its shape, in the served model's state-dict layout."""
    dv, dt, p = cfg["vision_dim"], cfg["text_dim"], cfg["patch_size"]
    tokens = (cfg["image_size"] // p) ** 2 + 1
    out = [("logit_scale", ()),
           ("vision.class_embedding", (dv,)),
           ("vision.position_embedding", (tokens, dv)),
           ("vision.patch_embedding.weight", (dv, 3, p, p)),
           ("vision.pre_layernorm.weight", (dv,)),
           ("vision.pre_layernorm.bias", (dv,))]
    for i in range(cfg["vision_depth"]):
        out += _block(f"vision.encoder.layers.{i}", dv, 4 * dv)
    out += [("vision.post_layernorm.weight", (dv,)),
            ("vision.post_layernorm.bias", (dv,)),
            ("vision.projection.weight", (cfg["projection_dim"], dv)),
            ("text.position_embedding", (cfg["max_text_len"], dt)),
            ("text.token_embedding.weight", (cfg["vocab_size"], dt))]
    for i in range(cfg["text_depth"]):
        out += _block(f"text.encoder.layers.{i}", dt, 4 * dt)
    out += [("text.final_layer_norm.weight", (dt,)),
            ("text.final_layer_norm.bias", (dt,)),
            ("text.projection.weight", (cfg["projection_dim"], dt))]
    return out


class ClipText:
    """The reference text tower over a weight dict (any device; f32)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Dict,
                 lowp: Optional[str] = None) -> None:
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown control precision {lowp!r}")
        self.w = weights
        self.cfg = cfg
        self.round = fp8 if lowp == "fp8" else (lambda t: t)

    def _p(self, name: str) -> torch.Tensor:
        return self.w[f"text.{name}"].float()

    def _lin(self, name: str, x: torch.Tensor, bias: bool = True
             ) -> torch.Tensor:
        y = self.round(x) @ self.round(self._p(f"{name}.weight")).T
        return y + self._p(f"{name}.bias") if bias else y

    def _ln(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self._p(f"{name}.weight"),
                            self._p(f"{name}.bias"), self.cfg["ln_eps"])

    def encode(self, ids: torch.Tensor) -> torch.Tensor:
        """int64 ids [N, L] → unit f32 [N, projection]."""
        cfg, r = self.cfg, self.round
        n, length = ids.shape
        heads, d = cfg["text_heads"], cfg["text_dim"]
        hd = d // heads
        x = self._p("token_embedding.weight")[ids] \
            + self._p("position_embedding")[:length]
        causal = torch.ones(length, length, dtype=torch.bool,
                            device=x.device).tril()
        split = (lambda t: t.view(n, length, heads, hd).transpose(1, 2))
        for i in range(cfg["text_depth"]):
            s = f"encoder.layers.{i}"
            h = self._ln(f"{s}.layer_norm1", x)
            q, k, v = (split(self._lin(f"{s}.self_attn.{p}", h))
                       for p in ("q_proj", "k_proj", "v_proj"))
            a = (r(q) @ r(k).transpose(-1, -2)) / math.sqrt(hd)
            a = a.masked_fill(~causal, torch.finfo(a.dtype).min)
            o = (r(torch.softmax(a, dim=-1)) @ r(v)).transpose(1, 2)
            x = x + self._lin(f"{s}.self_attn.out_proj",
                              o.reshape(n, length, d))
            h = self._lin(f"{s}.mlp.fc1", self._ln(f"{s}.layer_norm2", x))
            x = x + self._lin(f"{s}.mlp.fc2", h * torch.sigmoid(1.702 * h))
        x = self._ln("final_layer_norm", x)
        pooled = x[torch.arange(n, device=x.device), ids.argmax(dim=-1)]
        e = self._lin("projection", pooled, bias=False)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
