"""Plain f32 reference of Kimi-VL-A3B-Instruct as a caption reranker:
MoonViT, the 2×2 merge and projector, and the DeepSeek-V3 style decoder
(MLA, one dense layer, 26 MoE layers), written from the published
equations in plain ``torch`` with TF32 off; it imports nothing of the
port.

- MoonViT: the 14×14 patch conv, the 64×64 position table resized
  bicubically to the patch grid, 27 pre-LN blocks (fused qkv with
  biases; 2-D RoPE on q and k over adjacent pairs, pair ``2j`` by the
  column and ``2j + 1`` by the row at ``θ^(-4j/hd)``; softmax attention;
  tanh-GELU MLP), a final LayerNorm; each 2×2 block of patches merged
  (row-major), LayerNorm(1152) a patch, 4608 → 4608, exact GELU, → 2048.
- The decoder in MLA's expanded form with no cache: ``q_proj``, the
  latent ``c`` and rotary key from ``kv_a_proj_with_mqa``, RMSNorm on
  ``c``, keys and values from ``kv_b_proj``, 1-D RoPE on the 64 rotary
  dims, causal softmax at scale 192^-1/2; layer 0 a dense SwiGLU, layers
  1-26 routed by ``sigmoid(W_g h)``, the top 6 of score plus correction
  bias, weights the chosen scores normalised and times 2.446, plus the
  shared experts as one SwiGLU of width 2816.
- ``teacher_forced`` runs every judged sequence through one layer at a
  time (draw that layer's weights, run, free), so the 16.4 B parameters
  are never held at once. It takes the program's routes in each MoE
  layer, so the logits are compared on the same experts, and returns
  ``route_gap``: how far any served choice's biased score (the
  reference's own, on its own hidden state) lies below the reference's
  sixth best.
- ``generate`` (the control only) decodes greedily with its own routes
  and a per-layer cache of expanded keys and values, drawing the
  weights again at every step.

Departures from the published model, each shared with the program: the
weights are random from the seed (``weights_by_tensor``) in the
program's layout (experts of a layer stacked, the shared SwiGLU's two
halves last, read here as one SwiGLU of width 2816); the decoder's
rotary dims are in rotate-half order (the checkpoint's interleaved order
is a fixed permutation of ``q_proj``'s and ``kv_a_proj_with_mqa``'s
rotary rows); prompt ids come from the port's hash-tokenizer rule and
assumed special ids, and captions are ``tok<id>`` words, until Kimi's
tiktoken vocabulary is in the repository.

``lowp="fp8"`` rounds both operands of every product (weights a matrix
at a time, activations a tensor at a time) to fp8: the control.
"""

from __future__ import annotations

import hashlib
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import weights_by_tensor
from .lowp import fp8

_WORD = re.compile(r"[a-z]+|[0-9]|[^\sa-z0-9]+")


# -- shapes ------------------------------------------------------------

class Dims:
    """The sizes a configuration file gives (published keys at the top
    level, ``vision_config``, ``request``, ``special_token_ids``)."""

    def __init__(self, cfg: Dict) -> None:
        v, r, s = cfg["vision_config"], cfg["request"], \
            cfg["special_token_ids"]
        self.vocab = cfg["vocab_size"]
        self.d = cfg["hidden_size"]
        self.dense = cfg["intermediate_size"]
        self.f = cfg["moe_intermediate_size"]
        self.layers = cfg["num_hidden_layers"]
        self.heads = cfg["num_attention_heads"]
        self.n_routed = cfg["n_routed_experts"]
        self.n_shared = cfg["n_shared_experts"]
        self.k = cfg["num_experts_per_tok"]
        self.n_dense = cfg["first_k_dense_replace"]
        self.scale = cfg["routed_scaling_factor"]
        self.rank = cfg["kv_lora_rank"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope = cfg["qk_rope_head_dim"]
        self.vdim = cfg["v_head_dim"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.vd = v["hidden_size"]
        self.vlayers = v["num_hidden_layers"]
        self.vheads = v["num_attention_heads"]
        self.vmlp = v["intermediate_size"]
        self.patch = v["patch_size"]
        self.table = v["init_pos_emb_height"]
        self.merge = v["merge_kernel_size"][0]
        self.vtheta = v["rope_theta"]
        self.height, self.width = r["image_height"], r["image_width"]
        self.max_new = r["max_new_tokens"]
        self.special = dict(s)
        self.eos = s["im_end_id"]
        self.gh, self.gw = self.height // self.patch, self.width // self.patch
        self.image_tokens = (self.gh // self.merge) * (self.gw // self.merge)


def param_spec(cfg: Dict) -> List[Tuple[str, tuple]]:
    """Every weight with its shape, in the served model's state-dict
    layout and order."""
    m = Dims(cfg)
    out: List[Tuple[str, tuple]] = [
        ("vision_tower.patch_embed.proj.weight", (m.vd, 3, m.patch, m.patch)),
        ("vision_tower.patch_embed.proj.bias", (m.vd,)),
        ("vision_tower.patch_embed.pos_emb", (m.table, m.table, m.vd))]
    for i in range(m.vlayers):
        p = f"vision_tower.blocks.{i}"
        out += [(f"{p}.norm0.weight", (m.vd,)), (f"{p}.norm0.bias", (m.vd,)),
                (f"{p}.wqkv.weight", (3 * m.vd, m.vd)),
                (f"{p}.wqkv.bias", (3 * m.vd,)),
                (f"{p}.wo.weight", (m.vd, m.vd)), (f"{p}.wo.bias", (m.vd,)),
                (f"{p}.norm1.weight", (m.vd,)), (f"{p}.norm1.bias", (m.vd,)),
                (f"{p}.mlp.fc0.weight", (m.vmlp, m.vd)),
                (f"{p}.mlp.fc0.bias", (m.vmlp,)),
                (f"{p}.mlp.fc1.weight", (m.vd, m.vmlp)),
                (f"{p}.mlp.fc1.bias", (m.vd,))]
    wide = m.vd * m.merge ** 2
    out += [("vision_tower.final_layernorm.weight", (m.vd,)),
            ("vision_tower.final_layernorm.bias", (m.vd,)),
            ("multi_modal_projector.pre_norm.weight", (m.vd,)),
            ("multi_modal_projector.pre_norm.bias", (m.vd,)),
            ("multi_modal_projector.linear_1.weight", (wide, wide)),
            ("multi_modal_projector.linear_1.bias", (wide,)),
            ("multi_modal_projector.linear_2.weight", (m.d, wide)),
            ("multi_modal_projector.linear_2.bias", (m.d,)),
            ("model.embed_tokens.weight", (m.vocab, m.d))]
    n = m.n_routed + m.n_shared
    for i in range(m.layers):
        p = f"model.layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (m.d,)),
                (f"{p}.self_attn.q_proj.weight",
                 (m.heads * (m.nope + m.rope), m.d)),
                (f"{p}.self_attn.kv_a_proj_with_mqa.weight",
                 (m.rank + m.rope, m.d)),
                (f"{p}.self_attn.kv_a_layernorm.weight", (m.rank,)),
                (f"{p}.self_attn.kv_b_proj.weight",
                 (m.heads * (m.nope + m.vdim), m.rank)),
                (f"{p}.self_attn.o_proj.weight", (m.d, m.heads * m.vdim)),
                (f"{p}.post_attention_layernorm.weight", (m.d,))]
        if i < m.n_dense:
            out += [(f"{p}.mlp.gate_proj.weight", (m.dense, m.d)),
                    (f"{p}.mlp.up_proj.weight", (m.dense, m.d)),
                    (f"{p}.mlp.down_proj.weight", (m.d, m.dense))]
        else:
            out += [(f"{p}.mlp.gate.weight", (m.n_routed, m.d)),
                    (f"{p}.mlp.gate.e_score_correction_bias", (m.n_routed,)),
                    (f"{p}.mlp.experts.w_gate", (n, m.f, m.d)),
                    (f"{p}.mlp.experts.w_up", (n, m.f, m.d)),
                    (f"{p}.mlp.experts.w_down", (n, m.d, m.f))]
    out += [("model.norm.weight", (m.d,)),
            ("lm_head.weight", (m.vocab, m.d))]
    return out


# -- text ----------------------------------------------------------------

def hash_ids(text: str, vocab: int) -> List[int]:
    """The port's hash tokenizer: lowercase words, digits one at a time,
    other runs of symbols whole; each piece's md5 → ``4 + h % (V - 8)``."""
    out = []
    for piece in _WORD.findall(" ".join(text.split()).lower()):
        h = int.from_bytes(hashlib.md5(piece.encode()).digest()[:4], "big")
        out.append(4 + h % (vocab - 8))
    return out


def prompt(cfg: Dict) -> Tuple[List[int], List[int]]:
    """The ids before and after the image tokens: the system turn, the
    user's turn with the image and the request, the assistant's turn
    opened."""
    m = Dims(cfg)
    s, v = m.special, m.vocab
    before = ([s["im_system_id"]] + hash_ids("system", v)
              + [s["im_middle_id"]] + hash_ids("You are a helpful assistant",
                                               v)
              + [s["im_end_id"], s["im_user_id"]] + hash_ids("user", v)
              + [s["im_middle_id"]])
    after = (hash_ids("Describe this video frame in one sentence.", v)
             + [s["im_end_id"], s["im_assistant_id"]]
             + hash_ids("assistant", v) + [s["im_middle_id"]])
    return before, after


def caption(ids, eos: int) -> str:
    """Generated ids → the caption: ``tok<id>`` for each id above 3 up to
    the first eos, or "image content" when none."""
    words = []
    for t in ids:
        if int(t) == eos:
            break
        if int(t) > 3:
            words.append(f"tok{int(t)}")
    return " ".join(words) or "image content"


def clip_ids(bpe, texts: List[str], context: int) -> np.ndarray:
    """CLIP's BPE ids of texts that may hold digits (captions): letters
    in runs, each digit alone, as CLIP's word pattern splits them."""
    out = np.zeros((len(texts), context), np.int64)
    for n, text in enumerate(texts):
        ids = [i for w in _WORD.findall(" ".join(text.split()).lower())
               for i in bpe.word(w)]
        ids = [bpe.sot] + ids[:context - 2] + [bpe.eot]
        out[n, :len(ids)] = ids
    return out


# -- the model -----------------------------------------------------------

class Weights:
    """A spec's tensors drawn again on request (``weights_by_tensor``, the
    program's dtype, then f32), fp8-rounded for the control."""

    def __init__(self, cfg: Dict, seed: int, device, dtype: torch.dtype,
                 lowp: Optional[str] = None) -> None:
        self.spec = {n: (i, s) for i, (n, s) in enumerate(param_spec(cfg))}
        self.seed, self.device, self.dtype = seed, device, dtype
        self.lowp = lowp

    def get(self, prefix: str) -> Dict[str, torch.Tensor]:
        out = {}
        for name, (i, shape) in self.spec.items():
            if not name.startswith(prefix):
                continue
            w = weights_by_tensor.draw(name, shape, i, self.seed, self.device,
                                       self.dtype).float()
            if self.lowp == "fp8" and len(shape) >= 2:
                w = (torch.stack([fp8(x) for x in w]) if len(shape) == 3
                     else fp8(w))
            out[name[len(prefix):]] = w
        return out


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rope_half(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device).float() / d)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    shape = [1] * (x.dim() - 2) + list(cos.shape)
    if x.dim() == 4:               # [N, t, H, d]: broadcast over heads
        shape = [1, cos.shape[0], 1, cos.shape[1]]
    cos, sin = cos.view(shape), sin.view(shape)
    a, b = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


class KimiRef:
    def __init__(self, cfg: Dict, weights: Weights,
                 lowp: Optional[str] = None) -> None:
        if lowp not in (None, "fp8"):
            raise ValueError(f"unknown control precision {lowp!r}")
        self.m = Dims(cfg)
        self.w = weights
        self.r = fp8 if lowp == "fp8" else (lambda t: t)

    def _lin(self, x, w, b=None):
        y = self.r(x) @ w.T
        return y + b if b is not None else y

    # -- vision --
    def image_embeds(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised f32 pixels [N, H, W, 3] → image tokens [N, Ti, D]."""
        m, w = self.m, self.w.get("vision_tower.")
        x = F.conv2d(self.r(pixels.permute(0, 3, 1, 2)),
                     w["patch_embed.proj.weight"], w["patch_embed.proj.bias"],
                     stride=m.patch)
        n, d, gh, gw = x.shape
        table = w["patch_embed.pos_emb"]
        if (gh, gw) != tuple(table.shape[:2]):
            table = F.interpolate(table.permute(2, 0, 1)[None], size=(gh, gw),
                                  mode="bicubic", align_corners=False
                                  )[0].permute(1, 2, 0)
        x = x.flatten(2).transpose(1, 2) + table.reshape(gh * gw, d)
        hd = d // m.vheads
        freqs = 1.0 / m.vtheta ** (torch.arange(0, hd, 4, device=x.device)
                                   [: hd // 4].float() / hd)
        idx = torch.arange(gh * gw, device=x.device)
        ang = torch.stack([(idx % gw)[:, None] * freqs,
                           (idx // gw)[:, None] * freqs], -1).flatten(1)
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

        def rope(t):                                  # [n, L, H, hd]
            t2 = t.unflatten(-1, (-1, 2))
            a, b = t2[..., 0], t2[..., 1]
            return torch.stack([a * cos - b * sin, a * sin + b * cos],
                               -1).flatten(-2)

        for i in range(m.vlayers):
            p = f"blocks.{i}."
            h = F.layer_norm(x, (d,), w[p + "norm0.weight"],
                             w[p + "norm0.bias"], 1e-5)
            q, k, v = self._lin(h, w[p + "wqkv.weight"], w[p + "wqkv.bias"]
                                ).view(n, gh * gw, 3, m.vheads, hd).unbind(2)
            q, k = rope(q), rope(k)
            o = torch.empty_like(q)
            for j in range(n):        # one frame's scores at a time
                s = (self.r(q[j]).transpose(0, 1)
                     @ self.r(k[j]).permute(1, 2, 0)) / math.sqrt(hd)
                o[j] = (self.r(torch.softmax(s, -1))
                        @ self.r(v[j]).transpose(0, 1)).transpose(0, 1)
            x = x + self._lin(o.reshape(n, gh * gw, d), w[p + "wo.weight"],
                              w[p + "wo.bias"])
            h = F.layer_norm(x, (d,), w[p + "norm1.weight"],
                             w[p + "norm1.bias"], 1e-5)
            h = F.gelu(self._lin(h, w[p + "mlp.fc0.weight"],
                                 w[p + "mlp.fc0.bias"]), approximate="tanh")
            x = x + self._lin(h, w[p + "mlp.fc1.weight"], w[p + "mlp.fc1.bias"])
        x = F.layer_norm(x, (d,), w["final_layernorm.weight"],
                         w["final_layernorm.bias"], 1e-5)
        g = m.merge
        x = x.view(n, gh // g, g, gw // g, g, d).permute(0, 1, 3, 2, 4, 5)
        pw = self.w.get("multi_modal_projector.")
        x = F.layer_norm(x, (d,), pw["pre_norm.weight"], pw["pre_norm.bias"],
                         1e-5).reshape(n, -1, g * g * d)
        x = F.gelu(self._lin(x, pw["linear_1.weight"], pw["linear_1.bias"]))
        return self._lin(x, pw["linear_2.weight"], pw["linear_2.bias"])

    # -- decoder --
    def embed(self, ids: torch.Tensor, image: torch.Tensor, at: int
              ) -> torch.Tensor:
        table = self.w.get("model.embed_tokens.")["weight"]
        x = table[ids]
        x[:, at:at + image.shape[1]] = image
        return x

    def _attention(self, w, x, start, cache):
        m = self.m
        n, t, _ = x.shape
        pos = torch.arange(start, start + t, device=x.device)
        q = self._lin(x, w["self_attn.q_proj.weight"]).view(
            n, t, m.heads, m.nope + m.rope)
        kv = self._lin(x, w["self_attn.kv_a_proj_with_mqa.weight"])
        c = _rms(kv[..., :m.rank], w["self_attn.kv_a_layernorm.weight"], m.eps)
        k_pe = _rope_half(kv[..., m.rank:], pos, m.theta)
        kvb = self._lin(c, w["self_attn.kv_b_proj.weight"]).view(
            n, t, m.heads, m.nope + m.vdim)
        k = torch.cat([kvb[..., :m.nope],
                       k_pe[:, :, None].expand(-1, -1, m.heads, -1)], -1)
        v = kvb[..., m.nope:]
        q = torch.cat([q[..., :m.nope], _rope_half(q[..., m.nope:], pos,
                                                   m.theta)], -1)
        if cache is not None:
            if "k" in cache:
                k = torch.cat([cache["k"], k], 1)
                v = torch.cat([cache["v"], v], 1)
            cache["k"], cache["v"] = k, v
        total = k.shape[1]
        keep = (torch.arange(total, device=x.device)[None, :]
                <= pos[:, None])                       # [t, total]
        o = torch.empty(n, t, m.heads, m.vdim, device=x.device)
        for j in range(0, n, 8):
            s = (self.r(q[j:j + 8]).transpose(1, 2)
                 @ self.r(k[j:j + 8]).permute(0, 2, 3, 1)) \
                * (m.nope + m.rope) ** -0.5
            s = s.masked_fill(~keep, float("-inf"))
            o[j:j + 8] = (self.r(torch.softmax(s, -1))
                          @ self.r(v[j:j + 8]).transpose(1, 2)).transpose(1, 2)
        return self._lin(o.reshape(n, t, -1), w["self_attn.o_proj.weight"])

    def _swiglu(self, x, wg, wu, wd):
        return self._lin(F.silu(self._lin(x, wg)) * self._lin(x, wu), wd)

    def _moe(self, w, h, routes):
        """h [M, D] → (output, own choices [M, k], route_gap)."""
        m = self.m
        s = torch.sigmoid(self._lin(h, w["mlp.gate.weight"]))
        biased = s + w["mlp.gate.e_score_correction_bias"]
        top = torch.topk(biased, m.k, dim=-1)
        chosen = top.indices if routes is None else routes.long()
        gap = (top.values[:, -1:] - biased.gather(1, chosen)).clamp_min(0)
        wt = s.gather(1, chosen)
        wt = wt / wt.sum(-1, keepdim=True) * m.scale
        wg, wu, wd = (w[f"mlp.experts.{n}"] for n in ("w_gate", "w_up",
                                                       "w_down"))
        y = torch.zeros_like(h)
        for e in chosen.unique().tolist():
            tok, j = (chosen == e).nonzero(as_tuple=True)
            y.index_add_(0, tok, self._swiglu(h[tok], wg[e], wu[e], wd[e])
                         * wt[tok, j, None])
        sh = slice(m.n_routed, m.n_routed + m.n_shared)
        y = y + self._swiglu(h, wg[sh].flatten(0, 1), wu[sh].flatten(0, 1),
                             wd[sh].permute(1, 0, 2).flatten(1))
        return y, top.indices, float(gap.max()) if gap.numel() else 0.0

    def layer(self, i: int, w: Dict[str, torch.Tensor], x: torch.Tensor,
              start: int, cache: Optional[dict] = None,
              routes: Optional[torch.Tensor] = None):
        """Decoder layer ``i`` on x [N, t, D] at positions start..; →
        (x, own choices [N, t, k] or None, route_gap)."""
        m = self.m
        x = x + self._attention(w, _rms(x, w["input_layernorm.weight"],
                                        m.eps), start, cache)
        h = _rms(x, w["post_attention_layernorm.weight"], m.eps)
        n, t, d = h.shape
        if i < m.n_dense:
            return x + self._swiglu(h, w["mlp.gate_proj.weight"],
                                    w["mlp.up_proj.weight"],
                                    w["mlp.down_proj.weight"]), None, 0.0
        y, own, gap = self._moe(w, h.reshape(n * t, d),
                                None if routes is None
                                else routes.reshape(n * t, -1))
        return x + y.view(n, t, d), own.view(n, t, -1), gap

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        w = self.w.get("model.norm.")["weight"]
        return self._lin(_rms(x, w, self.m.eps),
                         self.w.get("lm_head.")["weight"])

    def teacher_forced(self, ids: torch.Tensor, image: torch.Tensor, at: int,
                       routes: torch.Tensor, first: int
                       ) -> Tuple[torch.Tensor, float]:
        """ids [N, T] (the prompt and the served ids but the last), the
        served routes [n_moe, N, T, k] → (logits f32 [N, T - first, V] at
        positions first.., the largest route_gap)."""
        x = self.embed(ids, image, at)
        gap = 0.0
        for i in range(self.m.layers):
            w = self.w.get(f"model.layers.{i}.")
            r = None if i < self.m.n_dense else routes[i - self.m.n_dense]
            x, _, g = self.layer(i, w, x, 0, None, r)
            gap = max(gap, g)
            del w
        return self._head(x[:, first:]), gap

    def generate(self, ids: torch.Tensor, image: torch.Tensor, at: int,
                 max_new: int, eos: int) -> Dict[str, torch.Tensor]:
        """Greedy decoding with its own routes (the control): ``ids``,
        ``logits`` (each chosen id's), ``routes`` [n_moe, N, T + n - 1, k]."""
        m = self.m
        caches = [dict() for _ in range(m.layers)]
        x, start = self.embed(ids, image, at), 0
        out, best, routes = [], [], [[] for _ in range(m.layers - m.n_dense)]
        done = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)
        for step in range(max_new):
            if step:
                table = self.w.get("model.embed_tokens.")["weight"]
                x, start = table[out[-1]][:, None], ids.shape[1] + step - 1
            for i in range(m.layers):
                x, own, _ = self.layer(i, self.w.get(f"model.layers.{i}."), x,
                                       start, caches[i])
                if own is not None:
                    routes[i - m.n_dense].append(own)
            val, tok = self._head(x[:, -1]).max(-1)
            tok = torch.where(done, torch.full_like(tok, eos), tok)
            done = done | (tok == eos)
            out.append(tok)
            best.append(val)
        return {"ids": torch.stack(out, 1), "logits": torch.stack(best, 1),
                "routes": torch.stack([torch.cat(r, 1) for r in routes]
                                      ).to(torch.uint8)}


def preprocess(frames: torch.Tensor, height: int, width: int
               ) -> torch.Tensor:
    """uint8 [N, H, W, 3] → f32 [N, height, width, 3]: /255, an
    antialiased bicubic resize, then (x - 0.5) / 0.5."""
    x = F.interpolate((frames.float() / 255.0).permute(0, 3, 1, 2),
                      size=(height, width), mode="bicubic", antialias=True,
                      align_corners=False).permute(0, 2, 3, 1)
    return (x - 0.5) / 0.5
