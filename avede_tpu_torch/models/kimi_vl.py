"""Kimi-VL-A3B-Instruct (Moonshot AI, 2025-04; 16.4 B parameters, 2.8 B
active): the MoonViT vision encoder, its projector, and a DeepSeek-V3
style decoder with latent attention (MLA) and sparse experts. No
counterpart in the JAX package; served as a caption reranker
(``services/captioner.py::KimiVLCaptionService``).

MoonViT (``vision_tower``): a 14×14 conv patch embedding over the whole
native-resolution grid, plus a learned 64×64 position table resized
bicubically to the grid; pre-LN blocks (LayerNorm eps 1e-5) with a fused
qkv (biases), 2-D RoPE on q and k (θ 10,000; rotary pair ``2i, 2i + 1``
of a head turns by the patch's column for even ``i`` and its row for odd
``i``, at frequency ``θ^(-4⌊i/2⌋/hd)``), attention through
``flash_attention_blhd`` (hd 72: the wgmma kernel on the card), a
tanh-GELU MLP; a final LayerNorm. The projector merges each 2×2 block of
patches (row-major inside the block) into one token: LayerNorm(1152) on
each patch, then 4608 → 4608, exact GELU, → 2048.

The decoder (``model``): token embeddings with the image tokens spliced
in at their positions; RMSNorm (eps 1e-5, weight times the normalised
value in the working dtype); MLA without a query LoRA: ``q_proj`` to
H × (128 + 64), ``kv_a_proj_with_mqa`` to the 512-wide latent ``c`` and
one 64-wide rotary key shared by the heads, ``kv_a_layernorm`` on ``c``,
``kv_b_proj`` from ``c`` to H × (128 key + 128 value); 1-D RoPE (θ
800,000, rotate-half pairs ``i, i + 32``) on the 64 rotary dimensions;
softmax scale 192^-1/2, causal. Layer 0's MLP is a dense SwiGLU of width
11,264; layers 1-26 are MoE (``ops/moe.py``): 64 routed experts of width
1408, the top 6 of sigmoid scores plus a correction bias, their scores
normalised and scaled by 2.446, and the 2 shared experts (width 2816 in
all) held as two more experts of width 1408. A final RMSNorm, an untied
``lm_head``.

Generation keeps a **latent cache** a layer, ``[B, T, 576]`` (the
normalised latent and the rotated key, 512 + 64), allocated once for the
prompt and the new tokens. ``prefill`` runs the whole prompt in the
expanded form (keys and values from ``kv_b_proj``) and writes the cache;
each ``decode_step`` attends over the cache in the absorbed form: the
query's nope part times ``W_UK`` gives a 512-wide latent query per head,
which with its rotary part scores against the cache shared by all heads;
``P · c`` times ``W_UV`` gives each head's value, then ``o_proj``. MLA's
products are plain PyTorch (cuBLAS) at these ~600-token contexts.

Parameter names follow the published checkpoint's where they exist; the
experts of a layer are stacked, shared ones last (``mlp.experts.w_gate``,
``w_up`` ``[66, 1408, 2048]``, ``w_down`` ``[66, 2048, 1408]``), as the
grouped expert kernel reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention_blhd
from ..ops.moe import moe_layer
from ..utils.trace import recording, span

# decode steps between the host's reads of "has every sequence ended?"
EOS_CHECK_EVERY = 8

@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    # decoder: the published text config's keys
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    routed_scaling_factor: float = 2.446
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    qk_nope_head_dim: int = 128
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    # MoonViT: the published vision config's
    vision_hidden_size: int = 1152
    vision_layers: int = 27
    vision_heads: int = 16
    vision_intermediate_size: int = 4304
    patch_size: int = 14
    pos_emb_size: int = 64
    merge_kernel: int = 2
    vision_rope_theta: float = 10000.0
    vision_ln_eps: float = 1e-5
    # the served request: the frame's resize, new tokens, special ids
    image_height: int = 504
    image_width: int = 896
    max_new_tokens: int = 32
    im_end_id: int = 163586
    im_user_id: int = 163587
    im_assistant_id: int = 163588
    im_system_id: int = 163594
    im_middle_id: int = 163601
    media_pad_id: int = 163605
    dtype: str = "bfloat16"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.image_height // self.patch_size,
                self.image_width // self.patch_size)

    @property
    def image_tokens(self) -> int:
        gh, gw = self.grid
        return (gh // self.merge_kernel) * (gw // self.merge_kernel)

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @classmethod
    def from_dict(cls, d: Mapping) -> "KimiVLConfig":
        """A configuration file's values (the published keys at the top
        level, ``vision_config``, ``request`` and ``special_token_ids``
        groups); keys it does not know are left out."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        v = d.get("vision_config", {})
        for src, dst in (("hidden_size", "vision_hidden_size"),
                         ("num_hidden_layers", "vision_layers"),
                         ("num_attention_heads", "vision_heads"),
                         ("intermediate_size", "vision_intermediate_size"),
                         ("patch_size", "patch_size"),
                         ("init_pos_emb_height", "pos_emb_size"),
                         ("rope_theta", "vision_rope_theta"),
                         ("layer_norm_eps", "vision_ln_eps")):
            if src in v:
                kw[dst] = v[src]
        if "merge_kernel_size" in v:
            kw["merge_kernel"] = int(v["merge_kernel_size"][0])
        for group in ("request", "special_token_ids"):
            kw.update({k: x for k, x in d.get(group, {}).items()
                       if k in names})
        return cls(**kw)


def tiny_kimi_vl_config(**kw) -> KimiVLConfig:
    """Every part at a CPU test's size: a 2-layer MoonViT of 4 heads of 16
    over a 4×8 grid of 4-px patches (8 image tokens), a 3-layer decoder
    (one dense, two MoE of 8 experts, top 3, 2 shared) over 512 ids."""
    base = dict(vocab_size=512, hidden_size=64, intermediate_size=96,
                moe_intermediate_size=32, num_hidden_layers=3,
                num_attention_heads=4, n_shared_experts=2,
                n_routed_experts=8, routed_scaling_factor=2.446,
                kv_lora_rank=32, qk_rope_head_dim=8, v_head_dim=16,
                qk_nope_head_dim=16, num_experts_per_tok=3,
                vision_hidden_size=64, vision_layers=2, vision_heads=4,
                vision_intermediate_size=96, patch_size=4, pos_emb_size=6,
                image_height=16, image_width=32, max_new_tokens=8,
                im_end_id=500, im_user_id=501, im_assistant_id=502,
                im_system_id=503, im_middle_id=504, media_pad_id=505,
                dtype="float32")
    base.update(kw)
    return KimiVLConfig(**base)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * y.to(x.dtype)


# -- rotary positions --------------------------------------------------

def rotate_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """MoonViT's rotation of adjacent pairs ``(2i, 2i + 1)`` of x's last
    dim by the angles whose cos and sin are given (``[..., hd / 2]``,
    broadcast against x's leading dims), in f32."""
    x2 = x.float().unflatten(-1, (-1, 2))
    a, b = x2[..., 0], x2[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos],
                       dim=-1).flatten(-2).to(x.dtype)


def grid_positions(gh: int, gw: int, device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(row, column) of each patch of a ``gh × gw`` grid, row-major."""
    idx = torch.arange(gh * gw, device=device)
    return idx // gw, idx % gw


def vision_rope(hd: int, gh: int, gw: int, theta: float, device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin ``[gh·gw, hd / 2]`` of MoonViT's 2-D RoPE: pair ``2j``
    turns by the column, pair ``2j + 1`` by the row, both at frequency
    ``theta^(-4j / hd)``."""
    freqs = 1.0 / theta ** (torch.arange(0, hd, 4, device=device)[: hd // 4]
                            .float() / hd)
    rows, cols = grid_positions(gh, gw, device)
    ang = torch.stack([cols[:, None].float() * freqs,
                       rows[:, None].float() * freqs], dim=-1).flatten(1)
    return torch.cos(ang), torch.sin(ang)


def text_rope(dim: int, positions: torch.Tensor, theta: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin ``[T, dim]`` of 1-D RoPE in the rotate-half layout."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=positions.device)
                          .float() / dim)
    ang = positions.float()[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def rotate_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                ) -> torch.Tensor:
    """1-D RoPE on x's last dim (pairs ``i, i + dim / 2``), in f32."""
    xf = x.float()
    h = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., h:], xf[..., :h]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


# -- MoonViT and the projector ----------------------------------------

class MoonViTBlock(nn.Module):
    def __init__(self, cfg: KimiVLConfig) -> None:
        super().__init__()
        d, eps = cfg.vision_hidden_size, cfg.vision_ln_eps
        self.heads = cfg.vision_heads
        self.norm0 = nn.LayerNorm(d, eps=eps)
        self.wqkv = nn.Linear(d, 3 * d)
        self.wo = nn.Linear(d, d)
        self.norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc0 = nn.Linear(d, cfg.vision_intermediate_size)
        self.mlp.fc1 = nn.Linear(cfg.vision_intermediate_size, d)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        n, length, d = x.shape
        qkv = self.wqkv(self.norm0(x)).view(n, length, 3, self.heads, -1)
        # q and k rotated in place, so q, k, v stay the thirds of one
        # buffer at one row stride for the flash entry
        qkv[:, :, :2] = rotate_pairs(qkv[:, :, :2], cos[:, None, None],
                                     sin[:, None, None])
        a = flash_attention_blhd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self.wo(a)
        h = F.gelu(self.mlp.fc0(self.norm1(x)), approximate="tanh")
        return x + self.mlp.fc1(h)


class MoonViT(nn.Module):
    def __init__(self, cfg: KimiVLConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d, p = cfg.vision_hidden_size, cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, p, stride=p)
        self.patch_embed.pos_emb = nn.Parameter(
            torch.zeros(cfg.pos_emb_size, cfg.pos_emb_size, d))
        self.blocks = nn.ModuleList(MoonViTBlock(cfg)
                                    for _ in range(cfg.vision_layers))
        self.final_layernorm = nn.LayerNorm(d, eps=cfg.vision_ln_eps)

    def position_table(self, gh: int, gw: int) -> torch.Tensor:
        """The learned table resized bicubically to the grid → [gh·gw, D]
        (row-major); as it is where the grid is its own size."""
        t = self.patch_embed.pos_emb
        if (gh, gw) != tuple(t.shape[:2]):
            t = F.interpolate(t.permute(2, 0, 1)[None].float(),
                              size=(gh, gw), mode="bicubic",
                              align_corners=False)[0].permute(1, 2, 0)
        return t.reshape(gh * gw, -1).to(self.patch_embed.proj.weight.dtype)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised pixels [N, H, W, 3] → tokens [N, gh·gw, D]."""
        w = self.patch_embed.proj.weight
        x = self.patch_embed.proj(pixels.permute(0, 3, 1, 2).to(w.dtype))
        n, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2) + self.position_table(gh, gw)
        cos, sin = vision_rope(d // self.cfg.vision_heads, gh, gw,
                               self.cfg.vision_rope_theta, x.device)
        for blk in self.blocks:
            x = blk(x, cos, sin)
        return self.final_layernorm(x)


class Projector(nn.Module):
    def __init__(self, cfg: KimiVLConfig) -> None:
        super().__init__()
        d = cfg.vision_hidden_size
        wide = d * cfg.merge_kernel ** 2
        self.merge = cfg.merge_kernel
        self.pre_norm = nn.LayerNorm(d, eps=1e-5)
        self.linear_1 = nn.Linear(wide, wide)
        self.linear_2 = nn.Linear(wide, cfg.hidden_size)

    def forward(self, x: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        """MoonViT tokens [N, gh·gw, D] → image tokens [N, gh·gw / m², H]:
        each m × m block of patches, row-major inside, as one token."""
        n, _, d = x.shape
        m = self.merge
        x = x.view(n, gh // m, m, gw // m, m, d).permute(0, 1, 3, 2, 4, 5)
        x = self.pre_norm(x).reshape(n, (gh // m) * (gw // m), m * m * d)
        return self.linear_2(F.gelu(self.linear_1(x)))


# -- the decoder ------------------------------------------------------

class MLA(nn.Module):
    """Multi-head latent attention (see the module docstring)."""

    def __init__(self, cfg: KimiVLConfig) -> None:
        super().__init__()
        self.h = cfg.num_attention_heads
        self.nope, self.rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.vdim, self.rank = cfg.v_head_dim, cfg.kv_lora_rank
        self.scale = (self.nope + self.rope) ** -0.5
        d = cfg.hidden_size
        self.q_proj = nn.Linear(d, self.h * (self.nope + self.rope),
                                bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, self.rank + self.rope,
                                            bias=False)
        self.kv_a_layernorm = RMSNorm(self.rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(self.rank, self.h * (self.nope + self.vdim),
                                   bias=False)
        self.o_proj = nn.Linear(self.h * self.vdim, d, bias=False)

    def _rotate_latent(self, k_pe: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
        return rotate_half(k_pe, cos, sin)

    def _latent(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] → the cache's rows [B, T, rank + rope]."""
        kv = self.kv_a_proj_with_mqa(x)
        c = self.kv_a_layernorm(kv[..., :self.rank])
        return torch.cat([c, self._rotate_latent(kv[..., self.rank:], cos,
                                                 sin)], dim=-1)

    def _queries(self, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, t, _ = x.shape
        q = self.q_proj(x).view(b, t, self.h, self.nope + self.rope)
        return q[..., :self.nope], rotate_half(q[..., self.nope:],
                                               cos[:, None], sin[:, None])

    def prefill(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cache: torch.Tensor) -> torch.Tensor:
        """The whole prompt x [B, T, D] (positions 0..T-1), expanded form;
        writes the cache's first T rows."""
        b, t, _ = x.shape
        lat = self._latent(x, cos, sin)
        cache[:, :t] = lat
        q_nope, q_pe = self._queries(x, cos, sin)
        kv = self.kv_b_proj(lat[..., :self.rank]).view(
            b, t, self.h, self.nope + self.vdim)
        k = torch.cat([kv[..., :self.nope],
                       lat[..., None, self.rank:].expand(-1, -1, self.h, -1)],
                      dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
        s = (q @ k.permute(0, 2, 3, 1)).float() * self.scale
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = p @ kv[..., self.nope:].transpose(1, 2)          # [B, H, T, v]
        return self.o_proj(o.transpose(1, 2).reshape(b, t, -1))

    def decode(self, x: torch.Tensor, pos: int, cos: torch.Tensor,
               sin: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        """One new token a sequence, x [B, 1, D] at position ``pos``,
        absorbed form over the cache's rows 0..pos (it writes row pos)."""
        b = x.shape[0]
        cache[:, pos:pos + 1] = self._latent(x, cos, sin)
        q_nope, q_pe = self._queries(x, cos, sin)             # [B, 1, H, *]
        w = self.kv_b_proj.weight.view(self.h, self.nope + self.vdim,
                                       self.rank)
        q_lat = torch.bmm(q_nope[:, 0].transpose(0, 1), w[:, :self.nope])
        qf = torch.cat([q_lat.transpose(0, 1), q_pe[:, 0]], dim=-1)
        ctx = cache[:, :pos + 1]                              # [B, T, 576]
        s = torch.bmm(qf, ctx.transpose(1, 2)).float() * self.scale
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o_lat = torch.bmm(p, ctx[..., :self.rank])            # [B, H, rank]
        o = torch.bmm(o_lat.transpose(0, 1),
                      w[:, self.nope:].transpose(1, 2))        # [H, B, v]
        return self.o_proj(o.transpose(0, 1).reshape(b, 1, -1))


class DenseMLP(nn.Module):
    def __init__(self, d: int, width: int) -> None:
        super().__init__()
        self.gate_proj = nn.Linear(d, width, bias=False)
        self.up_proj = nn.Linear(d, width, bias=False)
        self.down_proj = nn.Linear(width, d, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class MoE(nn.Module):
    """Routed experts and the shared ones, stacked (shared last)."""

    def __init__(self, cfg: KimiVLConfig) -> None:
        super().__init__()
        d, f = cfg.hidden_size, cfg.moe_intermediate_size
        n = cfg.n_routed_experts + cfg.n_shared_experts
        self.cfg = cfg
        self.gate = nn.Module()
        self.gate.weight = nn.Parameter(torch.zeros(cfg.n_routed_experts, d))
        self.gate.e_score_correction_bias = nn.Parameter(
            torch.zeros(cfg.n_routed_experts))
        self.experts = nn.Module()
        self.experts.w_gate = nn.Parameter(torch.zeros(n, f, d))
        self.experts.w_up = nn.Parameter(torch.zeros(n, f, d))
        self.experts.w_down = nn.Parameter(torch.zeros(n, d, f))

    def forward(self, x: torch.Tensor, stats: Optional[list] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D] → (output, routed choices int64 [B, T, k])."""
        b, t, d = x.shape
        c, e = self.cfg, self.experts
        y, choice = moe_layer(
            x.reshape(b * t, d), self.gate.weight,
            self.gate.e_score_correction_bias, e.w_gate, e.w_up, e.w_down,
            c.num_experts_per_tok, c.routed_scaling_factor,
            c.n_shared_experts, stats)
        return y.view(b, t, d), choice.view(b, t, -1)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiVLConfig, index: int) -> None:
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = (DenseMLP(cfg.hidden_size, cfg.intermediate_size)
                    if index < cfg.first_k_dense_replace else MoE(cfg))

    def _mlp(self, x: torch.Tensor, routes: Optional[list],
             stats: Optional[list]) -> torch.Tensor:
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            y, choice = self.mlp(h, stats)
            if routes is not None:
                routes.append(choice.to(torch.uint8))
            return x + y
        return x + self.mlp(h)

    def prefill(self, x, cos, sin, cache, routes, stats=None):
        x = x + self.self_attn.prefill(self.input_layernorm(x), cos, sin,
                                       cache)
        return self._mlp(x, routes, stats)

    def decode(self, x, pos, cos, sin, cache, routes, stats=None):
        x = x + self.self_attn.decode(self.input_layernorm(x), pos, cos, sin,
                                      cache)
        return self._mlp(x, routes, stats)


class KimiVL(nn.Module):
    def __init__(self, cfg: KimiVLConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.vision_tower = MoonViT(cfg)
        self.multi_modal_projector = Projector(cfg)
        self.model = nn.Module()
        self.model.embed_tokens = nn.Embedding(cfg.vocab_size,
                                               cfg.hidden_size)
        self.model.layers = nn.ModuleList(
            DecoderLayer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)

    def image_embeds(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised pixels [N, H, W, 3] → image tokens [N, T_img, H]."""
        x = self.vision_tower(pixels)
        gh = pixels.shape[1] // self.cfg.patch_size
        gw = pixels.shape[2] // self.cfg.patch_size
        return self.multi_modal_projector(x, gh, gw)

    def new_cache(self, batch: int, length: int) -> torch.Tensor:
        """The latent cache: [layers, B, length, rank + rope]."""
        c = self.cfg
        w = self.lm_head.weight
        return torch.empty(c.num_hidden_layers, batch, length, c.latent_dim,
                           dtype=w.dtype, device=w.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.model.norm(x)).float()

    def prefill(self, ids: torch.Tensor, image: torch.Tensor, at: int,
                cache: torch.Tensor, stats: Optional[list] = None,
                keep_routes: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """ids [B, P] with the image tokens [B, T_img, H] spliced in from
        position ``at`` → (the last position's logits f32 [B, V], with
        ``keep_routes`` the routes uint8 [n_moe, B, P, k], else None);
        writes the cache's first P rows."""
        x = self.model.embed_tokens(ids)
        x[:, at:at + image.shape[1]] = image.to(x.dtype)
        c = self.cfg
        cos, sin = text_rope(c.qk_rope_head_dim,
                             torch.arange(ids.shape[1], device=ids.device),
                             c.rope_theta)
        routes: Optional[List[torch.Tensor]] = [] if keep_routes else None
        for i, layer in enumerate(self.model.layers):
            x = layer.prefill(x, cos, sin, cache[i], routes, stats)
        return self._logits(x[:, -1]), _stacked(routes)

    def decode_step(self, ids: torch.Tensor, pos: int, cache: torch.Tensor,
                    stats: Optional[list] = None, keep_routes: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """ids [B] at position ``pos`` → (logits f32 [B, V], with
        ``keep_routes`` the routes uint8 [n_moe, B, 1, k], else None)."""
        c = self.cfg
        x = self.model.embed_tokens(ids)[:, None]
        cos, sin = text_rope(c.qk_rope_head_dim,
                             torch.full((1,), pos, device=ids.device),
                             c.rope_theta)
        routes: Optional[List[torch.Tensor]] = [] if keep_routes else None
        for i, layer in enumerate(self.model.layers):
            x = layer.decode(x, pos, cos, sin, cache[i], routes, stats)
        return self._logits(x[:, 0]), _stacked(routes)


def _stacked(routes: Optional[List[torch.Tensor]]) -> Optional[torch.Tensor]:
    return None if routes is None else torch.stack(routes)


def _moe_attrs(sp, stats: Optional[list], n_routed: int) -> None:
    """The phase's expert counters onto its span (read back only while
    spans record): rows computed (shared experts included), experts
    touched, and the routed experts' largest and mean load, each summed
    over the phase's layers and steps."""
    if not stats:
        return
    t = torch.stack(stats).sum(0).tolist()
    sp.attrs.update(assignments=int(t[0]), experts_touched=int(t[1]),
                    max_load=int(t[2]), mean_load=t[3] / n_routed)


def generate(model: KimiVL, ids: torch.Tensor, image: torch.Tensor, at: int,
             max_new: int, eos: int, keep_routes: bool = False
             ) -> Dict[str, torch.Tensor]:
    """Greedy generation for a batch of prompts: ``ids`` / ``image`` as
    ``KimiVL.prefill`` takes them, up to ``max_new`` tokens; stops early
    only when every sequence has emitted ``eos`` (read back every
    ``EOS_CHECK_EVERY`` steps). Returns ``ids`` int64 [B, n] and
    ``logits`` (each chosen id's logit, f32 [B, n]), and with
    ``keep_routes`` ``routes`` (uint8 [n_moe, B, P + n - 1, k]), all on
    the model's device; a sequence's tokens after its eos are eos. Spans
    ``kimi.prefill`` and ``kimi.decode`` (its ``steps``: the decode
    forwards) carry the expert counters."""
    b, p = ids.shape
    n_routed = model.cfg.n_routed_experts
    cache = model.new_cache(b, p + max_new)
    stats = [] if recording() else None
    with span("kimi.prefill") as sp:
        logits, routes = model.prefill(ids, image, at, cache, stats,
                                       keep_routes)
        _moe_attrs(sp, stats, n_routed)
    out, best, all_routes = [], [], [routes]
    done = torch.zeros(b, dtype=torch.bool, device=ids.device)
    stats = [] if recording() else None
    with span("kimi.decode") as sp:
        for step in range(max_new):
            if step:
                logits, r = model.decode_step(out[-1], p + step - 1, cache,
                                              stats, keep_routes)
                all_routes.append(r)
            val, tok = logits.max(dim=-1)
            tok = torch.where(done, torch.full_like(tok, eos), tok)
            out.append(tok)
            best.append(val)
            done = done | (tok == eos)
            if (step + 1) % EOS_CHECK_EVERY == 0 and step + 1 < max_new \
                    and bool(done.all()):
                break
        if stats is not None:
            sp.attrs["steps"] = len(out) - 1
            _moe_attrs(sp, stats, n_routed)
    got = {"ids": torch.stack(out, 1), "logits": torch.stack(best, 1)}
    if keep_routes:
        got["routes"] = torch.cat(all_routes, dim=2)
    return got


# -- weights -----------------------------------------------------------

def _init_rule(name: str, p: torch.Tensor) -> Tuple[str, float]:
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name:
        return ("fill", 1.0 if leaf == "weight" else 0.0)
    if leaf in ("bias", "e_score_correction_bias"):
        return ("fill", 0.0)
    if "embed_tokens" in name or "pos_emb" in name:
        return ("normal", 0.02)
    return ("normal", p[0].numel() ** -0.5 if p.dim() == 2
            else p.shape[-1] ** -0.5 if p.dim() == 3
            else p[0].numel() ** -0.5)


def init_kimi_vl(cfg: KimiVLConfig, seed: int = 0, device="cpu"
                 ) -> KimiVL:
    """A model with deterministic random weights from ``seed``, built on
    the meta device and drawn on ``device`` in the config's dtype (no host
    copy of 16 B parameters): matrices ``N(0, 1/fan_in)`` (an expert's
    fan-in its last dim), embeddings and the position table ``N(0,
    0.02²)``, norm scales 1, biases and the correction bias 0."""
    with torch.device("meta"):
        model = KimiVL(cfg).to(cfg.torch_dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            kind, v = _init_rule(name, p)
            if kind == "fill":
                p.fill_(v)
            else:
                p.copy_(torch.empty(p.shape, device=device).normal_(
                    0.0, v, generator=gen))
    return model.eval()


def state_dict_on(cfg: KimiVLConfig, sd: Mapping[str, torch.Tensor],
                  device) -> KimiVL:
    """A model whose parameters ARE ``sd``'s tensors (no copy), built on
    the meta device; the tensors must be on ``device`` in the config's
    dtype, and every parameter must be there."""
    with torch.device("meta"):
        model = KimiVL(cfg)
    want = cfg.torch_dtype
    for k, v in sd.items():
        if v.device.type != torch.device(device).type or v.dtype != want:
            raise ValueError(f"{k}: {v.dtype} on {v.device}, want {want} on "
                             f"{device}")
    model.load_state_dict(dict(sd), strict=True, assign=True)
    return model.eval()
