"""Pre-LN transformer building blocks (counterpart of
``avede_tpu/models/layers.py``).

Parameter names follow the JAX package's (``q_proj``, ``layer_norm1``,
``mlp.fc1``, ``layers.<i>``) so ``models/convert.py`` maps one onto the
other. Unmasked, non-causal self-attention — every layer of the CLIP
vision tower — goes through the hand-written ``flash_attention_blhd``
when ``use_flash`` is set: the projections' outputs go in as they are,
viewed per head, and its ``[B, L, D]`` output goes to ``out_proj``, with
no cast or transpose copy around it (the JAX package casts to f32 and
transposes for its Pallas kernel; bf16 → f32 is exact, so the values
agree up to accumulation order). Causal text attention stays plain
torch with an f32 softmax, as the JAX package left it to einsum.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import flash_attention_blhd


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    """MHA with bias on q/k/v/out and scale 1/sqrt(head_dim)."""

    def __init__(self, dim: int, num_heads: int,
                 use_flash: bool = False) -> None:
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, length, _ = x.shape
        hd = self.dim // self.num_heads
        heads = (b, length, self.num_heads, hd)
        q = self.q_proj(x).view(heads)
        k = self.k_proj(x).view(heads)
        v = self.v_proj(x).view(heads)
        if self.use_flash and not causal:
            return self.out_proj(flash_attention_blhd(q, k, v))
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, L, hd]
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
        if causal:
            keep = torch.ones(length, length, dtype=torch.bool,
                              device=x.device).tril()
            scores = scores.masked_fill(~keep, torch.finfo(scores.dtype).min)
        out = torch.softmax(scores, dim=-1).to(x.dtype) @ v
        out = out.transpose(1, 2).reshape(b, length, self.dim)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-5, use_flash: bool = False) -> None:
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.self_attn = MultiHeadAttention(dim, num_heads, use_flash)
        self.layer_norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = MLP(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal=causal)
        return x + self.mlp(self.layer_norm2(x))


class Transformer(nn.Module):
    """A stack of pre-LN blocks (``layers.<i>``)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, ln_eps: float = 1e-5,
                 use_flash: bool = False) -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio, ln_eps, use_flash)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        for blk in self.layers:
            x = blk(x, causal=causal)
        return x
