"""Pre-LN transformer building blocks (counterpart of
``avede_tpu/models/layers.py``).

Parameter names follow the JAX package's (``q_proj``, ``layer_norm1``,
``mlp.fc1``, ``layers.<i>``) so ``models/convert.py`` maps one onto the
other. Unmasked, non-causal self-attention — every layer of the CLIP
vision tower — goes through a hand-written flash kernel when
``use_flash`` is set. A bf16 model's goes through
``flash_attention_blhd``: the projections' outputs go in as they are,
viewed per head, and its ``[B, L, D]`` output goes to ``out_proj``, with
no cast or transpose copy around it (the JAX package casts to f32 and
transposes for its Pallas kernel; bf16 → f32 is exact, so the values
agree up to accumulation order). An f32 model's goes through the f32
entry ``flash_attention``, transposed to ``[B, H, L, hd]`` and back as
the JAX layer does; any other dtype raises. Causal or masked attention
(the text tower, the grounding head) stays plain torch with an f32
softmax, as the JAX package left it to einsum; masked keys score
``finfo.min``, not ``-inf``, so an all-masked row (a padded window) gets
a uniform softmax as in JAX instead of NaN.

Tensor parallelism (``parallel/train.py::shard_params``, the JAX
package's ``COLUMN_SHARDED`` / ``ROW_SHARDED``): once a rank's
parameters are its slices, ``q_proj``, ``k_proj``, ``v_proj`` and
``fc1`` hold its columns (attention: its ``heads / n_model`` heads),
``out_proj`` and ``fc2`` its rows, and ``tp_group`` is the mesh's model
group. Attention and the MLP then take Megatron's form: "f" at the
region's input (identity forward, the input's gradient all-reduced
backward; without it the LayerNorm and embedding gradients would be one
shard's), the row-sharded product's partial sums all-reduced ("g"),
its bias added once after.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention, flash_attention_blhd
from ..parallel.collectives import copy_to_model, reduce_from_model


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


# flax's ``nn.gelu`` defaults to the tanh approximation; BLIP's exact erf
# GELU is ``F.gelu`` as it is and is applied in ``models/blip.py``
ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "quick_gelu": quick_gelu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}


def seeded_init(model: nn.Module, seed: int,
                matrix_owners: Tuple[type, ...] = (nn.Linear,),
                skip: Tuple[str, ...] = ()) -> nn.Module:
    """Deterministic random weights from ``seed`` (the repo ships no
    pretrained weights), in parameter order: normal(0, fan_in^-1/2) for
    the weights of ``matrix_owners``, normal(0, 0.02) for raw parameters
    (embeddings, positions), unit LayerNorm scales, zero biases;
    parameters named in ``skip`` keep their value."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in skip:
                continue
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) \
                if "." in name else model
            if isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif isinstance(owner, matrix_owners):
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return model


def masked_softmax_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             keep: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain attention on ``[B, H, Lq, hd]`` / ``[B, H, Lk, hd]``: f32
    scores scaled by 1/sqrt(hd), keys where ``keep`` (broadcastable to
    ``[B, H, Lq, Lk]``) is False scored ``finfo.min``, softmax in f32,
    the weights cast to ``v``'s dtype → ``[B, H, Lq, hd]``."""
    s = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if keep is not None:
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    return torch.softmax(s, dim=-1).to(v.dtype) @ v


def _row_parallel(layer: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-sharded ``layer`` on its rank's slice ``x``: the partial
    products summed over ``group``, then the (replicated) bias."""
    return reduce_from_model(F.linear(x, layer.weight), group) + layer.bias


class MultiHeadAttention(nn.Module):
    """MHA with bias on q/k/v/out and scale 1/sqrt(head_dim)."""

    tp_group = None        # the model group once its parameters are shards

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

    def forward(self, x: torch.Tensor, causal: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: bool ``[B, L]``, True = attend to that key."""
        b, length, _ = x.shape
        hd = self.dim // self.num_heads
        width = self.q_proj.weight.shape[0]   # this rank's heads · hd
        heads = (b, length, width // hd, hd)
        if self.tp_group is not None:
            x = copy_to_model(x, self.tp_group)
        q = self.q_proj(x).view(heads)
        k = self.k_proj(x).view(heads)
        v = self.v_proj(x).view(heads)
        if self.use_flash and not causal and mask is None:
            if q.dtype == torch.bfloat16:
                return self._out(flash_attention_blhd(q, k, v))
            if q.dtype != torch.float32:
                raise ValueError(f"use_flash takes a float32 or bfloat16 "
                                 f"model, not {q.dtype}")
            out = flash_attention(*(t.transpose(1, 2).contiguous()
                                    for t in (q, k, v)))    # [B, H, L, hd]
            return self._out(out.transpose(1, 2).reshape(b, length, width))
        keep = None
        if causal:
            keep = torch.ones(length, length, dtype=torch.bool,
                              device=x.device).tril()
        if mask is not None:
            m = mask[:, None, None, :]
            keep = m if keep is None else keep & m
        out = masked_softmax_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                                       keep)                # [B, H, L, hd]
        return self._out(out.transpose(1, 2).reshape(b, length, width))

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return self.out_proj(x)
        return _row_parallel(self.out_proj, x, self.tp_group)


class MLP(nn.Module):
    tp_group = None        # the model group once its parameters are shards

    def __init__(self, dim: int, hidden_dim: int,
                 activation: str = "quick_gelu") -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.act = ACTIVATIONS[activation]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return self.fc2(self.act(self.fc1(x)))
        h = self.act(self.fc1(copy_to_model(x, self.tp_group)))
        return _row_parallel(self.fc2, h, self.tp_group)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + attn(ln1(x)); x + mlp(ln2(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-5, use_flash: bool = False,
                 activation: str = "quick_gelu") -> None:
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.self_attn = MultiHeadAttention(dim, num_heads, use_flash)
        self.layer_norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = MLP(dim, int(dim * mlp_ratio), activation)

    def forward(self, x: torch.Tensor, causal: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal=causal, mask=mask)
        return x + self.mlp(self.layer_norm2(x))


class Transformer(nn.Module):
    """A stack of pre-LN blocks (``layers.<i>``)."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, ln_eps: float = 1e-5,
                 use_flash: bool = False,
                 activation: str = "quick_gelu") -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerBlock(dim, num_heads, mlp_ratio, ln_eps, use_flash,
                             activation)
            for _ in range(depth))

    def forward(self, x: torch.Tensor, causal: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for blk in self.layers:
            x = blk(x, causal=causal, mask=mask)
        return x
