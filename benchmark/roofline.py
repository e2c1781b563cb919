"""The yardstick: operations and bytes that the shapes need, and the
card's published peaks.

Counts follow the work a computation's shapes need, whatever computes
it: no extra passes an implementation chooses for accuracy, each input
byte read once and each output byte written once. Matrix products count
2 operations a multiply-add; LayerNorm, softmax and activations are not
counted.

Peaks: NVIDIA H100 SXM data sheet, dense, no sparsity, at the full
700 W; a run records the card's own power limit beside its numbers.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12      # dense bf16 tensor cores, FLOP/s
PEAK_HBM_BYTES = 3.35e12      # HBM3, bytes/s


def bound_s(flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least seconds the card could take: the larger of the
    operations at the bf16 peak and the bytes at the memory peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# -- flash attention ---------------------------------------------------

def flash_flops(b: int, h: int, length: int, hd: int) -> float:
    """S = Q·Kᵀ and O = P·V: 4·B·H·L²·hd."""
    return 4.0 * b * h * length * length * hd


def flash_bytes(b: int, h: int, length: int, hd: int,
                elem: int = 2) -> float:
    """q, k and v read once, o written once."""
    return 4.0 * b * length * h * hd * elem


def flash_bound_s(b: int, h: int, length: int, hd: int) -> float:
    return bound_s(flash_flops(b, h, length, hd),
                   flash_bytes(b, h, length, hd))


# -- library scan ------------------------------------------------------

TIER_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def topk_bytes(rows: int, dim: int, tier: str, k: int = 0) -> float:
    """One scan of a ``[rows, dim]`` table for one f32 query: the table,
    its one-byte valid mask, int8's f32 row scales, the query, and k
    (f32 score, int64 row) pairs out."""
    scales = 4 * rows if tier == "int8" else 0
    return (rows * dim * TIER_BYTES[tier] + rows + scales + 4 * dim
            + 12 * k)


def topk_bound_s(rows: int, dim: int, tier: str, k: int = 0) -> float:
    return bound_s(nbytes=topk_bytes(rows, dim, tier, k))


# -- models ------------------------------------------------------------

def _mm(tokens: float, n_in: int, n_out: int) -> float:
    return 2.0 * tokens * n_in * n_out


def vit_flops(cfg: Dict, frames: int) -> float:
    """A BLIP-2 / BLIP vision tower over ``frames`` images: the patch
    conv, then per layer qkv, attention, projection and the MLP."""
    p, d, mlp = cfg["patch_size"], cfg["vision_dim"], cfg["vision_mlp"]
    patches = (cfg["image_size"] // p) ** 2
    length = patches + 1
    conv = _mm(frames * patches, 3 * p * p, d)
    per_layer = (_mm(length, d, 3 * d) + _mm(length, d, d)
                 + _mm(length, d, mlp) + _mm(length, mlp, d)
                 + 4.0 * length * length * d)
    return conv + frames * cfg["vision_depth"] * per_layer


def qformer_image_flops(cfg: Dict, frames: int) -> float:
    """The Q-Former's query side over ``frames`` images' vision tokens,
    and the projection."""
    d, mlp, q = cfg["hidden"], cfg["mlp"], cfg["num_query_tokens"]
    dv = cfg["vision_dim"]
    vis = (cfg["image_size"] // cfg["patch_size"]) ** 2 + 1
    total = 0.0
    for i in range(cfg["depth"]):
        total += _mm(q, d, 3 * d) + 4.0 * q * q * d + _mm(q, d, d)
        if i % cfg["cross_frequency"] == 0:
            total += (_mm(q, d, d) + _mm(vis, dv, 2 * d)
                      + 4.0 * q * vis * d + _mm(q, d, d))
        total += _mm(q, d, mlp) + _mm(q, mlp, d)
    return frames * (total + _mm(q, d, cfg["projection_dim"]))


def qformer_text_flops(cfg: Dict, tokens: int) -> float:
    """The Q-Former's text side over one query of ``tokens`` pieces."""
    d, mlp = cfg["hidden"], cfg["mlp"]
    per_layer = (_mm(tokens, d, 3 * d) + 4.0 * tokens * tokens * d
                 + _mm(tokens, d, d) + _mm(tokens, d, mlp)
                 + _mm(tokens, mlp, d))
    return cfg["depth"] * per_layer + _mm(1, d, cfg["projection_dim"])


def blip2_request_flops(cfg: Dict, frames: int, tokens: int) -> float:
    """One rerank request: ViT-g and the Q-Former's query side over the
    candidates, the text side over the query, the max-over-queries
    scores."""
    return (vit_flops(cfg, frames) + qformer_image_flops(cfg, frames)
            + qformer_text_flops(cfg, tokens)
            + 2.0 * frames * cfg["num_query_tokens"] * cfg["projection_dim"])


def clip_text_flops(cfg: Dict, texts: int = 1) -> float:
    """CLIP's text tower over ``texts`` queries at its full context
    (the shape it runs: every position up to ``max_text_len``); causal
    attention needs half the square."""
    d, length = cfg["text_dim"], cfg["max_text_len"]
    per_layer = (_mm(length, d, 3 * d) + 2.0 * length * length * d
                 + _mm(length, d, d) + _mm(length, d, 4 * d)
                 + _mm(length, 4 * d, d))
    return texts * (cfg["text_depth"] * per_layer
                    + _mm(1, d, cfg["projection_dim"]))
