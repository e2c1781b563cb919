"""The yardstick of CLIP's image side: operations and bytes that the
shapes need (the rules and peaks of ``roofline.py``)."""

from __future__ import annotations

from typing import Dict

from .roofline import bound_s


def _grid(cfg: Dict) -> int:
    return cfg["image_size"] // cfg["patch_size"]


def patch_embed_flops(cfg: Dict, frames: int) -> float:
    """The patch projection: 2 operations a multiply-add over every
    patch's ``3·P²`` values into ``vision_dim``."""
    p = cfg["patch_size"]
    return 2.0 * frames * _grid(cfg) ** 2 * 3 * p * p * cfg["vision_dim"]


def patch_embed_bytes(cfg: Dict, frames: int) -> float:
    """One launch over ``frames`` packed I420 frames: each frame's
    ``S·3/2 × S`` bytes read, the bf16 projection ``[3·P², D]`` read once,
    the bf16 tokens ``[G², D]`` written once."""
    s, p, d = cfg["image_size"], cfg["patch_size"], cfg["vision_dim"]
    return (frames * (s * 3 // 2 * s + 2 * _grid(cfg) ** 2 * d)
            + 2 * 3 * p * p * d)


def patch_embed_bound_s(cfg: Dict, frames: int) -> float:
    return bound_s(patch_embed_flops(cfg, frames),
                   patch_embed_bytes(cfg, frames))


def clip_vision_flops(cfg: Dict, frames: int) -> float:
    """CLIP's vision tower over ``frames`` images: the patch projection,
    then per layer qkv, attention, its projection and the 4× MLP, then
    the class token's projection."""
    d = cfg["vision_dim"]
    length = _grid(cfg) ** 2 + 1
    per_layer = (2.0 * length * d * (3 * d + d + 8 * d)
                 + 4.0 * length * length * d)
    return (patch_embed_flops(cfg, frames)
            + frames * (cfg["vision_depth"] * per_layer
                        + 2.0 * d * cfg["projection_dim"]))
