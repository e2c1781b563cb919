"""The work of a Kimi-VL caption request from its shapes (see
``roofline.py`` for the counting rules): MoonViT over each frame's
patches, the projector, the decoder's prefill over each prompt and its
decode steps through the latent cache, the expert GEMMs' operations and
weight bytes, and the ``lm_head`` at each chosen position.

A configuration is the cell's file (the published keys at the top level,
``vision_config``, ``request``). Matrix products count 2 operations a
multiply-add; causal attention counts half its square; norms,
activations, rotations, softmax and the router's top-k are not counted.
"""

from __future__ import annotations

from typing import Dict

from . import roofline

_mm = roofline._mm


def _grid(cfg: Dict):
    v, r = cfg["vision_config"], cfg["request"]
    p = v["patch_size"]
    return r["image_height"] // p, r["image_width"] // p


def moonvit_flops(cfg: Dict, frames: int) -> float:
    """The patch conv, then per layer qkv, attention (4·L²·D), the output
    projection and the MLP, over ``frames`` frames."""
    v = cfg["vision_config"]
    d, mlp, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    gh, gw = _grid(cfg)
    length = gh * gw
    per_layer = (_mm(length, d, 3 * d) + _mm(length, d, d)
                 + _mm(length, d, mlp) + _mm(length, mlp, d)
                 + 4.0 * length * length * d)
    return frames * (_mm(length, 3 * p * p, d)
                     + v["num_hidden_layers"] * per_layer)


def moonvit_flash_bound_s(cfg: Dict, frames: int) -> float:
    """The least time of MoonViT's attention over ``frames`` frames, a
    launch a layer (``roofline.flash_bound_s``)."""
    v = cfg["vision_config"]
    gh, gw = _grid(cfg)
    heads = v["num_attention_heads"]
    return v["num_hidden_layers"] * roofline.flash_bound_s(
        frames, heads, gh * gw, v["hidden_size"] // heads)


def image_tokens(cfg: Dict) -> int:
    gh, gw = _grid(cfg)
    m = cfg["vision_config"]["merge_kernel_size"][0]
    return (gh // m) * (gw // m)


def projector_flops(cfg: Dict, frames: int) -> float:
    v = cfg["vision_config"]
    wide = v["hidden_size"] * v["merge_kernel_size"][0] ** 2
    t = image_tokens(cfg)
    return frames * (_mm(t, wide, wide) + _mm(t, wide, cfg["hidden_size"]))


def _token_linear(cfg: Dict, layer: int) -> float:
    """The products of one token through decoder layer ``layer`` outside
    attention's scores: MLA's projections and the MLP (a MoE layer its
    router, its chosen experts and the shared ones)."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    rank = cfg["kv_lora_rank"]
    mla = (_mm(1, d, h * (nope + rope)) + _mm(1, d, rank + rope)
           + _mm(1, rank, h * (nope + vd)) + _mm(1, h * vd, d))
    if layer < cfg["first_k_dense_replace"]:
        return mla + 3 * _mm(1, d, cfg["intermediate_size"])
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    return (mla + _mm(1, d, cfg["n_routed_experts"])
            + experts * 3 * _mm(1, d, cfg["moe_intermediate_size"]))


def prefill_flops(cfg: Dict, seqs: int, prompt: int) -> float:
    """Every prompt position through every layer (attention in the
    expanded form, causal), and the ``lm_head`` at the last one."""
    h = cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    attn = h * prompt * prompt * (qk + cfg["v_head_dim"])   # half of 2·T²
    layers = sum(prompt * _token_linear(cfg, i) + attn
                 for i in range(cfg["num_hidden_layers"]))
    return seqs * (layers + _mm(1, cfg["hidden_size"], cfg["vocab_size"]))


def decode_flops(cfg: Dict, seqs: int, prompt: int, steps: int) -> float:
    """``steps`` decode forwards a sequence (position ``prompt + s``),
    attention in the absorbed form over the cache, and the ``lm_head``."""
    h, rank = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    total = 0.0
    for s in range(steps):
        t = prompt + s + 1
        attn = (_mm(h, nope, rank) + _mm(h, rank + rope, t)
                + _mm(h, t, rank) + _mm(h, rank, vd))
        total += sum(_token_linear(cfg, i) + attn
                     for i in range(cfg["num_hidden_layers"]))
        total += _mm(1, cfg["hidden_size"], cfg["vocab_size"])
    return seqs * total


def request_flops(cfg: Dict, frames: int, prompt: int, new_tokens: int
                  ) -> float:
    """One request: ``frames`` captions of ``new_tokens`` ids each."""
    return (moonvit_flops(cfg, frames) + projector_flops(cfg, frames)
            + prefill_flops(cfg, frames, prompt)
            + decode_flops(cfg, frames, prompt, max(new_tokens - 1, 0)))


def expert_flops(cfg: Dict, assignments: float) -> float:
    """The grouped GEMMs of ``assignments`` (token, expert) rows: gate,
    up and down, ``3 · 2·D·F`` each."""
    return assignments * 3 * _mm(1, cfg["hidden_size"],
                                 cfg["moe_intermediate_size"])


def expert_bytes(cfg: Dict, experts: float) -> float:
    """The bf16 weights of ``experts`` experts (gate, up, down), read
    once each."""
    return experts * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] \
        * 2
