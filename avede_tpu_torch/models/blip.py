"""BLIP image captioning (counterpart of ``avede_tpu/models/blip.py``):
a ViT vision tower and a BERT-style text decoder with cross-attention,
with greedy and beam-search decoding over a KV cache.

The same architecture, parameter names and numerics as the JAX package
(HF ``BlipForConditionalGeneration``): the vision tower has a biased
16×16 conv patch embedding, a fused ``qkv`` projection, exact (erf) GELU
and LayerNorm eps 1e-5; the text decoder is post-LN with eps 1e-12 and
8 heads at full width. Vision self-attention (unmasked, non-causal,
hd = 64) goes through the hand-written ``flash_attention_blhd`` when
``use_flash`` is set (the serving default), which reads the q, k and v
thirds of the fused ``[B, L, 3D]`` projection in place; its plain
version runs on the CPU. The kernel has no backward, so the trainers
build the model with ``use_flash=False``: plain softmax attention on the
same thirds in the config's dtype, the JAX package's einsum (JAX trains
through no Pallas kernel either). Text attention (causal, or one
query over the cache, or cross-attention over the vision tokens, hd = 96)
stays plain torch with an f32 softmax. Images are NHWC at the public
functions, as in the JAX package.

Decoding: ``generate`` writes each step's keys and values into a
preallocated per-layer cache in place and attends over its first t + 1
positions (JAX masks the rest with ``finfo.min``, which weighs them 0);
the cross-attention keys and values of the vision tokens are computed
once per batch (JAX recomputes the same values every step), the keys
kept in f32, the type the scores are taken in. It stops
once every row has emitted EOS, checked on the host every
``EOS_CHECK_EVERY`` steps: steps after that write PAD, as the rows
already hold, so the tokens equal JAX's ``while_loop``.
``generate_beam`` follows the JAX beam search step for step; its top-k
selections break ties to the lower index, as ``lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention_blhd
from ..ops.kernels import topk_scores
from .layers import masked_softmax_attention, seeded_init

EOS_CHECK_EVERY = 4      # decode steps between host checks for all-EOS

KV = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BlipConfig:
    # vision tower
    image_size: int = 384
    patch_size: int = 16
    vision_dim: int = 768
    vision_depth: int = 12
    vision_heads: int = 12
    vision_mlp: int = 3072
    vision_ln_eps: float = 1e-5         # HF BlipVisionConfig default
    # text decoder (BERT-style, post-LN)
    vocab_size: int = 30524
    text_dim: int = 768
    text_depth: int = 12
    text_heads: int = 8                 # HF BlipTextConfig default, not 12
    text_mlp: int = 3072
    max_pos: int = 512
    text_ln_eps: float = 1e-12
    bos_token_id: int = 30522           # [DEC]
    eos_token_id: int = 102             # [SEP]
    pad_token_id: int = 0
    max_caption_len: int = 50
    dtype: str = "float32"
    use_flash: bool = True   # hand-written flash attention in the vision tower

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def blip_base() -> BlipConfig:
    return BlipConfig()


def tiny_blip_config() -> BlipConfig:
    return BlipConfig(image_size=32, patch_size=8, vision_dim=64,
                      vision_depth=2, vision_heads=4, vision_mlp=128,
                      vocab_size=100, text_dim=64, text_depth=2,
                      text_heads=4, text_mlp=128, max_pos=32,
                      bos_token_id=98, eos_token_id=99,
                      vision_ln_eps=1e-5, max_caption_len=12)


# ---------------------------------------------------------------------------
# vision tower (BLIP flavor: fused qkv, conv bias, no pre-LN)
# ---------------------------------------------------------------------------

class BlipVisionLayer(nn.Module):
    def __init__(self, cfg: BlipConfig) -> None:
        super().__init__()
        d, eps = cfg.vision_dim, cfg.vision_ln_eps
        self.heads = cfg.vision_heads
        self.use_flash = cfg.use_flash
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.qkv = nn.Linear(d, 3 * d)
        self.projection = nn.Linear(d, d)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.vision_mlp)
        self.fc2 = nn.Linear(cfg.vision_mlp, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        # the three thirds of [B, L, 3D], viewed per head without a copy
        q, k, v = (t.unflatten(-1, (self.heads, d // self.heads))
                   for t in self.qkv(self.layer_norm1(x)).chunk(3, dim=-1))
        if self.use_flash:
            o = flash_attention_blhd(q, k, v)
        else:
            o = masked_softmax_attention(
                *(t.transpose(1, 2) for t in (q, k, v))
            ).transpose(1, 2).flatten(2)
        x = x + self.projection(o)
        y = self.fc2(F.gelu(self.fc1(self.layer_norm2(x))))
        return x + y


class BlipVisionEncoder(nn.Module):
    """Pixels [N, S, S, 3] (BLIP-normalized by the caller) → patch-token
    hidden states [N, P + 1, D]."""

    def __init__(self, cfg: BlipConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d, p = cfg.vision_dim, cfg.patch_size
        self.patch_embedding = nn.Conv2d(3, d, p, stride=p)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, d))
        self.layers = nn.ModuleList(BlipVisionLayer(cfg)
                                    for _ in range(cfg.vision_depth))
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.vision_ln_eps)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        dt = self.class_embedding.dtype
        x = self.patch_embedding(pixels.to(dt).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                   # [N, G·G, D]
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding
        for layer in self.layers:
            x = layer(x)
        return self.post_layernorm(x)


# ---------------------------------------------------------------------------
# text decoder (BERT post-LN with cross-attention)
# ---------------------------------------------------------------------------

class BertAttention(nn.Module):
    """``kv_dim``: the width of the tokens keys and values are taken
    from, where it is not the text's (BLIP-2's Q-Former cross-attends
    to 1408-wide ViT-g tokens)."""

    def __init__(self, cfg: BlipConfig, kv_dim: Optional[int] = None
                 ) -> None:
        super().__init__()
        d = cfg.text_dim
        self.heads = cfg.text_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(kv_dim or d, d)
        self.value = nn.Linear(kv_dim or d, d)

    def _split(self, t: torch.Tensor) -> torch.Tensor:
        """[B, L, D] → [B, H, L, hd]."""
        return t.unflatten(-1, (self.heads, -1)).transpose(1, 2)

    def kv(self, src: torch.Tensor) -> KV:
        """Keys and values of ``src`` [B, L, D] → two contiguous
        [B, H, L, hd], the keys in f32 (the type the scores are taken in;
        bf16 → f32 is exact). Laid out once so that a decode step's
        batched products over the vision tokens copy nothing."""
        return (self._split(self.key(src)).float().contiguous(),
                self._split(self.value(src)).contiguous())

    def forward(self, x: torch.Tensor, kv: KV,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        o = masked_softmax_attention(self._split(self.query(x)), *kv, keep)
        return o.transpose(1, 2).flatten(2)


class BlipTextLayer(nn.Module):
    def __init__(self, cfg: BlipConfig) -> None:
        super().__init__()
        d, eps = cfg.text_dim, cfg.text_ln_eps
        self.self_attn = BertAttention(cfg)
        self.self_output = nn.Linear(d, d)
        self.self_ln = nn.LayerNorm(d, eps=eps)
        self.cross_attn = BertAttention(cfg)
        self.cross_output = nn.Linear(d, d)
        self.cross_ln = nn.LayerNorm(d, eps=eps)
        self.intermediate = nn.Linear(d, cfg.text_mlp)
        self.output = nn.Linear(cfg.text_mlp, d)
        self.output_ln = nn.LayerNorm(d, eps=eps)

    def forward(self, x: torch.Tensor, self_kv: KV, cross_kv: KV,
                self_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        o = self.self_attn(x, self_kv, self_keep)
        x = self.self_ln(x + self.self_output(o))
        o = self.cross_attn(x, cross_kv)
        x = self.cross_ln(x + self.cross_output(o))
        y = self.output(F.gelu(self.intermediate(x)))
        return self.output_ln(x + y)


class BlipTextDecoder(nn.Module):
    def __init__(self, cfg: BlipConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.text_dim
        self.word_embeddings = nn.Parameter(torch.zeros(cfg.vocab_size, d))
        self.position_embeddings = nn.Parameter(torch.zeros(cfg.max_pos, d))
        self.embed_ln = nn.LayerNorm(d, eps=cfg.text_ln_eps)
        self.layers = nn.ModuleList(BlipTextLayer(cfg)
                                    for _ in range(cfg.text_depth))
        # prediction head (HF cls.predictions)
        self.transform = nn.Linear(d, d)
        self.transform_ln = nn.LayerNorm(d, eps=cfg.text_ln_eps)
        self.decoder = nn.Linear(d, cfg.vocab_size)

    def _embed(self, ids: torch.Tensor, offset: int) -> torch.Tensor:
        x = self.word_embeddings[ids.long()] \
            + self.position_embeddings[offset: offset + ids.shape[1]]
        return self.embed_ln(x)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        y = self.transform_ln(F.gelu(self.transform(x)))
        return self.decoder(y).float()

    def cross_kv(self, vision: torch.Tensor) -> List[KV]:
        """Every layer's cross-attention keys and values of the vision
        tokens (fixed for a whole decode)."""
        return [layer.cross_attn.kv(vision) for layer in self.layers]

    def forward(self, ids: torch.Tensor, vision: torch.Tensor
                ) -> torch.Tensor:
        """Teacher-forced: ids [B, L] → f32 logits [B, L, V]."""
        x = self._embed(ids, 0)
        length = ids.shape[1]
        keep = torch.ones(length, length, dtype=torch.bool,
                          device=x.device).tril()
        for layer in self.layers:
            x = layer(x, layer.self_attn.kv(x), layer.cross_attn.kv(vision),
                      keep)
        return self._head(x)

    def step(self, ids: torch.Tensor, t: int, caches: List[KV],
             cross: List[KV]) -> torch.Tensor:
        """One decode step at position ``t``: ids [B, 1] → f32 logits
        [B, 1, V]. Writes this step's keys and values into ``caches``
        (per layer [B, H, T, hd], in place) and attends over positions
        ≤ t."""
        x = self._embed(ids, t)
        for layer, (ck, cv), ckv in zip(self.layers, caches, cross):
            k, v = layer.self_attn.kv(x)
            ck[:, :, t] = k[:, :, 0]
            cv[:, :, t] = v[:, :, 0]
            x = layer(x, (ck[:, :, :t + 1], cv[:, :, :t + 1]), ckv)
        return self._head(x)


class BlipCaptioner(nn.Module):
    """Full captioning model: vision tower + text decoder, greedy and
    beam-search decode. ``decode_steps`` holds the number of decoder
    steps the last ``generate`` ran."""

    def __init__(self, cfg: BlipConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.vision = BlipVisionEncoder(cfg)
        self.text = BlipTextDecoder(cfg)
        self.decode_steps = 0

    def forward(self, pixels: torch.Tensor, ids: torch.Tensor
                ) -> torch.Tensor:
        """Teacher-forced logits (parity tests / training)."""
        return self.text(ids, self.vision(pixels))

    def encode_vision(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision(pixels)

    def _caches(self, rows: int, max_len: int, like: torch.Tensor
                ) -> List[KV]:
        cfg = self.cfg
        shape = (rows, cfg.text_heads, max_len,
                 cfg.text_dim // cfg.text_heads)
        return [(like.new_zeros(shape, dtype=torch.float32),
                 like.new_zeros(shape)) for _ in range(cfg.text_depth)]

    def generate(self, pixels: torch.Tensor,
                 max_len: Optional[int] = None) -> torch.Tensor:
        """Greedy caption ids [B, max_len] (int64): BOS first, PAD after
        EOS."""
        cfg = self.cfg
        max_len = max_len or cfg.max_caption_len
        v = self.vision(pixels)
        b = v.shape[0]
        cross = self.text.cross_kv(v)
        caches = self._caches(b, max_len, v)
        tokens = torch.full((b, max_len), cfg.pad_token_id,
                            dtype=torch.long, device=v.device)
        tokens[:, 0] = cfg.bos_token_id
        done = torch.zeros(b, dtype=torch.bool, device=v.device)
        steps = 0
        for t in range(max_len - 1):
            if t and t % EOS_CHECK_EVERY == 0 and bool(done.all()):
                break
            logits = self.text.step(tokens[:, t:t + 1], t, caches, cross)
            nxt = logits[:, 0].argmax(dim=-1)
            nxt = torch.where(done, cfg.pad_token_id, nxt)
            done |= nxt == cfg.eos_token_id
            tokens[:, t + 1] = nxt
            steps += 1
        self.decode_steps = steps
        return tokens

    def generate_beam(self, pixels: torch.Tensor, num_beams: int = 3,
                      max_len: Optional[int] = None,
                      length_penalty: float = 1.0) -> torch.Tensor:
        """Beam-search caption ids [B, max_len] (int64), the JAX
        package's algorithm: a 2K candidate pool per step; EOS
        candidates go to a bank of the K best finished hypotheses by
        ``score / len**length_penalty``, the K best others continue; the
        winner is the best normalized hypothesis over the bank and the
        still-live beams."""
        cfg = self.cfg
        K = num_beams
        max_len = max_len or cfg.max_caption_len
        v = self.vision(pixels)                            # [B, P, D]
        B, dev = v.shape[0], v.device
        cross = [(ck.repeat_interleave(K, 0), cv.repeat_interleave(K, 0))
                 for ck, cv in self.text.cross_kv(v)]
        caches = self._caches(B * K, max_len, v)
        neg = float("-inf")
        tokens = torch.full((B, K, max_len), cfg.pad_token_id,
                            dtype=torch.long, device=dev)
        tokens[:, :, 0] = cfg.bos_token_id
        # only beam 0 is live at t = 0: all beams share the BOS prefix
        scores = torch.full((B, K), neg, device=dev)
        scores[:, 0] = 0.0
        lens = torch.zeros((B, K), dtype=torch.long, device=dev)
        bank_tokens = torch.full_like(tokens, cfg.pad_token_id)
        bank_norm = torch.full((B, K), neg, device=dev)
        batch_off = (torch.arange(B, device=dev) * K)[:, None]

        def rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
            return torch.gather(src, 1, idx[..., None].expand(
                -1, -1, src.shape[-1]))

        def normed(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
            return s / n.clamp(min=1).float() ** length_penalty

        for t in range(max_len - 1):
            cur = tokens[:, :, t].reshape(B * K, 1)
            logits = self.text.step(cur, t, caches, cross)
            logp = torch.log_softmax(logits[:, 0], dim=-1)
            V = logp.shape[-1]
            # dead slots (banked or never seeded) score -inf; K of a 2K
            # pool may end in EOS and K full continuations still advance
            cand = scores[..., None] + logp.reshape(B, K, V)
            cand2, flat2 = topk_scores(cand.reshape(B, K * V),
                                       min(2 * K, K * V))
            src2, tok2 = flat2 // V, flat2 % V
            is_eos2 = tok2 == cfg.eos_token_id

            # bank every EOS candidate of the pool by normalized score
            par_tokens2 = rows(tokens, src2)
            par_tokens2[:, :, t + 1] = tok2
            lens2 = torch.gather(lens, 1, src2) + 1
            fin_norm = torch.where(is_eos2, normed(cand2, lens2), neg)
            bank_norm, bidx = topk_scores(
                torch.cat([bank_norm, fin_norm], 1), K)
            bank_tokens = rows(torch.cat([bank_tokens, par_tokens2], 1),
                               bidx)

            # live beams: the best K non-EOS candidates continue
            scores, lidx = topk_scores(torch.where(is_eos2, neg, cand2), K)
            src = torch.gather(src2, 1, lidx)
            tok = torch.gather(tok2, 1, lidx)
            tokens = rows(tokens, src)
            lens = torch.gather(lens, 1, src) + 1
            gather = (batch_off + src).reshape(B * K)
            caches = [(ck[gather], cv[gather]) for ck, cv in caches]
            tokens[:, :, t + 1] = tok

        all_norm = torch.cat([bank_norm, normed(scores, lens)], 1)
        all_tokens = torch.cat([bank_tokens, tokens], 1)
        best = all_norm.argmax(dim=1)
        return all_tokens[torch.arange(B, device=dev), best]


def init_blip(cfg: Optional[BlipConfig] = None, seed: int = 0
              ) -> BlipCaptioner:
    """Model with deterministic random weights from ``seed``
    (``layers.seeded_init``; the patch conv counts as a matrix)."""
    return seeded_init(BlipCaptioner(cfg or blip_base()), seed,
                       (nn.Linear, nn.Conv2d))
