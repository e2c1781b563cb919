"""Cosine scoring + top-k over embedding tables (counterpart of
``avede_tpu/ops/similarity.py``).

The scoring product goes through the hand-written ``cosine_scores``
kernel (``ops/kernels.py``), which also writes -inf for padded rows.
``lax.top_k`` breaks ties by taking the lower index first and
``torch.topk`` promises no order, so top-k here is a stable descending
sort: equal scores keep index order, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import kernels

_NEG_INF = float("-inf")


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def cosine_scores(frame_emb: torch.Tensor, query_emb: torch.Tensor,
                  normalize: bool = False) -> torch.Tensor:
    """``[N, D] × [Q, D] → [N, Q]`` cosine similarities (``[N]`` for a
    ``[D]`` query). Embeddings are expected unit-norm unless
    ``normalize``."""
    f, q = frame_emb.float(), query_emb.float()
    if normalize:
        f, q = l2_normalize(f), l2_normalize(q)
    return kernels.cosine_scores(f.contiguous(), q.contiguous())


def topk_scores(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values, indices) along the last axis, ties to the lower
    index (``lax.top_k`` order); k is clipped to the axis length."""
    k = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_topk(scores: torch.Tensor, valid: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k ignoring padded entries (``valid`` bool mask → -inf)."""
    return topk_scores(torch.where(valid, scores,
                                   torch.full_like(scores, _NEG_INF)), k)


def _window_scores(scores: torch.Tensor, middle_idx: torch.Tensor
                   ) -> torch.Tensor:
    """Gather window-middle rows of ``scores`` ([N] or [N, Q]); padded
    windows (index -1) score -inf."""
    w = scores[middle_idx.clamp(min=0).long()]
    w_valid = middle_idx >= 0
    if w.dim() == 2:
        w_valid = w_valid[:, None]
    return torch.where(w_valid, w, torch.full_like(w, _NEG_INF))


def window_topk(frame_emb: torch.Tensor, valid: torch.Tensor,
                query_emb: torch.Tensor, middle_idx: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase-1 core: score every frame (padded rows -inf), gather window
    middles, return top-k (scores, window indices).

    frame_emb [N, D] unit-norm f32, valid [N] bool, query_emb [D],
    middle_idx [W] int (-1 = padding)."""
    scores = kernels.cosine_scores(frame_emb, query_emb.float(), valid)
    return topk_scores(_window_scores(scores, middle_idx), k)


def window_topk_multi(frame_emb: torch.Tensor, valid: torch.Tensor,
                      query_emb: torch.Tensor, middle_idx: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-query phase-1 core: one ``[N, D] × [Q, D]`` scoring launch,
    window gather, per-query top-k → ([Q, k] scores, [Q, k] indices)."""
    scores = kernels.cosine_scores(frame_emb, query_emb.float(), valid)
    return topk_scores(_window_scores(scores, middle_idx).T, k)


def pad_table(emb: np.ndarray, middle_idx: np.ndarray,
              buckets: Sequence[int]):
    """Pad a frame-embedding table and its window indices to bucket
    sizes → (emb [Nb, D], valid [Nb] bool, middle_idx [Wb] int32 with
    -1 padding). Host-side numpy."""

    def bucket(n):
        for b in buckets:
            if n <= b:
                return b
        return n

    n, d = emb.shape
    nb = bucket(n)
    out = np.zeros((nb, d), emb.dtype)
    out[:n] = emb
    valid = np.zeros((nb,), bool)
    valid[:n] = True
    w = len(middle_idx)
    wb = bucket(w)
    mids = np.full((wb,), -1, np.int32)
    mids[:w] = middle_idx
    return out, valid, mids


def make_query_window_topk(model):
    """Serving program: token ids → text tower → unit-norm query →
    score the table (kernel) → window gather → top-k.

    Returns ``fn(ids [1, L], emb, valid, mids, k) → (vals [k], idx [k],
    text_emb [D])``; the text embedding comes back too so the caller's
    per-text LRU stays warm."""

    @torch.inference_mode()
    def run(ids, frame_emb, valid, middle_idx, k):
        q = model.encode_text(ids)[0].float()
        vals, idx = window_topk(frame_emb, valid, q, middle_idx, k)
        return vals, idx, q

    return run
