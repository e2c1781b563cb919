"""Cosine scoring + top-k over embedding tables (counterpart of
``avede_tpu/ops/similarity.py``).

The serving functions (``window_topk``, ``window_topk_multi`` and the
program of ``make_query_window_topk``) are one launch of the fused
``cosine_window_topk`` kernel (``ops/kernels.py``): it scores only the
window-middle rows, writes -inf for padded rows and windows, and returns
the top-k in ``lax.top_k``'s order (descending, equal scores lower index
first). ``cosine_scores`` returns scores through the kernel's contract
entry. On the CPU every function runs the plain composition.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .kernels import topk_scores  # noqa: F401  (re-exported)

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


def masked_topk(scores: torch.Tensor, valid: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k ignoring padded entries (``valid`` bool mask → -inf)."""
    return topk_scores(torch.where(valid, scores,
                                   torch.full_like(scores, _NEG_INF)), k)


def window_topk(frame_emb: torch.Tensor, valid: torch.Tensor,
                query_emb: torch.Tensor, middle_idx: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase-1 core: score the window-middle frames (padded rows and
    windows -inf) and return top-k (scores, window indices), in one
    kernel launch.

    frame_emb [N, D] unit-norm f32, valid [N] bool, query_emb [D],
    middle_idx [W] int32 (-1 = padding)."""
    return kernels.cosine_window_topk(frame_emb, valid, query_emb.float(),
                                      middle_idx, k)


def window_topk_multi(frame_emb: torch.Tensor, valid: torch.Tensor,
                      query_emb: torch.Tensor, middle_idx: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-query phase-1 core: one launch scores the window middles
    against ``[Q, D]`` queries and selects per query → ([Q, k] scores,
    [Q, k] window indices)."""
    return kernels.cosine_window_topk(frame_emb, valid, query_emb.float(),
                                      middle_idx, k)


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
    the fused score + window gather + top-k kernel.

    Returns ``fn(ids [1, L], emb, valid, mids, k) → (vals [k], idx [k],
    text_emb [D])``; the text embedding comes back too so the caller's
    per-text LRU stays warm."""

    @torch.inference_mode()
    def run(ids, frame_emb, valid, middle_idx, k):
        q = model.encode_text(ids)[0].float()
        vals, idx = window_topk(frame_emb, valid, q, middle_idx, k)
        return vals, idx, q

    return run
