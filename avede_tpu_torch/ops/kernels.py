"""Hand-written CUDA kernels of the hot ops, with their plain versions
(counterpart of ``avede_tpu/ops/pallas_kernels.py``).

- ``fused_patch_embed_i420`` and ``fused_patch_embed`` —
  ``csrc/patch_embed.cu``, replacing ``fused_patch_embed`` /
  ``_patch_matmul_kernel`` (``avede_tpu/ops/pallas_kernels.py:61-106``):
  patchify → ``@ W' + b'``, with ``/255`` and the CLIP normalisation
  folded into ``W'`` and ``b'`` (``fold_for_uint8``). The serving entry
  takes packed I420 frames and unpacks them while it builds its GEMM
  tile, returning bf16 tokens; the contract entry takes uint8 or
  0..255 float RGB frames and returns f32. Neither the unpacked image
  nor the patchified matrix exists in device memory. Both run wgmma in
  bf16 ×3 (``split_patch_weights`` splits ``W'`` once) at P = 32 and D a
  multiple of 96, bound by operations on the H100; any other P that
  divides S and any D (the tiny CLIP's P = 8, D = 64) takes the same
  source's second kernel (``mma.sync``, 16 patches × 32 channels a
  block, its whole K staged once) on the same bf16 ×3 operands.
- ``cosine_window_topk`` and ``cosine_topk_f32`` / ``_bf16`` /
  ``_int8`` — ``csrc/cosine_scores.cu``'s serving entries, replacing
  ``cosine_scores_pallas`` / ``_score_kernel`` (``:125-147``) together
  with the top-k the JAX programs run after it: score, select and sort
  on the device, only ``(values [k], indices [k])`` come out. The first
  serves the ``mvp`` query (one launch a call: the window-middle rows
  are gathered as they load); the other three the index's float32,
  bfloat16 and int8 tiers, where every row is a candidate (the tier's
  contract scoring kernel, then radix-select passes over its scores).
  The order is ``topk_scores``': descending, equal scores lower index
  first, -inf last; bit-for-bit ``topk_scores`` of the contract entry's
  scores on the card. Above ``FUSED_MAX_K`` they dispatch, on that
  shape, to the contract entry and ``topk_scores``. Bound by bytes.
- ``cosine_scores``, ``cosine_scores_bf16`` and ``cosine_scores_int8`` —
  the same source's contract entries (the TPU kernel's function: scores
  out, padded rows -inf) for f32 tables and the library index's
  bfloat16 and int8 tables: the query rounded to bf16 for the narrow
  tables, the sum in f32, an int8 row's sum times its f32 scale
  (``avede_tpu/services/library_index.py:83-105``). No serving path
  takes them at the default settings.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel, through ``_build.launch`` on the
tensors' device, or raises. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .preprocess import CLIP_MEAN, CLIP_STD, clip_preprocess_i420

_P = ctypes.c_void_p
_I = ctypes.c_int


def _refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd would record the kernel's call: the kernel
    writes its output through a pointer, so the output has no
    ``grad_fn`` and a gradient through it would be lost without a word.
    No kernel has a backward, as no Pallas kernel of the JAX package has
    one; train through the plain path (``use_flash=False``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its output would drop the gradient "
            f"of an input that requires grad; call it under "
            f"torch.inference_mode() / torch.no_grad(), or train through "
            f"the plain path (use_flash=False)")


def _require_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")


# ---------------------------------------------------------------------------
# fused patch embed
# ---------------------------------------------------------------------------

def fold_for_uint8(kernel: torch.Tensor, mean: np.ndarray = CLIP_MEAN,
                   std: np.ndarray = CLIP_STD
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold /255 + normalize into flattened patch weights.

    kernel: [P, P, 3, D] (HWIO) → (W2 [P·P·3, D], bias_delta [D]) such
    that ``patchify(u8) @ W2 + bias_delta == conv(normalize(u8/255),
    kernel)``."""
    p, _, c, d = kernel.shape
    kernel = kernel.float()
    mean = torch.as_tensor(mean, dtype=torch.float32,
                           device=kernel.device).reshape(1, 1, 3, 1)
    std = torch.as_tensor(std, dtype=torch.float32,
                          device=kernel.device).reshape(1, 1, 3, 1)
    k2 = kernel / (255.0 * std)
    bias_delta = -torch.sum(kernel * mean / std, dim=(0, 1, 2))
    return k2.reshape(p * p * c, d), bias_delta


def _patchify(frames: torch.Tensor, patch: int) -> torch.Tensor:
    """[N, S, S, C] → [N, G·G, P·P·C], patch rows in (py, px, c) order."""
    n, s, _, c = frames.shape
    g = s // patch
    x = frames.reshape(n, g, patch, g, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, g * g, patch * patch * c)


def _k_order(patch: int) -> torch.Tensor:
    """The kernels' K order: position ``j`` of (row pair, channel, row,
    px) → the ``W'`` row (py, px, c) it holds; an odd P's last pair has
    one row."""
    order = []
    for pair in range(0, patch, 2):
        rows = range(pair, min(pair + 2, patch))
        order += [(py * patch + px) * 3 + c
                  for c in range(3) for py in rows for px in range(patch)]
    return torch.tensor(order, dtype=torch.long)


def split_patch_weights(w2: torch.Tensor, patch: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``W'`` [P·P·3, D] (rows in (py, px, c) order) → (w_hi, w_lo), bf16
    [D, P·P·3] with ``w_hi + w_lo ≈ W'`` to about 2^-17 relative: the
    kernels' operands, K-major, with K reordered to (row pair, channel,
    row, px) so that each of the ``wgmma`` kernel's K steps of 64 is one
    channel of two pixel rows."""
    w = w2.float()[_k_order(patch).to(w2.device)].T
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    return hi.contiguous(), lo.contiguous()


def fused_patch_embed_plain(frames: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor, patch: int) -> torch.Tensor:
    """Plain version of the kernel: patchify + ``@ W2 + b2`` in f32."""
    return _patchify(frames.float(), patch) @ w2.float() + b2.float()


def _patch_launch(mode, frames, size, split, b2, out, patch, wrapper):
    """Launch the ``wgmma`` kernel (P = 32, D a multiple of 96) or, for
    any other P and D, the ``mma.sync`` kernel; ``wrapper.launches`` counts
    both, ``wrapper.launches_by_kernel`` each."""
    w_hi, w_lo = split
    d = out.shape[-1]
    if w_hi.shape != (d, patch * patch * 3) or w_lo.shape != w_hi.shape \
            or w_hi.dtype != torch.bfloat16 or w_lo.dtype != torch.bfloat16:
        raise ValueError("split weights must be bf16 [D, P·P·3] from "
                         "split_patch_weights")
    _require_cuda(frames, w_hi, w_lo, b2)
    if b2.dtype != torch.float32:
        raise ValueError("the folded bias must be float32")
    n = frames.shape[0]
    if n == 0:
        return out
    args = [frames.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
            b2.data_ptr(), out.data_ptr(), n, size, d]
    kernel = "wgmma" if patch == 32 and d % 96 == 0 else "mma"
    if kernel == "wgmma":
        name = f"avede_patch_embed_{mode}"
    else:
        name = f"avede_patch_embed_any_{mode}"
        args.append(patch)
    _build.launch(frames.device, "patch_embed", name,
                  [_P] * 5 + [_I] * (len(args) - 5), *args)
    wrapper.launches += 1
    wrapper.launches_by_kernel[kernel] += 1
    return out


def fused_patch_embed(frames: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor, patch: int,
                      split: Optional[Tuple[torch.Tensor, torch.Tensor]]
                      = None) -> torch.Tensor:
    """[N, S, S, 3] frames (uint8 or 0..255 f32) + folded weights
    (``fold_for_uint8``; ``b2`` = model bias + fold delta) → f32
    [N, G·G, D] patch embeddings of the normalized frames. ``split``:
    ``split_patch_weights(w2, patch)``, made here if not given."""
    n, s, s2, c = frames.shape
    k, d = w2.shape
    if s != s2 or c != 3 or s % patch or k != patch * patch * 3 \
            or b2.shape != (d,):
        raise ValueError(f"bad shapes: frames {tuple(frames.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}, "
                         f"patch {patch}")
    if frames.device.type == "cpu":
        return fused_patch_embed_plain(frames, w2, b2, patch)
    if frames.dtype == torch.float32:
        mode = "f32"
    elif frames.dtype == torch.uint8:
        mode = "u8"
    else:
        raise ValueError(f"frames must be float32 or uint8, not "
                         f"{frames.dtype}")
    _require_cuda(frames, w2, b2)
    _refuse_grad("fused_patch_embed", frames, w2, b2, *(split or ()))
    g = s // patch
    out = torch.empty((n, g * g, d), dtype=torch.float32,
                      device=frames.device)
    return _patch_launch(mode, frames, s,
                         split or split_patch_weights(w2, patch), b2, out,
                         patch, fused_patch_embed)


fused_patch_embed.launches = 0
fused_patch_embed.launches_by_kernel = collections.Counter()


def fused_patch_embed_i420_plain(packed: torch.Tensor, w2: torch.Tensor,
                                 b2: torch.Tensor, patch: int,
                                 out_dtype: torch.dtype = torch.bfloat16
                                 ) -> torch.Tensor:
    """Plain version of the I420 entry: the device unpack
    (``clip_preprocess_i420(normalize=False) · 255``), the f32 patch
    product, then a cast to ``out_dtype``."""
    px = clip_preprocess_i420(packed, normalize=False) * 255.0
    return fused_patch_embed_plain(px, w2, b2, patch).to(out_dtype)


def fused_patch_embed_i420(packed: torch.Tensor, w2: torch.Tensor,
                           b2: torch.Tensor, patch: int,
                           split: Optional[Tuple[torch.Tensor, torch.Tensor]]
                           = None, out_dtype: torch.dtype = torch.bfloat16
                           ) -> torch.Tensor:
    """Packed I420 uint8 [N, S·3/2, S] + folded weights → [N, G·G, D]
    patch embeddings of the normalized frames, in ``out_dtype`` (bf16 on
    the card). ``split``: ``split_patch_weights(w2, patch)``, made here
    if not given."""
    n, hp, s = packed.shape
    k, d = w2.shape
    if hp != s * 3 // 2 or s % 4 or s % patch or k != patch * patch * 3 \
            or b2.shape != (d,):
        raise ValueError(f"bad shapes: packed {tuple(packed.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}, "
                         f"patch {patch}")
    if packed.device.type == "cpu":
        return fused_patch_embed_i420_plain(packed, w2, b2, patch, out_dtype)
    if packed.dtype != torch.uint8 or out_dtype != torch.bfloat16:
        raise ValueError("the I420 entry takes uint8 frames and returns "
                         "bfloat16")
    _require_cuda(packed, w2, b2)
    _refuse_grad("fused_patch_embed_i420", packed, w2, b2, *(split or ()))
    g = s // patch
    out = torch.empty((n, g * g, d), dtype=torch.bfloat16,
                      device=packed.device)
    return _patch_launch("i420", packed, s,
                         split or split_patch_weights(w2, patch), b2, out,
                         patch, fused_patch_embed_i420)


fused_patch_embed_i420.launches = 0
fused_patch_embed_i420.launches_by_kernel = collections.Counter()


def patch_embed_reference(frames_u8: torch.Tensor, kernel: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Explicit normalize + patch projection with the unfolded HWIO
    kernel (the conv of the reference) — for parity tests."""
    mean = torch.as_tensor(CLIP_MEAN, device=frames_u8.device)
    std = torch.as_tensor(CLIP_STD, device=frames_u8.device)
    x = (frames_u8.float() / 255.0 - mean) / std
    p, _, c, d = kernel.shape
    return _patchify(x, p) @ kernel.float().reshape(p * p * c, d) + bias


# ---------------------------------------------------------------------------
# cosine scores
# ---------------------------------------------------------------------------

def cosine_scores_plain(emb: torch.Tensor, queries: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain version of the kernel: ``[N, D] × [Q, D] → [N, Q]`` f32,
    -inf where ``valid`` is false."""
    s = emb.float() @ queries.float().T
    if valid is not None:
        s = torch.where(valid[:, None], s,
                        torch.full_like(s, float("-inf")))
    return s


def cosine_scores(emb: torch.Tensor, queries: torch.Tensor,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 ``[N, D] × [D] → [N]`` (or ``× [Q, D] → [N, Q]``) dot
    products; rows where ``valid`` (bool [N]) is false score -inf."""
    squeeze = queries.dim() == 1
    q = queries[None, :] if squeeze else queries
    n, d = emb.shape
    if q.shape[1] != d or (valid is not None and valid.shape != (n,)):
        raise ValueError(f"bad shapes: emb {tuple(emb.shape)}, queries "
                         f"{tuple(queries.shape)}")
    if emb.device.type == "cpu":
        out = cosine_scores_plain(emb, q, valid)
        return out[:, 0] if squeeze else out
    q = q.contiguous()
    args = [emb, q] + ([valid] if valid is not None else [])
    _require_cuda(*args)
    if emb.dtype != torch.float32 or q.dtype != torch.float32:
        raise ValueError("cosine_scores takes float32 tables and queries")
    _refuse_grad("cosine_scores", *args)
    if valid is not None and valid.dtype != torch.bool:
        raise ValueError("valid must be a bool mask")
    out = torch.empty((n, q.shape[0]), dtype=torch.float32,
                      device=emb.device)
    if n and q.shape[0]:
        _build.launch(emb.device, "cosine_scores", "avede_cosine_scores_f32",
                      [_P, _P, _P, _P, _I, _I, _I], emb.data_ptr(),
                      q.data_ptr(),
                      valid.data_ptr() if valid is not None else None,
                      out.data_ptr(), n, d, q.shape[0])
        cosine_scores.launches += 1
    return out[:, 0] if squeeze else out


cosine_scores.launches = 0


def _bf16_query(queries: torch.Tensor) -> torch.Tensor:
    return queries.to(torch.bfloat16).float()


def cosine_scores_bf16_plain(emb: torch.Tensor, queries: torch.Tensor,
                             valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of the bf16 entry: ``[N, D] bf16 × [Q, D] → [N, Q]``
    f32, the query rounded to bf16, -inf where ``valid`` is false."""
    return cosine_scores_plain(emb.float(), _bf16_query(queries), valid)


def cosine_scores_int8_plain(emb: torch.Tensor, scales: torch.Tensor,
                             queries: torch.Tensor,
                             valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain version of the int8 entry: ``(int8 rows · bf16 query) ×
    row scale`` in f32, -inf where ``valid`` is false."""
    s = (emb.float() @ _bf16_query(queries).T) * scales.float()[:, None]
    if valid is not None:
        s = torch.where(valid[:, None], s,
                        torch.full_like(s, float("-inf")))
    return s


def _lowp_scores(emb, scales, queries, valid, row_dtype, plain, symbol,
                 wrapper):
    squeeze = queries.dim() == 1
    q = queries[None, :] if squeeze else queries
    n, d = emb.shape
    if q.shape[1] != d or (valid is not None and valid.shape != (n,)) \
            or (scales is not None and scales.shape != (n,)):
        raise ValueError(f"bad shapes: emb {tuple(emb.shape)}, queries "
                         f"{tuple(queries.shape)}")
    if emb.device.type == "cpu":
        out = plain(emb, q, valid) if scales is None \
            else plain(emb, scales, q, valid)
        return out[:, 0] if squeeze else out
    q = q.contiguous()
    args = [emb, q] + [t for t in (scales, valid) if t is not None]
    _require_cuda(*args)
    if emb.dtype != row_dtype or q.dtype != torch.float32 \
            or (scales is not None and scales.dtype != torch.float32):
        raise ValueError(f"{symbol} takes {row_dtype} rows, float32 "
                         f"queries and float32 scales")
    _refuse_grad(wrapper.__name__, *args)
    if valid is not None and valid.dtype != torch.bool:
        raise ValueError("valid must be a bool mask")
    out = torch.empty((n, q.shape[0]), dtype=torch.float32,
                      device=emb.device)
    if n and q.shape[0]:
        ptrs = [emb.data_ptr()] + ([scales.data_ptr()] if scales is not None
                                   else []) \
            + [q.data_ptr(), valid.data_ptr() if valid is not None else None,
               out.data_ptr()]
        _build.launch(emb.device, "cosine_scores", symbol,
                      [_P] * len(ptrs) + [_I, _I, _I], *ptrs, n, d,
                      q.shape[0])
        wrapper.launches += 1
    return out[:, 0] if squeeze else out


def cosine_scores_bf16(emb: torch.Tensor, queries: torch.Tensor,
                       valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """bf16 table ``[N, D]`` × f32 ``[D]`` (or ``[Q, D]``) → f32 ``[N]``
    (or ``[N, Q]``): the query rounded to bf16, the sum in f32; rows
    where ``valid`` is false score -inf."""
    return _lowp_scores(emb, None, queries, valid, torch.bfloat16,
                        cosine_scores_bf16_plain,
                        "avede_cosine_scores_bf16", cosine_scores_bf16)


def cosine_scores_int8(emb: torch.Tensor, scales: torch.Tensor,
                       queries: torch.Tensor,
                       valid: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """int8 table ``[N, D]`` with f32 row ``scales`` ``[N]`` × f32
    ``[D]`` (or ``[Q, D]``) → f32 ``[N]`` (or ``[N, Q]``): each row's
    dot with the bf16-rounded query, summed in f32, times its scale;
    rows where ``valid`` is false score -inf."""
    return _lowp_scores(emb, scales, queries, valid, torch.int8,
                        cosine_scores_int8_plain,
                        "avede_cosine_scores_int8", cosine_scores_int8)


cosine_scores_bf16.launches = 0
cosine_scores_int8.launches = 0


# ---------------------------------------------------------------------------
# fused score + select: the serving entries
# ---------------------------------------------------------------------------

# csrc/cosine_scores.cu's MAX_K: a larger k takes the contract entry and
# ``topk_scores`` (a dispatch on the shape, never on a failure)
FUSED_MAX_K = 1024
_NEG_INF = float("-inf")


def topk_scores(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values, indices) along the last axis, ties to the lower
    index (``lax.top_k`` order; ``torch.topk`` promises none); k is
    clipped to the axis length."""
    k = min(k, scores.shape[-1])
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def window_scores(scores: torch.Tensor, middle_idx: torch.Tensor
                  ) -> torch.Tensor:
    """Gather window-middle rows of ``scores`` ([N] or [N, Q]); padded
    windows (index -1) score -inf."""
    w = scores[middle_idx.clamp(min=0).long()]
    w_valid = middle_idx >= 0
    if w.dim() == 2:
        w_valid = w_valid[:, None]
    return torch.where(w_valid, w, torch.full_like(w, _NEG_INF))


def cosine_window_topk_plain(emb: torch.Tensor, valid: Optional[torch.Tensor],
                             queries: torch.Tensor, mids: torch.Tensor,
                             k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the mvp serving entry: the plain scores, the
    window gather, then ``topk_scores`` per query."""
    squeeze = queries.dim() == 1
    q = queries[None, :] if squeeze else queries
    s = window_scores(cosine_scores_plain(emb, q, valid), mids)   # [W, Q]
    vals, idx = topk_scores(s.T, k)
    return (vals[0], idx[0]) if squeeze else (vals, idx)


def cosine_window_topk(emb: torch.Tensor, valid: Optional[torch.Tensor],
                       queries: torch.Tensor, mids: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 table ``[Nb, D]``, bool ``valid`` ``[Nb]`` (or None), queries
    f32 ``[Q, D]`` (or ``[D]``), int32 window-middle rows ``mids``
    ``[Wb]`` (-1 = padded window) → (values ``[Q, k]``, int64 window
    indices ``[Q, k]``) (``[k]`` each for a ``[D]`` query), k clipped to
    Wb. Every ``mids`` entry must be below Nb."""
    squeeze = queries.dim() == 1
    q = queries[None, :] if squeeze else queries
    n, d = emb.shape
    if q.shape[1] != d or (valid is not None and valid.shape != (n,)) \
            or mids.dim() != 1:
        raise ValueError(f"bad shapes: emb {tuple(emb.shape)}, queries "
                         f"{tuple(queries.shape)}, mids {tuple(mids.shape)}")
    if emb.device.type == "cpu":
        return cosine_window_topk_plain(emb, valid, queries, mids, k)
    q = q.contiguous()
    _require_cuda(emb, q, mids, *([valid] if valid is not None else []))
    if emb.dtype != torch.float32 or q.dtype != torch.float32:
        raise ValueError("cosine_window_topk takes float32 tables and "
                         "queries")
    _refuse_grad("cosine_window_topk", emb, q, valid)
    if valid is not None and valid.dtype != torch.bool:
        raise ValueError("valid must be a bool mask")
    if mids.dtype != torch.int32:
        raise ValueError("mids must be int32")
    w, nq = mids.shape[0], q.shape[0]
    k = min(k, w)
    if k > FUSED_MAX_K:
        vals, idx = topk_scores(window_scores(cosine_scores(emb, q, valid),
                                              mids).T, k)
        return (vals[0], idx[0]) if squeeze else (vals, idx)
    vals = torch.empty((nq, k), dtype=torch.float32, device=emb.device)
    idx = torch.empty((nq, k), dtype=torch.int64, device=emb.device)
    if k and nq:                               # one block per query
        _build.launch(emb.device, "cosine_scores", "avede_window_topk_f32",
                      [_P] * 6 + [_I] * 4, emb.data_ptr(), q.data_ptr(),
                      valid.data_ptr() if valid is not None else None,
                      mids.data_ptr(), vals.data_ptr(), idx.data_ptr(), d,
                      nq, w, k)
        cosine_window_topk.launches += 1
    return (vals[0], idx[0]) if squeeze else (vals, idx)


cosine_window_topk.launches = 0


def cosine_topk_f32_plain(emb: torch.Tensor, query: torch.Tensor,
                          valid: Optional[torch.Tensor], k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the f32 library entry: the plain scores, then
    ``topk_scores``."""
    return topk_scores(cosine_scores_plain(emb, query[None], valid)[:, 0], k)


def cosine_topk_bf16_plain(emb: torch.Tensor, query: torch.Tensor,
                           valid: Optional[torch.Tensor], k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the bf16 serving entry: the plain bf16 scores,
    then ``topk_scores``."""
    return topk_scores(cosine_scores_bf16_plain(emb, query[None], valid
                                                )[:, 0], k)


def cosine_topk_int8_plain(emb: torch.Tensor, scales: torch.Tensor,
                           query: torch.Tensor,
                           valid: Optional[torch.Tensor], k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the int8 serving entry: the plain int8 scores,
    then ``topk_scores``."""
    return topk_scores(cosine_scores_int8_plain(emb, scales, query[None],
                                                valid)[:, 0], k)


def _topk_library(emb, scales, query, valid, k, row_dtype, plain, unfused,
                  symbol, wrapper):
    """One query over every row of a library table through ``symbol``:
    the tier's contract scoring kernel, then the select passes."""
    n, d = emb.shape
    if query.shape != (d,) or (valid is not None and valid.shape != (n,)) \
            or (scales is not None and scales.shape != (n,)):
        raise ValueError(f"bad shapes: emb {tuple(emb.shape)}, query "
                         f"{tuple(query.shape)}")
    rest = (query, valid) if scales is None else (scales, query, valid)
    if emb.device.type == "cpu":
        return plain(emb, *rest, k)
    k = min(k, n)
    if k > FUSED_MAX_K:
        return topk_scores(unfused(emb, *rest), k)
    query = query.contiguous()
    _require_cuda(emb, query, *[t for t in (scales, valid) if t is not None])
    if emb.dtype != row_dtype or query.dtype != torch.float32 \
            or (scales is not None and scales.dtype != torch.float32):
        raise ValueError(f"{symbol} takes {row_dtype} rows, a float32 "
                         f"query and float32 scales")
    _refuse_grad(wrapper.__name__, emb, query, scales)
    if valid is not None and valid.dtype != torch.bool:
        raise ValueError("valid must be a bool mask")
    vals = torch.empty((k,), dtype=torch.float32, device=emb.device)
    idx = torch.empty((k,), dtype=torch.int64, device=emb.device)
    if k:
        ptrs = [emb.data_ptr()] + ([scales.data_ptr()] if scales is not None
                                   else []) \
            + [query.data_ptr(), valid.data_ptr() if valid is not None
               else None]
        scores = torch.empty((n,), dtype=torch.float32, device=emb.device)
        work_ints = _build.entry("cosine_scores", "avede_topk_work_ints",
                                 [])()
        work = torch.empty((work_ints,), dtype=torch.int32,
                           device=emb.device)
        _build.launch(emb.device, "cosine_scores", symbol,
                      [_P] * (len(ptrs) + 4) + [_I, _I, _I], *ptrs,
                      scores.data_ptr(), work.data_ptr(), vals.data_ptr(),
                      idx.data_ptr(), n, d, k)
        wrapper.launches += 1
    return vals, idx


def cosine_topk_f32(emb: torch.Tensor, query: torch.Tensor,
                    valid: Optional[torch.Tensor], k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 table ``[N, D]`` × f32 query ``[D]`` → the top ``k`` (f32
    values, int64 rows) of ``cosine_scores``, in ``topk_scores``' order;
    k clipped to N."""
    return _topk_library(emb, None, query, valid, k, torch.float32,
                         cosine_topk_f32_plain, cosine_scores,
                         "avede_topk_f32", cosine_topk_f32)


def cosine_topk_bf16(emb: torch.Tensor, query: torch.Tensor,
                     valid: Optional[torch.Tensor], k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 table ``[N, D]`` × f32 query ``[D]`` → the top ``k`` (f32
    values, int64 rows) of ``cosine_scores_bf16``, in ``topk_scores``'
    order; k clipped to N."""
    return _topk_library(emb, None, query, valid, k, torch.bfloat16,
                         cosine_topk_bf16_plain, cosine_scores_bf16,
                         "avede_topk_bf16", cosine_topk_bf16)


def cosine_topk_int8(emb: torch.Tensor, scales: torch.Tensor,
                     query: torch.Tensor, valid: Optional[torch.Tensor],
                     k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 table ``[N, D]`` with f32 row ``scales`` × f32 query ``[D]``
    → the top ``k`` (f32 values, int64 rows) of ``cosine_scores_int8``,
    in ``topk_scores``' order; k clipped to N."""
    return _topk_library(emb, scales, query, valid, k, torch.int8,
                         cosine_topk_int8_plain, cosine_scores_int8,
                         "avede_topk_int8", cosine_topk_int8)


cosine_topk_f32.launches = 0
cosine_topk_bf16.launches = 0
cosine_topk_int8.launches = 0
