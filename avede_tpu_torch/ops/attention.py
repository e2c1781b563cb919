"""Flash attention (counterpart of ``avede_tpu/ops/attention.py``).

Both entries launch ``csrc/flash_attention.cu``, which replaces
``flash_attention`` / ``_flash_kernel`` (``avede_tpu/ops/attention.py:
29-98``): non-causal, unmasked softmax attention with an online softmax
over K/V tiles. Any L works: the kernel masks K rows past L itself, so
nothing is padded. Bound by bytes on the H100.

- ``flash_attention_blhd`` serves every layer of the CLIP vision tower
  (L = 50, hd = 64 at ViT-B/32), of BLIP's (L = 577 at 384 px, patch
  16), of BLIP-2's ViT-g (L = 257 at 224 px, patch 14, hd = 88) and of
  the tiny CLIP, BLIP and OWL-ViT towers (L = 17 at 32 px, patch 8,
  hd = 16):
  bf16 q, k, v in the projections' own ``[B, L, H, hd]`` layout in
  (BLIP's are the three thirds of its fused qkv output, read in place at
  a row stride of 3·D: no copy), bf16 ``[B, L, H·hd]`` out, tensor-core
  products with f32 softmax and accumulation.
- ``flash_attention`` is the TPU kernel's contract: f32 ``[B, H, L, D]``.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. ``flash_attention.launches``
counts kernel launches; ``flash_attention_blhd.launches_by_length`` counts
them by L (their sum is the entry's count).
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build
from .kernels import _entry, _refuse_grad, _require_cuda, _stream

_HEAD_DIMS = (16, 32, 64)
_BLHD_HEAD_DIMS = (16, 24, 64, 88)   # the bf16 entry's instantiations


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention on [B, H, L, D]."""
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(s, dim=-1) @ v


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: f32 [B, H, L, D] → [B, H, L, D] (non-causal, no mask)."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"bad shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    _require_cuda(q, k, v)
    b, h, length, d = q.shape
    if q.dtype != torch.float32 or k.dtype != torch.float32 \
            or v.dtype != torch.float32:
        raise ValueError("flash_attention takes float32 q, k, v")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    _refuse_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _entry("flash_attention", "avede_flash_attention_f32",
                [p, p, p, p, i, i, i, p])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b * h, length, d, _stream(q)),
                 "avede_flash_attention_f32")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_blhd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``[B, L, H, hd]`` entry: transpose, softmax
    attention in f32, ``[B, L, H·hd]`` in the input dtype."""
    b, length, h, d = q.shape
    out = attention_reference(*(t.transpose(1, 2).float()
                                for t in (q, k, v)))
    return out.transpose(1, 2).reshape(b, length, h * d).to(q.dtype)


def _row_stride(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The token-row stride the bf16 kernel reads q, k and v at: each is
    ``[B, L, H, hd]`` with contiguous heads and one row stride ``ld``
    (``H·hd`` for a projection's own output, ``3·H·hd`` for a third of a
    fused qkv output), 16-byte aligned; anything else raises."""
    b, length, h, d = q.shape
    # a size-1 dimension's stride is arbitrary: with one token the batch
    # stride is the row stride
    ld = q.stride(1) if length > 1 else (q.stride(0) if b > 1 else h * d)
    want = (length * ld, ld, d, 1)
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if any(n > 1 and s != w
               for n, s, w in zip(t.shape, t.stride(), want)):
            raise ValueError(
                f"flash_attention_blhd: strides {tuple(t.stride())}, want "
                f"{want} (rows at one stride, heads contiguous)")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention_blhd: pointer not 16-byte "
                             "aligned")
    if ld < h * d or ld % 8:
        raise ValueError(f"flash_attention_blhd: row stride {ld}")
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return ld


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q, k, v: ``[B, L, H, hd]`` (each projection's ``[B, L, H·hd]``
    viewed per head, or the thirds of a fused ``[B, L, 3·H·hd]`` qkv
    output, read in place at their row stride) → ``[B, L, H·hd]``
    (non-causal, no mask). On the card: bf16 with hd = 16, 24, 64 or
    88.
    ``launches_by_length`` counts the launches by L."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"bad shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_blhd_plain(q, k, v)
    b, length, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16:
        raise ValueError("flash_attention_blhd takes bfloat16 q, k, v")
    if d not in _BLHD_HEAD_DIMS:
        raise ValueError(f"flash_attention_blhd takes head dim "
                         f"{_BLHD_HEAD_DIMS}, not {d}")
    ld = _row_stride(q, k, v)
    _refuse_grad("flash_attention_blhd", q, k, v)
    out = torch.empty((b, length, h * d), dtype=torch.bfloat16,
                      device=q.device)
    if q.numel() == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _entry("flash_attention", "avede_flash_attention_bf16",
                [p, p, p, p, i, i, i, i, i, p])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, length, h, d, ld, _stream(q)),
                 "avede_flash_attention_bf16")
    flash_attention_blhd.launches_by_length[length] += 1
    return out


flash_attention_blhd.launches_by_length = collections.Counter()
