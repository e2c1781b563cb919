"""Flash attention (counterpart of ``avede_tpu/ops/attention.py``).

Both entries launch ``csrc/flash_attention.cu``, which replaces
``flash_attention`` / ``_flash_kernel`` (``avede_tpu/ops/attention.py:
29-98``): non-causal, unmasked softmax attention with an online softmax
over K/V tiles. Any L works: the kernel masks K rows past L itself, so
nothing is padded. Bound by bytes on the H100.

- ``flash_attention_blhd`` serves every layer of the CLIP vision tower
  (L = 50, hd = 64 at ViT-B/32): bf16 q, k, v in the projections' own
  ``[B, L, H, hd]`` layout in, bf16 ``[B, L, H·hd]`` out, tensor-core
  products with f32 softmax and accumulation.
- ``flash_attention`` is the TPU kernel's contract: f32 ``[B, H, L, D]``.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel or raises. ``<wrapper>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .kernels import _entry, _require_cuda, _stream

_HEAD_DIMS = (16, 32, 64)


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


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q, k, v: ``[B, L, H, hd]`` (each projection's ``[B, L, H·hd]``
    viewed per head) → ``[B, L, H·hd]`` (non-causal, no mask). On the
    card: bf16 with hd = 64."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"bad shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_blhd_plain(q, k, v)
    _require_cuda(q, k, v)
    b, length, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16:
        raise ValueError("flash_attention_blhd takes bfloat16 q, k, v")
    if d != 64:
        raise ValueError(f"flash_attention_blhd takes head dim 64, not {d}")
    out = torch.empty((b, length, h * d), dtype=torch.bfloat16,
                      device=q.device)
    if q.numel() == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _entry("flash_attention", "avede_flash_attention_bf16",
                [p, p, p, p, i, i, i, i, p])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), b, length, h, d, _stream(q)),
                 "avede_flash_attention_bf16")
    flash_attention_blhd.launches += 1
    return out


flash_attention_blhd.launches = 0
