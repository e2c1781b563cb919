"""Flash attention (counterpart of ``avede_tpu/ops/attention.py``).

``flash_attention`` launches ``csrc/flash_attention.cu``, which replaces
``flash_attention`` / ``_flash_kernel`` (``avede_tpu/ops/attention.py:
29-98``): non-causal, unmasked softmax attention with an online softmax
over K/V tiles, in f32. It serves every layer of the CLIP vision tower
(L = 50, D = 64 at ViT-B/32). Any L works: the kernel masks K rows past
L itself, so nothing is padded. Bound by bytes on the H100.

The wrapper takes its plain version (``attention_reference``) only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``flash_attention.launches`` counts kernel launches.
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
