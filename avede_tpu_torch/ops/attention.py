"""Flash attention (counterpart of ``avede_tpu/ops/attention.py``).

Both entries replace ``flash_attention`` / ``_flash_kernel``
(``avede_tpu/ops/attention.py:29-98``): non-causal, unmasked softmax
attention with an online softmax over K/V tiles. Any L works: the
kernels mask K rows past L themselves, so nothing is padded. The f32
entry and the bf16 entry's short sequences launch ``csrc/flash_attention
.cu`` (``mma.sync``); the bf16 entry at hd = 64, 72 or 88 and L from
``WGMMA_MIN_LENGTH`` up launches ``csrc/flash_attention_wgmma.cu``
(``wgmma``, TMA, an mbarrier ring; 128-row q and K/V tiles).

- ``flash_attention_blhd`` serves every layer of the CLIP vision tower
  (L = 50, hd = 64 at ViT-B/32), of BLIP's (L = 577 at 384 px, patch
  16), of BLIP-2's ViT-g (L = 257 at 224 px, patch 14, hd = 88) and of
  the tiny CLIP, BLIP and OWL-ViT towers (L = 17 at 32 px, patch 8,
  hd = 16):
  bf16 q, k, v in the projections' own ``[B, L, H, hd]`` layout in
  (BLIP's are the three thirds of its fused qkv output, read in place at
  a row stride of 3·D: no copy), bf16 ``[B, L, H·hd]`` out, tensor-core
  products with f32 softmax and accumulation.
- ``flash_attention`` is the TPU kernel's contract: f32 ``[B, H, L, D]``
  in and out, D one of ``_HEAD_DIMS`` (16, 24, 32, 64, 88: every head
  dim a model of either package runs, and 32), on the tensor cores in
  3xTF32 (each operand split into two TF32 terms, three products
  accumulated in f32). ``models.layers.MultiHeadAttention(use_flash=
  True)`` sends its f32 q, k, v here, transposed to ``[B, H, L, hd]``
  and back as the JAX layer does; its bf16 ones go to
  ``flash_attention_blhd``.

Each wrapper takes its plain version only for tensors on the CPU; for
CUDA tensors it launches the kernel (``_build.launch``, on the tensors'
device) or raises; there is no fallback from one kernel to another.
``flash_attention.launches`` counts kernel launches,
``flash_attention.launches_by_dim`` the same by head dim;
``flash_attention_blhd.launches_by_length`` counts them by L (their sum
is the entry's count) and ``launches_by_kernel`` by kernel (``"wgmma"``,
``"mma"``).
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from . import _build
from .kernels import _refuse_grad, _require_cuda

_HEAD_DIMS = (16, 24, 32, 64, 88)    # the f32 entry's instantiations
_BLHD_HEAD_DIMS = (16, 24, 64, 72, 88)   # the bf16 mma.sync kernel's
_WGMMA_HEAD_DIMS = (64, 72, 88)          # the bf16 wgmma kernel's
# The bf16 entry sends hd = 64, 72 and 88 from this L up to the wgmma kernel,
# shorter L to the mma.sync one. chip_smoke.py phase 3's crossover sweep
# (tools/flash_rows.py, NVIDIA H100 80GB HBM3, 700 W), device ms mma.sync
# / wgmma: at L = 50, 0.0101 / 0.0135 ([64, 50, 12, 64]) and 0.0123 /
# 0.0125 ([30, 50, 16, 88]); at L = 65, 0.0308 / 0.0171 and 0.0296 /
# 0.0169; wgmma ahead at every longer L measured (129, 257, 577). The
# 128-row tiles waste most of their rows at L = 50.
WGMMA_MIN_LENGTH = 65
# kernel → (source under csrc/, C entry)
_BLHD_KERNELS = {"mma": ("flash_attention", "avede_flash_attention_bf16"),
                 "wgmma": ("flash_attention_wgmma",
                           "avede_flash_attention_wgmma_bf16")}


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain softmax attention on [B, H, L, D]."""
    s = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return torch.softmax(s, dim=-1) @ v


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q, k, v: f32 [B, H, L, D] → [B, H, L, D] (non-causal, no mask);
    on the card D must be one of ``_HEAD_DIMS``."""
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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: pointer not 16-byte aligned")
    _refuse_grad("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    _build.launch(q.device, "flash_attention", "avede_flash_attention_f32",
                  [p, p, p, p, i, i, i], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b * h, length, d)
    flash_attention.launches += 1
    flash_attention.launches_by_dim[d] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_dim = collections.Counter()


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


def blhd_kernel(length: int, d: int) -> str:
    """The kernel ``flash_attention_blhd`` launches for sequence length
    ``length`` and head dim ``d``: ``"wgmma"`` for hd 64, 72 or 88 at L >=
    ``WGMMA_MIN_LENGTH``, else ``"mma"``."""
    if d in _WGMMA_HEAD_DIMS and length >= WGMMA_MIN_LENGTH:
        return "wgmma"
    return "mma"


def flash_attention_blhd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q, k, v: ``[B, L, H, hd]`` (each projection's ``[B, L, H·hd]``
    viewed per head, or the thirds of a fused ``[B, L, 3·H·hd]`` qkv
    output, read in place at their row stride) → ``[B, L, H·hd]``
    (non-causal, no mask). On the card: bf16 with hd = 16, 24, 64, 72
    or 88, on the kernel ``blhd_kernel(L, hd)`` names."""
    kernel = blhd_kernel(q.shape[1], q.shape[3]) if q.dim() == 4 else "mma"
    return flash_attention_blhd_on(kernel, q, k, v)   # which checks shapes


def flash_attention_blhd_on(kernel: str, q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """``flash_attention_blhd`` on the named kernel (``"mma"``: hd = 16,
    24, 64, 72 or 88; ``"wgmma"``: hd = 64, 72 or 88) at any L, for tests and
    measurements that hold both kernels; counted as the entry's
    launches."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"bad shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_blhd_plain(q, k, v)
    b, length, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16:
        raise ValueError("flash_attention_blhd takes bfloat16 q, k, v")
    if kernel not in _BLHD_KERNELS:
        raise ValueError(f"flash_attention_blhd: no kernel {kernel!r}")
    dims = _WGMMA_HEAD_DIMS if kernel == "wgmma" else _BLHD_HEAD_DIMS
    if d not in dims:
        raise ValueError(f"flash_attention_blhd: the {kernel} kernel takes "
                         f"head dim {dims}, not {d}")
    ld = _row_stride(q, k, v)
    _refuse_grad("flash_attention_blhd", q, k, v)
    out = torch.empty((b, length, h * d), dtype=torch.bfloat16,
                      device=q.device)
    if q.numel() == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    _build.launch(q.device, *_BLHD_KERNELS[kernel],
                  [p, p, p, p, i, i, i, i, i], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, length, h, d, ld)
    flash_attention_blhd.launches_by_length[length] += 1
    flash_attention_blhd.launches_by_kernel[kernel] += 1
    return out


flash_attention_blhd.launches_by_length = collections.Counter()
flash_attention_blhd.launches_by_kernel = collections.Counter()
