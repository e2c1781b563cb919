"""Symmetric int8 quantization (counterpart of ``avede_tpu/ops/quant.py``).

One scheme throughout: ``scale = max(amax / 127, 1e-12)`` and
``q = clip(round(x / scale), -127, 127)`` in f32, rounding half to even.

- ``quantize_per_channel`` — ``[K, N]`` → (int8 ``[K, N]``, f32 ``[N]``),
  amax over K: the contract of the TPU kernel ``quantize_kernel_pallas``
  / ``_quant_kernel`` (``avede_tpu/ops/quant.py:57-75``);
- ``quantize_rows`` — ``[N, D]`` → (int8 ``[N, D]``, f32 ``[N]``), amax
  over D: the layout of the library index's int8 tier, whose growth
  quantizes on the device;
- ``quantize_rows_into`` — the same into a row slice of the index's
  table and scales, with the slice's ``valid`` mask written in the same
  launch (the index's int8 add and remove write);
- ``quantize_rows_np`` — the host numpy twin, for tables that stay on
  the host (the embedding cache's int8 entries, bound for disk);
- ``dequantize``, ``quantized_matmul`` and ``quantize_dense_tree``.

The kernel wrappers launch ``csrc/quantize.cu`` for CUDA tensors (on
their device, through ``_build.launch``) and
take their plain PyTorch version only for tensors on the CPU. The bar
between the two, and against numpy and eager JAX, is exact equality of
``q`` and the scales (IEEE division ``amax / 127``; under ``jit``, XLA
multiplies by ``f32(1/127)`` instead, which can move a scale by one
ulp). ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import _build
from .kernels import _I, _P, _require_cuda

_QOut = Optional[Tuple[torch.Tensor, torch.Tensor]]


def quantize_rows_np(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] float → (int8 [N, D], f32 scales [N]) — per-ROW symmetric
    int8 on the host (the port's own copy of
    ``avede_tpu/ops/quant.py:44-54``)."""
    amax = np.max(np.abs(rows), axis=1)
    scales = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(rows / scales[:, None]), -127, 127
                ).astype(np.int8)
    return q, scales


def _quantize_plain(x: torch.Tensor, dim: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    amax = x.abs().amax(dim=dim)
    # divide by a tensor, not the scalar 127: on CUDA, PyTorch turns a
    # scalar divisor into a multiply by its reciprocal, which can move a
    # scale by one ulp off the IEEE division numpy, JAX and the kernel do
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-12)
    q = torch.clamp(torch.round(x / scale.unsqueeze(dim)), -127, 127)
    return q.to(torch.int8), scale


def quantize_per_channel_plain(w: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the per-column kernel."""
    return _quantize_plain(w, 0)


def quantize_rows_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the per-row kernel."""
    return _quantize_plain(x, 1)


def quantize_rows_into_plain(x: torch.Tensor, q_out: torch.Tensor,
                             s_out: torch.Tensor, valid_out: torch.Tensor,
                             n_valid: int) -> None:
    """Plain version of the add write: ``quantize_rows_plain`` into the
    slices, then the mask."""
    q, s = quantize_rows_plain(x)
    q_out.copy_(q)
    s_out.copy_(s)
    valid_out.copy_(torch.arange(x.shape[0], device=x.device) < n_valid)


def _outputs(x: torch.Tensor, q_shape, s_len: int, out: _QOut
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    if out is None:
        return (torch.empty(q_shape, dtype=torch.int8, device=x.device),
                torch.empty((s_len,), dtype=torch.float32, device=x.device))
    q, s = out
    if q.shape != q_shape or q.dtype != torch.int8 \
            or s.shape != (s_len,) or s.dtype != torch.float32:
        raise ValueError(f"out must be int8 {tuple(q_shape)} and float32 "
                         f"[{s_len}], got {q.dtype} {tuple(q.shape)} and "
                         f"{s.dtype} {tuple(s.shape)}")
    return q, s


def _quantize(x: torch.Tensor, dim: int, out: _QOut, plain, symbol: str,
              wrapper) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D tensor, got {tuple(x.shape)}")
    q, s = _outputs(x, tuple(x.shape), x.shape[1 - dim], out)
    if x.device.type == "cpu":
        pq, ps = plain(x)
        if out is None:
            return pq, ps
        q.copy_(pq)
        s.copy_(ps)
        return q, s
    _require_cuda(x, q, s)
    if x.dtype != torch.float32:
        raise ValueError(f"{symbol} takes float32, not {x.dtype}")
    rows, cols = x.shape
    if x.numel():
        _build.launch(x.device, "quantize", symbol, [_P, _P, _P, _I, _I],
                      x.data_ptr(), q.data_ptr(), s.data_ptr(), rows, cols)
        wrapper.launches += 1
    return q, s


def quantize_per_channel(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[K, N] f32 → (int8 [K, N], f32 scales [N]), amax over K."""
    return _quantize(w, 0, None, quantize_per_channel_plain,
                     "avede_quantize_cols", quantize_per_channel)


def quantize_rows(x: torch.Tensor, out: _QOut = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D] f32 → (int8 [N, D], f32 scales [N]), amax over D. ``out``
    (contiguous int8 [N, D], f32 [N], e.g. row slices of a larger
    table) receives the result in place."""
    return _quantize(x, 1, out, quantize_rows_plain,
                     "avede_quantize_rows", quantize_rows)


def quantize_rows_into(x: torch.Tensor, q_out: torch.Tensor,
                       s_out: torch.Tensor, valid_out: torch.Tensor,
                       n_valid: int) -> None:
    """[N, D] f32 → int8 ``q_out`` [N, D] and f32 ``s_out`` [N], amax over
    D, and bool ``valid_out[r] = r < n_valid`` for the block's rows, in
    place and in one launch: the int8 index's add write (``n_valid`` =
    the rows added) and remove write (0). The outputs are contiguous row
    slices of the index's table, scales and mask."""
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D tensor, got {tuple(x.shape)}")
    rows, cols = x.shape
    _outputs(x, (rows, cols), rows, (q_out, s_out))
    if valid_out.shape != (rows,) or valid_out.dtype != torch.bool:
        raise ValueError(f"valid_out must be bool [{rows}], got "
                         f"{valid_out.dtype} {tuple(valid_out.shape)}")
    if x.device.type == "cpu":
        quantize_rows_into_plain(x, q_out, s_out, valid_out, n_valid)
        return
    _require_cuda(x, q_out, s_out, valid_out)
    if x.dtype != torch.float32:
        raise ValueError(f"avede_quantize_rows_into takes float32, not "
                         f"{x.dtype}")
    if x.numel():
        _build.launch(x.device, "quantize", "avede_quantize_rows_into",
                      [_P, _P, _P, _P, _I, _I, _I], x.data_ptr(),
                      q_out.data_ptr(), s_out.data_ptr(),
                      valid_out.data_ptr(), rows, cols, int(n_valid))
        quantize_rows_into.launches += 1


quantize_per_channel.launches = 0
quantize_rows.launches = 0
quantize_rows_into.launches = 0


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q * scale`` in f32 (``scale`` broadcasts over the last axis)."""
    return q.float() * scale


def quantized_matmul(x: torch.Tensor, q: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x [B, K] × (q [K, N] int8, scale [N]) → [B, N] f32, computed as
    ``(x @ q) · scale`` so the scale folds into the epilogue."""
    return torch.matmul(x.float(), q.float()) * scale


def quantize_dense_tree(params: Mapping[str, Any]
                        ) -> Tuple[Dict[str, Any], Dict[str, Any], Dict]:
    """Quantize every 2-D float leaf of a flat or nested dict of arrays
    per column; → (q_tree, scale_tree, report). Other leaves pass
    through unchanged in q_tree. Host in, host out (numpy)."""
    orig_bytes = 0
    quant_bytes = 0
    count = 0

    def walk(node):
        nonlocal orig_bytes, quant_bytes, count
        if isinstance(node, Mapping):
            q_out, s_out = {}, {}
            for k, v in node.items():
                q, s = walk(v)
                q_out[k] = q
                if s is not None:
                    s_out[k] = s
            return q_out, (s_out or None)
        arr = np.asarray(node)
        if arr.ndim == 2 and arr.dtype in (np.float32, np.float64):
            q, s = quantize_per_channel(
                torch.from_numpy(np.array(arr, np.float32)))
            orig_bytes += arr.size * 4
            quant_bytes += arr.size + s.numel() * 4
            count += 1
            return q.numpy(), s.numpy()
        orig_bytes += arr.nbytes
        quant_bytes += arr.nbytes
        return arr, None

    q_tree, s_tree = walk(dict(params))
    return q_tree, (s_tree or {}), {
        "kernels_quantized": count,
        "orig_mb": round(orig_bytes / 2 ** 20, 2),
        "quant_mb": round(quant_bytes / 2 ** 20, 2),
        "ratio": round(quant_bytes / max(orig_bytes, 1), 3),
    }
