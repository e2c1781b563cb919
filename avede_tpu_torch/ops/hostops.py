"""Host kernels in numpy (counterpart of ``avede_tpu/native/hostops.py``;
the JAX package's C++ library stays its own).

The box ops (IoU, NMS, the temporal dedup) are float32 with the C++
library's comparisons, so the kept sets equal the JAX package's. The
greedy loops test each candidate against the whole kept set in one
vectorised step: a detection call can feed ``temporal_dedup`` 10^4
entries, and the JAX package's numpy fallback (a Python loop over
candidate × kept pairs) would take minutes there.

The perceptual hash is the C++ library's algorithm (``hostops.cpp``
``phash_batch``), which the JAX matcher calls wherever ``g++`` built the
library, vectorised: the JAX package's numpy fallback (cv2 ``INTER_AREA``
on uint8) is another hash and flips bits near the mean.
"""

from __future__ import annotations

import numpy as np

HASH_SIDE = 8          # the hash's cells per side: 64 bits


def _area(x: np.ndarray) -> np.ndarray:
    return (np.clip(x[..., 2] - x[..., 0], 0, None)
            * np.clip(x[..., 3] - x[..., 1], 0, None))


def _iou_one(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    """IoU of one box with ``[K, 4]`` others, float32 (0 where the union
    is at most 1e-9)."""
    lt = np.maximum(box[:2], others[:, :2])
    rb = np.minimum(box[2:], others[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    union = _area(box) + _area(others) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > np.float32(1e-9), inter / union,
                        np.float32(0.0))


def pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] × [M, 4] xyxy → [N, M] float32 IoU."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a)[:, None] + _area(b)[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > np.float32(1e-9), inter / union,
                        np.float32(0.0)).astype(np.float32)


def nms(boxes: np.ndarray, scores: np.ndarray,
        iou_threshold: float) -> np.ndarray:
    """Greedy NMS → kept indices, score-descending (tied scores in
    numpy's default sort order, as the JAX package's numpy path); scores
    at or below -1e30 are padding."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    thr = np.float32(iou_threshold)
    kept = np.empty(len(boxes), np.int32)
    k = 0
    for i in np.argsort(-scores):
        if scores[i] <= np.float32(-1e30):
            continue
        if k == 0 or not (_iou_one(boxes[i], boxes[kept[:k]]) > thr).any():
            kept[k] = i
            k += 1
    return kept[:k].copy()


def temporal_dedup(boxes: np.ndarray, times: np.ndarray,
                   query_ids: np.ndarray, time_window: float,
                   iou_threshold: float) -> np.ndarray:
    """Entries sorted best-first → kept indices: an entry is dropped when
    a kept one has its query, lies within ``time_window`` seconds and
    overlaps it at IoU >= ``iou_threshold``."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    times = np.ascontiguousarray(times, np.float32)
    query_ids = np.ascontiguousarray(query_ids, np.int32)
    window, thr = np.float32(time_window), np.float32(iou_threshold)
    kept = np.empty(len(boxes), np.int64)
    k = 0
    for i in range(len(boxes)):
        near = kept[:k][(query_ids[kept[:k]] == query_ids[i])
                        & (np.abs(times[kept[:k]] - times[i]) <= window)]
        if len(near) and (_iou_one(boxes[i], boxes[near]) >= thr).any():
            continue
        kept[k] = i
        k += 1
    return kept[:k].astype(np.int32)


def phash_batch(gray_images: np.ndarray) -> np.ndarray:
    """[N, H, W] uint8 grayscale → [N] uint64 average hashes: the mean of
    each of 8 × 8 cells (rows ``cy·H // 8`` to ``(cy + 1)·H // 8``, at
    least one pixel) in float64, bit ``cy·8 + cx`` set where the cell
    exceeds the mean of the 64 cells summed in cell order."""
    imgs = np.ascontiguousarray(gray_images, np.uint8)
    n, h, w = imgs.shape
    cells = np.arange(HASH_SIDE)
    y0, x0 = cells * h // HASH_SIDE, cells * w // HASH_SIDE
    y1 = np.maximum((cells + 1) * h // HASH_SIDE, y0 + 1)
    x1 = np.maximum((cells + 1) * w // HASH_SIDE, x0 + 1)
    # exact integer cell sums, as the C++ double sums are: reduceat sums
    # [x0_i, x0_(i+1)) and takes the lone element x0_i where a cell is
    # narrower than a pixel, which is the C++ cell [x0, x0 + 1)
    sums = np.add.reduceat(np.add.reduceat(imgs, y0, axis=1,
                                           dtype=np.int64), x0, axis=2)
    area = ((y1 - y0)[:, None] * (x1 - x0)[None, :]).astype(np.float64)
    cell = (sums.astype(np.float64) / area).reshape(n, -1)
    # sequential sum in cell order (numpy's pairwise .sum() may differ by
    # an ulp and flip a bit that sits on the mean)
    mean = np.cumsum(cell, axis=1)[:, -1] / float(HASH_SIDE * HASH_SIDE)
    bits = (cell > mean[:, None]).astype(np.uint64)
    weights = np.uint64(1) << np.arange(HASH_SIDE * HASH_SIDE,
                                        dtype=np.uint64)
    return (bits * weights).sum(axis=1, dtype=np.uint64)


def hamming_batch(query: int, hashes: np.ndarray) -> np.ndarray:
    """Bit distances of ``query`` to each uint64 hash → [N] int32."""
    x = np.ascontiguousarray(hashes, np.uint64) ^ np.uint64(query)
    return np.unpackbits(x.view(np.uint8).reshape(len(x), 8),
                         axis=1).sum(1).astype(np.int32)
