"""Fixed-grid frame tiling for small-object detection (counterpart of
``avede_tpu/ops/tiling.py``, numpy): a static tile grid per frame
geometry, every tile of a frame batched through the detector in one
call, detections shifted back to frame coordinates.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def tile_grid(h: int, w: int, tile: int, overlap: int
              ) -> List[Tuple[int, int]]:
    """(y, x) offsets of a covering grid with the given overlap. The
    last tile in each axis is clamped so the grid covers the frame with
    constant tile size."""
    stride = tile - overlap
    ys = list(range(0, max(h - tile, 0) + 1, stride))
    xs = list(range(0, max(w - tile, 0) + 1, stride))
    if not ys or ys[-1] + tile < h:
        ys.append(max(h - tile, 0))
    if not xs or xs[-1] + tile < w:
        xs.append(max(w - tile, 0))
    return [(y, x) for y in sorted(set(ys)) for x in sorted(set(xs))]


def tile_frame(frame: np.ndarray, tile: int, overlap: int
               ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """[H, W, 3] → ([T, tile, tile, 3], offsets). Frames smaller than a
    tile are zero-padded (detections stay in the valid region)."""
    h, w = frame.shape[:2]
    if h < tile or w < tile:
        padded = np.zeros((max(h, tile), max(w, tile), 3), frame.dtype)
        padded[:h, :w] = frame
        frame, (h, w) = padded, padded.shape[:2]
    offsets = tile_grid(h, w, tile, overlap)
    tiles = np.stack([frame[y: y + tile, x: x + tile]
                      for y, x in offsets])
    return tiles, offsets


def untile_boxes(boxes: np.ndarray, offsets: List[Tuple[int, int]]
                 ) -> np.ndarray:
    """[T, N, 4] tile-local xyxy → frame coordinates."""
    out = boxes.copy()
    for t, (y, x) in enumerate(offsets):
        out[t, :, 0] += x
        out[t, :, 2] += x
        out[t, :, 1] += y
        out[t, :, 3] += y
    return out
