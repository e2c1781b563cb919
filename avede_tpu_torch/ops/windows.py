"""Sliding-window semantics as pure index arithmetic (copy of
``avede_tpu/ops/windows.py``).

Behavioral contract:

- windows of ``WINDOW_SIZE`` frames at ``WINDOW_STRIDE``;
- window timestamp = timestamp of the window's middle frame
  (index ``i + size // 2``, clamped);
- fewer frames than a window ⇒ one window covering everything, timestamp
  = middle of the available timestamps;
- phase-1 scoring uses the window's middle frame only.

A window is just its middle-frame index, so scoring gathers rows from
the once-computed ``[n_frames, D]`` embedding table — no data
duplication, and the gather stays on device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def window_middle_indices(n_frames: int, size: int, stride: int) -> np.ndarray:
    """Indices of each sliding window's middle frame. ``[n_windows]`` int32."""
    if n_frames <= 0:
        return np.zeros((0,), dtype=np.int32)
    if n_frames < size:
        return np.array([n_frames // 2], dtype=np.int32)
    starts = np.arange(0, n_frames - size + 1, stride, dtype=np.int32)
    mids = np.minimum(starts + size // 2, n_frames - 1)
    return mids


def window_bounds(n_frames: int, size: int, stride: int) -> np.ndarray:
    """``[n_windows, 2]`` (start, end-exclusive) frame indices per window."""
    if n_frames <= 0:
        return np.zeros((0, 2), dtype=np.int32)
    if n_frames < size:
        return np.array([[0, n_frames]], dtype=np.int32)
    starts = np.arange(0, n_frames - size + 1, stride, dtype=np.int32)
    return np.stack([starts, starts + size], axis=1)


def window_timestamps(timestamps: Sequence[float], size: int,
                      stride: int) -> List[float]:
    ts = np.asarray(timestamps, dtype=np.float64)
    mids = window_middle_indices(len(ts), size, stride)
    return [float(ts[i]) for i in mids]
