"""Frame statistics in numpy, equal to OpenCV's (the machine with the
card has no cv2): the gray conversion, Laplacian, Gaussian blur and
Canny edges that the detection path's ``DetectionContext.from_frame``
and ``OpenVocabMatcher._enhance`` compute, each following OpenCV's own
integer rules.

- ``rgb_to_gray``: ``cvtColor(RGB2GRAY)`` on uint8, the 15-bit fixed
  point of OpenCV's vectorised path, ``(9798 R + 19235 G + 3735 B +
  2^14) >> 15`` (the 14-bit scalar table disagrees with it on about one
  pixel in 400).
- ``laplacian``: ``Laplacian(gray, CV_64F)`` (ksize 1: the 4-neighbour
  kernel), border ``BORDER_REFLECT_101``; exact in float64.
- ``gaussian_blur5``: ``GaussianBlur(gray, (5, 5), 0)`` on uint8: the
  separable ``[1, 4, 6, 4, 1] / 16`` taps (OpenCV's table for ksize 5,
  sigma 0) summed exactly and rounded half up once, reflect-101.
- ``canny``: ``Canny(gray, low, high)`` (aperture 3, L1 gradient): 3×3
  Sobel in integers with ``BORDER_REPLICATE``, magnitude ``|dx| + |dy|``,
  non-maximum suppression with OpenCV's tan 22.5° integer test and its
  strict / non-strict neighbour comparisons, then 8-connected
  hysteresis from the pixels above ``high``.
"""

from __future__ import annotations

import numpy as np

_GRAY_SHIFT = 15
_GRAY_RGB = (9798, 19235, 3735)         # R, G, B weights at 2^15
_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] RGB → uint8 [H, W]."""
    x = rgb.astype(np.int32)
    r, g, b = _GRAY_RGB
    y = (x[..., 0] * r + x[..., 1] * g + x[..., 2] * b
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.astype(np.uint8)


def laplacian(gray: np.ndarray) -> np.ndarray:
    """uint8 [H, W] → float64 [H, W], 4-neighbour Laplacian, reflect-101
    border (a side of length 1 reflects onto itself)."""
    p = _reflect101(_reflect101(gray.astype(np.float64), 1, 0), 1, 1)
    c = p[1:-1, 1:-1]
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:] - 4.0 * c


def _taps(x: np.ndarray, axis: int, taps) -> np.ndarray:
    """Valid correlation of ``x`` with integer ``taps`` along ``axis``."""
    n = x.shape[axis] - len(taps) + 1
    out = np.zeros(x.shape[:axis] + (n,) + x.shape[axis + 1:], np.int64)
    for k, w in enumerate(taps):
        out += w * np.take(x, np.arange(k, k + n), axis=axis)
    return out


def _reflect101(x: np.ndarray, r: int, axis: int) -> np.ndarray:
    """Pad ``r`` on both sides of ``axis`` with OpenCV's
    ``BORDER_REFLECT_101`` (``gfedcb|abcdefgh|gfedcba``), repeating the
    reflection for sides shorter than ``r``."""
    n = x.shape[axis]
    idx = np.arange(-r, n + r)
    if n == 1:
        idx = np.zeros_like(idx)
    else:
        period = 2 * (n - 1)
        idx = np.abs(idx) % period
        idx = np.where(idx >= n, period - idx, idx)
    return np.take(x, idx, axis=axis)


def gaussian_blur5(gray: np.ndarray) -> np.ndarray:
    """uint8 [H, W] → uint8, OpenCV's 5×5 Gaussian (sigma 0)."""
    taps = (1, 4, 6, 4, 1)
    x = _reflect101(_reflect101(gray.astype(np.int64), 2, 0), 2, 1)
    s = _taps(_taps(x, 0, taps), 1, taps)          # exact, / 256
    return ((s + 128) >> 8).astype(np.uint8)


def _sobel(gray: np.ndarray):
    """3×3 Sobel dx, dy (int32) with a replicated border."""
    p = np.pad(gray.astype(np.int32), 1, mode="edge")
    smooth_y = p[:-2] + 2 * p[1:-1] + p[2:]            # [H, W+2]
    smooth_x = p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:]   # [H+2, W]
    dx = smooth_y[:, 2:] - smooth_y[:, :-2]
    dy = smooth_x[2:] - smooth_x[:-2]
    return dx, dy


def canny(gray: np.ndarray, low: float, high: float) -> np.ndarray:
    """uint8 [H, W] → uint8 edges (255 / 0), as ``cv2.Canny(gray, low,
    high)``."""
    from scipy import ndimage

    lo, hi = int(np.floor(low)), int(np.floor(high))
    if lo > hi:
        lo, hi = hi, lo
    dx, dy = _sobel(gray)
    mag = np.abs(dx) + np.abs(dy)
    m = np.pad(mag, 1)                                  # zero outside
    c = m[1:-1, 1:-1]
    left, right = m[1:-1, :-2], m[1:-1, 2:]
    up, down = m[:-2, 1:-1], m[2:, 1:-1]
    ax = np.abs(dx).astype(np.int64)
    ay = np.abs(dy).astype(np.int64) << _CANNY_SHIFT
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << (_CANNY_SHIFT + 1))
    horizontal = ay < tg22
    vertical = ~horizontal & (ay > tg67)
    diagonal = ~horizontal & ~vertical
    # diagonal neighbours: up-left / down-right when dx and dy share a
    # sign, up-right / down-left otherwise
    same = (dx ^ dy) >= 0
    diag_a = np.where(same, m[:-2, :-2], m[:-2, 2:])
    diag_b = np.where(same, m[2:, 2:], m[2:, :-2])
    peak = ((horizontal & (c > left) & (c >= right))
            | (vertical & (c > up) & (c >= down))
            | (diagonal & (c > diag_a) & (c > diag_b)))
    candidate = peak & (c > lo)
    strong = candidate & (c > hi)
    labels, _ = ndimage.label(candidate, structure=np.ones((3, 3), bool))
    keep = np.unique(labels[strong])
    edges = np.isin(labels, keep[keep > 0])
    return np.where(edges, np.uint8(255), np.uint8(0))
