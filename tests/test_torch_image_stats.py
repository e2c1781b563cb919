"""The port's numpy frame statistics against OpenCV itself: the gray
conversion, Gaussian blur and Canny edges byte for byte, the Laplacian
exactly (its variance within 1e-9 relative), on seeded, flat, one-step,
odd-sized and one-pixel-wide frames."""

import cv2
import numpy as np
import pytest

from avede_tpu_torch.ops import image_stats


def _frame(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "seeded":
        return rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    if kind == "flat":
        return np.full((20, 30, 3), 77, np.uint8)
    if kind == "step":
        f = np.zeros((33, 47, 3), np.uint8)
        f[:, 20:] = 200
        return f
    if kind == "block":
        f = np.zeros((33, 47, 3), np.uint8)
        f[10:25, 5:30] = (255, 10, 40)
        return f
    if kind == "textured":
        yy, xx = np.mgrid[0:97, 0:131]
        base = np.stack([60 + 40 * np.sin(xx / 7.0),
                         90 + 50 * np.cos(yy / 5.0),
                         120 + 30 * np.sin((xx + yy) / 9.0)], -1)
        return np.clip(base + rng.normal(0, 12, base.shape), 0, 255
                       ).astype(np.uint8)
    if kind == "smooth_odd":
        return cv2.GaussianBlur(rng.integers(0, 256, (29, 17, 3),
                                             dtype=np.uint8), (3, 3), 0)
    h, w = {"1x1": (1, 1), "1x7": (1, 7), "7x1": (7, 1), "2x2": (2, 2),
            "3x5": (3, 5), "5x3": (5, 3), "288x512": (288, 512)}[kind]
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


KINDS = ["seeded", "flat", "step", "block", "textured", "smooth_odd", "1x1",
         "1x7", "7x1", "2x2", "3x5", "5x3", "288x512"]


@pytest.mark.parametrize("kind", KINDS)
def test_gray_blur_and_canny_equal_opencv(kind):
    frame = _frame(kind)
    gray = cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY)
    np.testing.assert_array_equal(image_stats.rgb_to_gray(frame), gray)
    np.testing.assert_array_equal(image_stats.gaussian_blur5(gray),
                                  cv2.GaussianBlur(gray, (5, 5), 0))
    for low, high in ((50, 150), (10, 40), (100, 100)):
        np.testing.assert_array_equal(image_stats.canny(gray, low, high),
                                      cv2.Canny(gray, low, high))


@pytest.mark.parametrize("kind", KINDS)
def test_laplacian_equals_opencv(kind):
    gray = cv2.cvtColor(_frame(kind), cv2.COLOR_RGB2GRAY)
    ref = cv2.Laplacian(gray, cv2.CV_64F)
    got = image_stats.laplacian(gray)
    np.testing.assert_array_equal(got, ref)
    assert abs(got.var() - ref.var()) <= 1e-9 * max(ref.var(), 1e-300)


def test_gray_equals_opencv_on_every_color():
    """All 2^24 RGB triples (OpenCV's vectorised fixed point)."""
    v = np.arange(1 << 24, dtype=np.uint32)
    frame = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1
                     ).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(image_stats.rgb_to_gray(frame),
                                  cv2.cvtColor(frame, cv2.COLOR_RGB2GRAY))
