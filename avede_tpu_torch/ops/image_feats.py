"""Classical image features on the host, numpy and cv2 (counterpart of
``avede_tpu/ops/image_feats.py``, function for function): perceptual
hash, colour histogram, SSIM, ORB keypoint matching, Hu moments, LBP,
HOG, edge and texture statistics, cosine similarity and the image
characteristics that pick a matching mode. They are cheap, per image
and branchy, so they stay on the host as in the JAX package; cv2 is
imported inside each function that calls it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _gray(image: np.ndarray) -> np.ndarray:
    import cv2

    if image.ndim == 3:
        return cv2.cvtColor(image, cv2.COLOR_RGB2GRAY)
    return image


# ---------------------------------------------------------------------------
# perceptual hash
# ---------------------------------------------------------------------------

def perceptual_hash(image: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """8×8 average hash → [64] bool."""
    import cv2

    g = _gray(image)
    small = cv2.resize(g, (hash_size, hash_size),
                       interpolation=cv2.INTER_AREA)
    return (small > small.mean()).reshape(-1)


def hamming_distance(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.count_nonzero(a != b))


def phash_batch(images: np.ndarray, hash_size: int = 8) -> np.ndarray:
    """[N, H, W, 3] → [N, 64] bool (vectorized over the batch)."""
    return np.stack([perceptual_hash(im, hash_size) for im in images])


def hamming_batch(query_hash: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    """[64] vs [N, 64] → [N] int distances."""
    return np.count_nonzero(hashes != query_hash[None, :], axis=1)


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------

def hsv_histogram(image: np.ndarray, bins: Tuple[int, int, int] = (8, 8, 8)
                  ) -> np.ndarray:
    import cv2

    hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)
    hist = cv2.calcHist([hsv], [0, 1, 2], None, list(bins),
                        [0, 180, 0, 256, 0, 256])
    hist = hist.reshape(-1)
    s = hist.sum()
    return hist / s if s > 0 else hist


def histogram_correlation(h1: np.ndarray, h2: np.ndarray) -> float:
    """Pearson correlation (cv2.HISTCMP_CORREL semantics)."""
    a = h1 - h1.mean()
    b = h2 - h2.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------

def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 255.0
         ) -> float:
    """Mean structural similarity on grayscale, 11×11 Gaussian window
    (standard Wang et al. constants)."""
    import cv2

    a = _gray(img1).astype(np.float64)
    b = _gray(img2).astype(np.float64)
    if a.shape != b.shape:
        b = cv2.resize(b, (a.shape[1], a.shape[0]))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    blur = lambda x: cv2.GaussianBlur(x, (11, 11), 1.5)
    mu1, mu2 = blur(a), blur(b)
    mu1q, mu2q, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(a * a) - mu1q
    s2 = blur(b * b) - mu2q
    s12 = blur(a * b) - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1q + mu2q + c1) * (s1 + s2 + c2)
    return float((num / den).mean())


# ---------------------------------------------------------------------------
# keypoint features
# ---------------------------------------------------------------------------

def orb_match_score(img1: np.ndarray, img2: np.ndarray,
                    n_features: int = 500) -> Tuple[float, int]:
    """ORB + BF-Hamming ratio-test match → (normalized score, n_good)."""
    import cv2

    orb = cv2.ORB_create(nfeatures=n_features)
    k1, d1 = orb.detectAndCompute(_gray(img1), None)
    k2, d2 = orb.detectAndCompute(_gray(img2), None)
    if d1 is None or d2 is None or len(k1) < 2 or len(k2) < 2:
        return 0.0, 0
    bf = cv2.BFMatcher(cv2.NORM_HAMMING)
    matches = bf.knnMatch(d1, d2, k=2)
    good = [m for pair in matches if len(pair) == 2
            for m, n in [pair] if m.distance < 0.75 * n.distance]
    denom = max(min(len(k1), len(k2)), 1)
    return min(len(good) / denom, 1.0), len(good)


# ---------------------------------------------------------------------------
# shape / texture descriptors
# ---------------------------------------------------------------------------

def hu_moments(image: np.ndarray) -> np.ndarray:
    """log-scaled Hu moments [7]."""
    import cv2

    g = _gray(image)
    m = cv2.moments(g)
    hu = cv2.HuMoments(m).reshape(-1)
    return -np.sign(hu) * np.log10(np.abs(hu) + 1e-30)


def lbp_histogram(image: np.ndarray, bins: int = 26) -> np.ndarray:
    """8-neighbor uniform-ish LBP histogram."""
    g = _gray(image).astype(np.int16)
    c = g[1:-1, 1:-1]
    code = np.zeros_like(c, dtype=np.uint8)
    shifts = [(-1, -1), (-1, 0), (-1, 1), (0, 1),
              (1, 1), (1, 0), (1, -1), (0, -1)]
    for bit, (dy, dx) in enumerate(shifts):
        nb = g[1 + dy: g.shape[0] - 1 + dy, 1 + dx: g.shape[1] - 1 + dx]
        code |= ((nb >= c).astype(np.uint8) << bit)
    # uniform patterns: ≤2 bit transitions → 58 patterns + 1 bucket;
    # fold to `bins` via transition count × popcount grouping
    pop = np.unpackbits(code[..., None], axis=-1).sum(-1)
    trans = np.zeros_like(code)
    for bit in range(8):
        a = (code >> bit) & 1
        b = (code >> ((bit + 1) % 8)) & 1
        trans += (a != b).astype(np.uint8)
    uniform = trans <= 2
    vals = np.where(uniform, pop, 9).astype(np.int64)  # 0..8 uniform, 9 rest
    hist = np.bincount(vals.reshape(-1), minlength=10).astype(np.float64)
    hist = hist / max(hist.sum(), 1)
    out = np.zeros(bins)
    out[: len(hist)] = hist
    return out


def hog_features(image: np.ndarray, size: Tuple[int, int] = (64, 128),
                 cell: int = 8, bins: int = 9) -> np.ndarray:
    """Histogram of oriented gradients (this cv2 build ships no
    HOGDescriptor): 8×8 cells, 9 unsigned-orientation bins, 2×2 block
    L2-hys normalization — the standard Dalal-Triggs layout."""
    import cv2

    g = cv2.resize(_gray(image), size).astype(np.float64)
    gx = cv2.Sobel(g, cv2.CV_64F, 1, 0, ksize=1)
    gy = cv2.Sobel(g, cv2.CV_64F, 0, 1, ksize=1)
    mag = np.sqrt(gx * gx + gy * gy)
    ang = np.rad2deg(np.arctan2(gy, gx)) % 180.0

    h, w = g.shape
    cy, cx = h // cell, w // cell
    bin_idx = np.minimum((ang / (180.0 / bins)).astype(np.int64), bins - 1)
    cells = np.zeros((cy, cx, bins))
    ys = (np.arange(h) // cell)[:, None]
    xs = (np.arange(w) // cell)[None, :]
    np.add.at(cells, (np.broadcast_to(ys, (h, w))[: cy * cell, : cx * cell],
                      np.broadcast_to(xs, (h, w))[: cy * cell, : cx * cell],
                      bin_idx[: cy * cell, : cx * cell]),
              mag[: cy * cell, : cx * cell])

    # 2×2 block normalization
    blocks = []
    for by in range(cy - 1):
        for bx in range(cx - 1):
            v = cells[by: by + 2, bx: bx + 2].reshape(-1)
            n = np.sqrt((v * v).sum() + 1e-6)
            v = np.minimum(v / n, 0.2)
            n2 = np.sqrt((v * v).sum() + 1e-6)
            blocks.append(v / n2)
    return np.concatenate(blocks) if blocks else np.zeros(bins)


def edge_stats(image: np.ndarray) -> np.ndarray:
    """[4]: edge density, mean/std gradient magnitude, orientation entropy."""
    import cv2

    g = _gray(image)
    gx = cv2.Sobel(g, cv2.CV_64F, 1, 0)
    gy = cv2.Sobel(g, cv2.CV_64F, 0, 1)
    mag = np.sqrt(gx * gx + gy * gy)
    ang = np.arctan2(gy, gx)
    edges = cv2.Canny(g, 50, 150)
    hist, _ = np.histogram(ang[mag > 10], bins=8, range=(-np.pi, np.pi))
    p = hist / max(hist.sum(), 1)
    entropy = float(-(p[p > 0] * np.log(p[p > 0])).sum())
    return np.array([(edges > 0).mean(), mag.mean() / 255.0,
                     mag.std() / 255.0, entropy / np.log(8)])


def texture_stats(image: np.ndarray) -> np.ndarray:
    """[4]: gray mean/std, local-contrast mean, high-freq energy."""
    import cv2

    g = _gray(image).astype(np.float64)
    blur = cv2.GaussianBlur(g, (5, 5), 0)
    hf = g - blur
    local = cv2.GaussianBlur(np.abs(hf), (9, 9), 0)
    return np.array([g.mean() / 255.0, g.std() / 255.0,
                     local.mean() / 255.0,
                     float((hf ** 2).mean()) / 255.0])


def cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


# ---------------------------------------------------------------------------
# image characteristics
# ---------------------------------------------------------------------------

def analyze_image(image: np.ndarray) -> Dict[str, float]:
    import cv2

    g = _gray(image)
    is_gray = 1.0
    if image.ndim == 3:
        diffs = (np.abs(image[..., 0].astype(int) - image[..., 1])
                 + np.abs(image[..., 1].astype(int) - image[..., 2]))
        is_gray = float(diffs.mean() < 3.0)
    edges = cv2.Canny(g, 50, 150)
    edge_density = float((edges > 0).mean())
    # background complexity: variance of block means
    h, w = g.shape
    bh, bw = max(h // 8, 1), max(w // 8, 1)
    blocks = g[: bh * 8, : bw * 8].reshape(8, bh, 8, bw).mean((1, 3))
    complexity = float(blocks.std() / 64.0)
    return {"is_grayscale": is_gray, "edge_density": edge_density,
            "background_complexity": min(complexity, 1.0),
            "brightness": float(g.mean() / 255.0),
            "contrast": float(g.std() / 64.0)}
