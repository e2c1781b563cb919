"""Image preprocessing (counterpart of ``avede_tpu/ops/preprocess.py``).

Device side (torch, NHWC like the JAX package): central square crop,
antialiased bicubic resize and CLIP normalisation (``clip_preprocess``),
BLIP's straight resize + normalisation (``blip_preprocess``) and the
same resize to any aspect with SigLIP's normalisation
(``siglip_preprocess``, Kimi-VL's MoonViT input), the same
crop and resize with ImageNet's normalisation (``imagenet_preprocess``,
EfficientNet's input), and the I420 unpack of the compact transfer
codec (``clip_preprocess_i420``). ``fold_normalization`` folds the
normalisation into a patch-embedding convolution's weights (f32; the
kernels' uint8 fold, which also folds /255, is
``kernels.fold_for_uint8``).

Host side (numpy, no cv2): ``pack_frames_rgb`` and ``pack_frames_i420``
shrink decoded frames to the model geometry before the host→device
copy. They give the same bytes as the JAX package's cv2 packs: cv2's
``INTER_AREA`` resize (coverage weights, a separable matrix per axis;
exact ``(sum + 2) >> 2`` on 2× downscales; on upscales ``INTER_AREA``'s
bilinear rule in cv2's 11-bit fixed point), the full-range BT.601
matrix in ``cv2.transform``'s 10-bit fixed point, and the 2×2 chroma
mean of cv2's integer-factor area path. ``area_resize`` also serves the
dedup signatures.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# OpenAI CLIP normalization constants.
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def central_square_crop(frames: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] → [N, S, S, C] with S = min(H, W), centered."""
    _, h, w, _ = frames.shape
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return frames[:, top:top + s, left:left + s, :]


def resize_frames(frames: torch.Tensor, size: int) -> torch.Tensor:
    """Float [N, H, W, C] → [N, size, size, C], bicubic with antialias —
    matches ``jax.image.resize(..., "bicubic")`` (without ``antialias``
    torch's downscale differs by up to 0.4)."""
    return resize_frames_hw(frames, size, size)


def resize_frames_hw(frames: torch.Tensor, height: int, width: int
                     ) -> torch.Tensor:
    """Float [N, H, W, C] → [N, height, width, C]: ``resize_frames`` to
    any aspect."""
    if frames.shape[1:3] == (height, width):
        return frames
    x = frames.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(height, width), mode="bicubic",
                      antialias=True, align_corners=False)
    return x.permute(0, 2, 3, 1)


def _normalize(x: torch.Tensor, mean: np.ndarray = CLIP_MEAN,
               std: np.ndarray = CLIP_STD) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def fold_normalization(kernel: torch.Tensor, bias: torch.Tensor,
                       mean: np.ndarray = CLIP_MEAN,
                       std: np.ndarray = CLIP_STD
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold ``(x - mean) / std`` into a patch-embedding conv:
    ``conv(norm(x), K, b) == conv(x, K/std, b - sum(K/std * mean))`` for
    kernels laid out ``[ph, pw, C_in, C_out]`` (HWIO)."""
    mean = torch.as_tensor(mean, dtype=kernel.dtype,
                           device=kernel.device).reshape(1, 1, 3, 1)
    std = torch.as_tensor(std, dtype=kernel.dtype,
                          device=kernel.device).reshape(1, 1, 3, 1)
    k2 = kernel / std
    return k2, bias - torch.sum(k2 * mean, dim=(0, 1, 2))


def clip_preprocess(frames: torch.Tensor, size: int = 224,
                    normalize: bool = True,
                    dtype: str = "float32") -> torch.Tensor:
    """uint8 [N, H, W, 3] → ``dtype`` [N, size, size, 3], CLIP-normalized
    (``normalize=False`` keeps [0, 1])."""
    d = _dtype(dtype)
    x = central_square_crop(frames).to(d) / 255.0
    x = resize_frames(x, size)
    return _normalize(x) if normalize else x


def blip_preprocess(frames: torch.Tensor, size: int = 384) -> torch.Tensor:
    """uint8 [N, H, W, 3] → float32 [N, size, size, 3], BLIP-normalized:
    a straight bicubic resize to size×size (no crop, aspect not kept),
    /255, then the CLIP constants (HF ``BlipImageProcessor``)."""
    x = resize_frames(frames.float() / 255.0, size)
    return _normalize(x)


def siglip_preprocess(frames: torch.Tensor, height: int, width: int
                      ) -> torch.Tensor:
    """uint8 [N, H, W, 3] → float32 [N, height, width, 3]: a straight
    bicubic resize (no crop, aspect as given), /255, then SigLIP's mean
    and std of 0.5 (MoonViT's input, Kimi-VL's image processor)."""
    x = resize_frames_hw(frames.float() / 255.0, height, width)
    return (x - 0.5) / 0.5


def imagenet_preprocess(frames: torch.Tensor, size: int = 224
                        ) -> torch.Tensor:
    """uint8 [N, H, W, 3] → float32 [N, size, size, 3]: central square
    crop, /255, bicubic resize, ImageNet normalisation (EfficientNet's
    input)."""
    x = central_square_crop(frames).float() / 255.0
    return _normalize(resize_frames(x, size), IMAGENET_MEAN, IMAGENET_STD)


def clip_preprocess_i420(packed: torch.Tensor, normalize: bool = True,
                         dtype: str = "float32") -> torch.Tensor:
    """Packed I420 uint8 [N, S*3/2, S] → ``dtype`` [N, S, S, 3]: chroma
    upsampled 2× nearest, full-range BT.601 → RGB, clipped to [0, 255],
    scaled to [0, 1] and (by default) CLIP-normalized."""
    d = _dtype(dtype)
    n, hp, s = packed.shape
    if hp != s * 3 // 2:
        raise ValueError(f"not a packed I420 batch: {tuple(packed.shape)}")
    h2 = s // 2
    y = packed[:, :s, :].to(d)
    u = packed[:, s:s + s // 4, :].reshape(n, h2, h2).to(d) - 128.0
    v = packed[:, s + s // 4:, :].reshape(n, h2, h2).to(d) - 128.0
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    x = torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0) / 255.0
    return _normalize(x) if normalize else x


# ---------------------------------------------------------------------------
# host pack (numpy)
# ---------------------------------------------------------------------------

_YUV_W = np.array([[0.299, 0.587, 0.114],
                   [-0.168736, -0.331264, 0.5],
                   [0.5, -0.418688, -0.081312]], np.float32)
# cv2.transform on uint8: coefficients and offsets in 10-bit fixed point,
# half a unit added, an arithmetic shift, then saturation
_YUV_BITS = 10
# cv2's linear resize on uint8: taps in 11-bit fixed point
_RESIZE_BITS = 11


def _bilinear_rule(src: int, dst: int):
    """INTER_AREA's bilinear rule along one axis (an upscale on either
    axis switches cv2 to it for both): → (first source index [dst],
    float32 weight of the next index [dst])."""
    scale, inv = src / dst, dst / src
    idx = np.empty(dst, np.int64)
    frac = np.empty(dst, np.float32)
    for d in range(dst):
        sx = math.floor(d * scale)
        fx = np.float32((d + 1) - (sx + 1) * inv)
        fx = np.float32(0) if fx <= 0 else fx - np.float32(math.floor(fx))
        if sx >= src - 1:
            sx, fx = src - 1, np.float32(0)
        idx[d], frac[d] = sx, fx
    return idx, frac


@functools.lru_cache(maxsize=64)
def _resize_weights(src: int, dst: int, area: bool) -> np.ndarray:
    """[dst, src] f32 interpolation matrix of cv2's INTER_AREA along one
    axis: coverage weights when shrinking (``computeResizeAreaTab``),
    INTER_AREA's bilinear rule when ``area`` is False."""
    w = np.zeros((dst, src), np.float64)
    scale = src / dst
    if area:
        for d in range(dst):
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, src - f1)
            s2 = min(math.floor(f2), src - 1)
            s1 = min(math.ceil(f1), s2)
            if s1 - f1 > 1e-3:
                w[d, s1 - 1] = np.float32((s1 - f1) / cell)
            w[d, s1:s2] = np.float32(1.0 / cell)
            if f2 - s2 > 1e-3:
                w[d, s2] = np.float32(min(f2 - s2, 1.0, cell) / cell)
    else:
        idx, frac = _bilinear_rule(src, dst)
        rows = np.arange(dst)
        np.add.at(w, (rows, idx), 1.0 - frac.astype(np.float64))
        np.add.at(w, (rows, np.minimum(idx + 1, src - 1)), frac)
    w = w.astype(np.float32)
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=64)
def _fixed_taps(src: int, dst: int):
    """The bilinear rule as cv2 runs it on uint8: → (first index, next
    index, weight of the first, weight of the next), the weights
    ``rint(w · 2^11)`` of the float32 weights."""
    idx, frac = _bilinear_rule(src, dst)
    one = np.float32(1 << _RESIZE_BITS)
    w0 = np.rint((np.float32(1) - frac) * one).astype(np.int32)
    w1 = np.rint(frac * one).astype(np.int32)
    return idx, np.minimum(idx + 1, src - 1), w0, w1


def _upscale_u8(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2's uint8 linear resize with INTER_AREA's upscale taps: the
    horizontal pass keeps ``x · 2^11`` sums, the vertical one computes
    ``((b0·(s0 >> 4)) >> 16) + ((b1·(s1 >> 4)) >> 16)``, then
    ``(t + 2) >> 2`` (``VResizeLinear``'s uchar rule)."""
    n, h, w = img.shape[:3]
    y0, y1, b0, b1 = _fixed_taps(h, out_h)
    x0, x1, a0, a1 = _fixed_taps(w, out_w)
    chan = (None,) * (img.ndim - 3)
    x = img.astype(np.int32)
    hz = x[:, :, x0] * a0[(slice(None),) + chan]
    hz += x[:, :, x1] * a1[(slice(None),) + chan]
    hz >>= 4                                          # [N, H, out_w(, C)]
    col = (slice(None), None) + chan
    out = (b0[col] * hz[:, y0]) >> 16
    out += (b1[col] * hz[:, y1]) >> 16
    out += 2
    out >>= 2
    return out.astype(np.uint8)


def area_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(..., INTER_AREA) for a batch: [N, H, W(, C)] uint8 or
    float32 → [N, out_h, out_w(, C)] of the same dtype. uint8 results
    are cv2's bytes: exact 2× shrinks use ``(a + b + c + d + 2) >> 2``,
    other shrinks round the f32 coverage sums half to even, and upscales
    run cv2's fixed-point bilinear rule."""
    n, h, w = img.shape[:3]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if img.dtype == np.uint8 and (h, w) == (2 * out_h, 2 * out_w):
        rows = img[:, 0::2].astype(np.uint16)
        rows += img[:, 1::2]
        s = rows[:, :, 0::2] + rows[:, :, 1::2]
        s += 2
        s >>= 2
        return s.astype(np.uint8)
    area = h >= out_h and w >= out_w
    if img.dtype == np.uint8 and not area:
        return _upscale_u8(img, out_h, out_w)
    wy = _resize_weights(h, out_h, area)
    wx = _resize_weights(w, out_w, area)
    x = img.astype(np.float32)
    x = np.einsum("yh,nhw...->nyw...", wy, x, optimize=True)
    x = np.einsum("xw,nyw...->nyx...", wx, x, optimize=True)
    if img.dtype == np.uint8:
        return np.clip(np.rint(x), 0, 255).astype(np.uint8)
    return x.astype(img.dtype)


def pack_frames_rgb(frames: np.ndarray, size: int) -> np.ndarray:
    """uint8 [N, H, W, 3] → [N, size, size, 3]: central square crop +
    INTER_AREA resize (the ``rgb`` compact-transfer mode)."""
    n, h, w = frames.shape[:3]
    if (h, w) == (size, size):
        return frames
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    return area_resize(frames[:, top:top + s, left:left + s], size, size)


@functools.lru_cache(maxsize=2)
def _yuv_fixed(src: str):
    """``cv2.transform``'s integer form of the BT.601 matrix: → (int32
    coefficients [3, 3] in the input's channel order, int32 offsets
    [3] with the rounding half unit added)."""
    w = _YUV_W if src == "rgb" else _YUV_W[:, ::-1]
    one = np.float32(1 << _YUV_BITS)
    coef = np.rint(w * one).astype(np.int32)
    off = np.rint(np.array([0.0, 128.0, 128.0], np.float32) * one
                  ).astype(np.int32) + (1 << (_YUV_BITS - 1))
    return coef, off


def pack_frames_i420(frames: np.ndarray, size: int,
                     src: str = "rgb") -> np.ndarray:
    """uint8 RGB (or ``src="bgr"``) [N, H, W, 3] → packed I420 uint8
    [N, size*3//2, size]: crop + INTER_AREA resize, full-range BT.601
    (the BGR channel order folds into the matrix columns), 2×2 mean
    chroma."""
    n = frames.shape[0]
    small = pack_frames_rgb(frames, size)
    coef, off = _yuv_fixed(src)
    chans = [small[..., c].astype(np.int32) for c in range(3)]
    out = np.empty((n, size * 3 // 2, size), np.uint8)
    h2, q = size // 2, size // 4
    acc = np.empty(small.shape[:3], np.int32)
    for i in range(3):
        np.multiply(chans[0], coef[i, 0], out=acc)
        acc += chans[1] * coef[i, 1]
        acc += chans[2] * coef[i, 2]
        acc += off[i]
        acc >>= _YUV_BITS
        np.clip(acc, 0, 255, out=acc)
        if i == 0:
            out[:, :size] = acc
        else:                                   # 2×2 mean, [N, h2, h2]
            lo = size + (i - 1) * q
            out[:, lo:lo + q] = area_resize(acc.astype(np.uint8), h2, h2
                                            ).reshape(n, q, size)
    return out
