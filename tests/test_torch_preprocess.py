"""Port preprocessing against the JAX package: the device-side crop /
resize / normalize and I420 unpack against the JAX programs, and the
numpy host packs against the JAX package's cv2 packs (byte-equal, in
both channel orders, on downscales, exact 2× shrinks, upscales, odd
batch sizes and lengths that leave a tail after cv2's SIMD body)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.ops import dedup as jdedup
from avede_tpu.ops import preprocess as jpre
from avede_tpu_torch.ops import dedup as tdedup
from avede_tpu_torch.ops import preprocess as tpre


def _frames(seed, shape):
    """Smooth content plus noise: realistic gradients and edges, not
    only i.i.d. noise."""
    rng = np.random.default_rng(seed)
    n, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w]
    base = (127 + 100 * np.sin(xx / 7.0)[..., None]
            * np.cos(yy / 11.0)[..., None] * np.array([1.0, 0.6, -0.8]))
    noise = rng.normal(0, 25, shape)
    return np.clip(base[None] + noise, 0, 255).astype(np.uint8)


class TestDevicePreprocess:
    @pytest.mark.parametrize("shape,size", [((2, 40, 56, 3), 32),
                                            ((2, 288, 512, 3), 224),
                                            ((1, 20, 24, 3), 32)])
    def test_clip_preprocess(self, shape, size):
        frames = _frames(0, shape)
        ref = jpre.clip_preprocess(jnp.asarray(frames), size=size)
        got = tpre.clip_preprocess(torch.from_numpy(frames), size=size)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    @pytest.mark.parametrize("normalize", [True, False])
    def test_clip_preprocess_i420(self, normalize):
        rng = np.random.default_rng(1)
        packed = rng.integers(0, 256, (3, 48, 32), dtype=np.uint8)
        ref = jpre.clip_preprocess_i420(jnp.asarray(packed),
                                        normalize=normalize)
        got = tpre.clip_preprocess_i420(torch.from_numpy(packed),
                                        normalize=normalize)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    def test_i420_rejects_unpacked(self):
        with pytest.raises(ValueError):
            tpre.clip_preprocess_i420(torch.zeros(1, 32, 32,
                                                  dtype=torch.uint8))


class TestHostPack:
    @pytest.mark.parametrize("shape,size", [((3, 288, 512, 3), 224),
                                            ((3, 64, 96, 3), 32),
                                            ((2, 20, 30, 3), 32),
                                            ((2, 300, 400, 3), 224),
                                            ((1, 100, 150, 3), 224),
                                            ((5, 448, 448, 3), 224),
                                            ((3, 40, 20, 3), 32)])
    def test_pack_rgb_within_one_level(self, shape, size):
        """Byte-equal to cv2 (the name dates from a one-level bar)."""
        frames = _frames(2, shape)
        np.testing.assert_array_equal(tpre.pack_frames_rgb(frames, size),
                                      jpre.pack_frames_rgb(frames, size))

    @pytest.mark.parametrize("src", ["rgb", "bgr"])
    @pytest.mark.parametrize("shape,size", [((3, 288, 512, 3), 224),
                                            ((3, 64, 96, 3), 32),
                                            ((5, 360, 640, 3), 224),
                                            ((2, 20, 30, 3), 32),
                                            ((1, 150, 100, 3), 224),
                                            ((7, 50, 70, 3), 36)])
    def test_pack_i420_within_one_level(self, shape, size, src):
        """Byte-equal to cv2 (the name dates from a one-level bar); odd
        N, the upscale of frames smaller than the model and a 36×36 frame
        (1296 pixels a frame, so no chunk ends on cv2's SIMD width)."""
        frames = _frames(3, shape)
        got = tpre.pack_frames_i420(frames, size, src=src)
        ref = jpre.pack_frames_i420(frames, size, src=src)
        assert got.shape == ref.shape == (shape[0], size * 3 // 2, size)
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("src", ["rgb", "bgr"])
    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 17])
    def test_yuv_matrix_equals_cv2_transform(self, n, src):
        """The fixed-point YUV matrix against ``cv2.transform`` on chunks
        of every small length (each a different tail after the SIMD
        body), on every byte value in every channel."""
        rng = np.random.default_rng(n)
        px = rng.integers(0, 256, (1, n, 3), dtype=np.uint8)
        px[0, 0] = [255, 0, 255] if n > 1 else px[0, 0]
        w = tpre._YUV_W if src == "rgb" else tpre._YUV_W[:, ::-1]
        m = np.hstack([w, np.array([[0.0], [128.0], [128.0]], np.float32)])
        coef, off = tpre._yuv_fixed(src)
        x = px.astype(np.int32)
        got = np.clip((x @ coef.T + off) >> 10, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(got, cv2.transform(px, m))

    def test_upscale_equals_cv2(self):
        img = _frames(9, (2, 23, 17, 3))
        for oh, ow in ((32, 32), (64, 48), (23, 40), (30, 17)):
            got = tpre.area_resize(img, oh, ow)
            for i in range(2):
                np.testing.assert_array_equal(
                    got[i], cv2.resize(img[i], (ow, oh),
                                       interpolation=cv2.INTER_AREA))

    def test_area_resize_exact_on_fractional_shrink(self):
        img = _frames(4, (2, 288, 288, 3))
        got = tpre.area_resize(img, 224, 224)
        for i in range(2):
            ref = cv2.resize(img[i], (224, 224),
                             interpolation=cv2.INTER_AREA)
            np.testing.assert_array_equal(got[i], ref)

    def test_area_resize_two_x_exact(self):
        img = _frames(5, (1, 64, 64, 3))[..., 0]
        ref = cv2.resize(img[0], (32, 32), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(tpre.area_resize(img, 32, 32)[0], ref)


class TestDedupSignatures:
    @pytest.mark.parametrize("gray", [False, True])
    def test_signatures_match(self, gray):
        frames = _frames(6, (4, 288, 512, 3))
        if gray:
            frames = frames[..., 1]
        ref = jdedup._signatures(frames)
        got = tdedup._signatures(frames)
        np.testing.assert_allclose(got, ref, atol=1e-3)

    def test_deduper_same_mapping(self):
        base = _frames(7, (1, 64, 96, 3))
        frames = np.concatenate([base, base, _frames(8, (2, 64, 96, 3)),
                                 base])
        a, b = jdedup.FrameDeduper(1.5), tdedup.FrameDeduper(1.5)
        np.testing.assert_array_equal(a.filter(frames), b.filter(frames))
        assert a.mapping == b.mapping

    def test_rebatch(self):
        chunks = [np.arange(n) for n in (3, 0, 5, 1, 7)]
        out = list(tdedup.rebatch(iter(chunks), 4))
        assert [len(c) for c in out] == [4, 4, 4, 4]
        np.testing.assert_array_equal(
            np.concatenate(out), np.concatenate(chunks))
