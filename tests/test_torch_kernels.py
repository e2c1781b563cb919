"""Port kernels' plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU), on the same numpy-seeded inputs.

On the CPU each wrapper runs its plain PyTorch version; the hand-written
CUDA kernels are held against those plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.ops import attention as jattn
from avede_tpu.ops import pallas_kernels as jpk
from avede_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD
from avede_tpu_torch.ops import attention as tattn
from avede_tpu_torch.ops import kernels as tk


class TestFusedPatchEmbed:
    @pytest.mark.parametrize("dtype", ["uint8", "float32"])
    def test_plain_matches_pallas(self, dtype):
        rng = np.random.default_rng(0)
        frames = rng.integers(0, 255, (3, 64, 64, 3), dtype=np.uint8)
        if dtype == "float32":       # 0..255 floats, as the I420 unpack
            frames = (frames + rng.random(frames.shape)).astype(np.float32)
        kernel = rng.normal(0, 0.02, (16, 16, 3, 32)).astype(np.float32)
        bias = rng.normal(0, 0.01, (32,)).astype(np.float32)

        ref = jpk.fused_patch_embed(jnp.asarray(frames), jnp.asarray(kernel),
                                    jnp.asarray(bias), interpret=True)
        w2, delta = tk.fold_for_uint8(torch.from_numpy(kernel))
        got = tk.fused_patch_embed(torch.from_numpy(frames), w2,
                                   delta + torch.from_numpy(bias), 16)
        assert got.shape == (3, 16, 32) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_reference_matches_jax_reference(self):
        rng = np.random.default_rng(3)
        frames = rng.integers(0, 255, (2, 32, 32, 3), dtype=np.uint8)
        kernel = rng.normal(0, 0.02, (8, 8, 3, 16)).astype(np.float32)
        bias = rng.normal(0, 0.01, (16,)).astype(np.float32)
        ref = jpk.patch_embed_reference(jnp.asarray(frames),
                                        jnp.asarray(kernel),
                                        jnp.asarray(bias))
        got = tk.patch_embed_reference(torch.from_numpy(frames),
                                       torch.from_numpy(kernel),
                                       torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_fold_matches_jax_and_is_exact(self):
        rng = np.random.default_rng(1)
        kernel = rng.normal(size=(4, 4, 3, 8)).astype(np.float32)
        jw2, jdelta = jpk.fold_for_uint8(jnp.asarray(kernel))
        w2, delta = tk.fold_for_uint8(torch.from_numpy(kernel))
        np.testing.assert_allclose(w2.numpy(), np.asarray(jw2), rtol=1e-6)
        np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta),
                                   rtol=1e-5, atol=1e-5)
        # the fold is algebra, not an approximation
        patch = rng.integers(0, 255, (4, 4, 3)).astype(np.float32)
        x_norm = ((patch / 255.0 - CLIP_MEAN) / CLIP_STD).reshape(-1)
        ref = x_norm @ kernel.reshape(-1, 8)
        got = patch.reshape(-1) @ w2.numpy() + delta.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

    def test_bad_shapes_raise(self):
        w2 = torch.zeros(192, 8)
        with pytest.raises(ValueError):
            tk.fused_patch_embed(torch.zeros(1, 30, 30, 3), w2,
                                 torch.zeros(8), 8)


class TestFlashAttention:
    @pytest.mark.parametrize("L", [50, 64, 70, 130])
    def test_plain_matches_pallas(self, L):
        rng = np.random.default_rng(L)
        q, k, v = (rng.normal(size=(1, 2, L, 16)).astype(np.float32)
                   for _ in range(3))
        ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), interpret=True)
        got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_reference_matches_jax_reference(self):
        rng = np.random.default_rng(7)
        q, k, v = (rng.normal(size=(2, 3, 17, 8)).astype(np.float32)
                   for _ in range(3))
        ref = jattn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
        got = tattn.attention_reference(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)


class TestCosineScores:
    def test_plain_matches_pallas(self):
        rng = np.random.default_rng(2)
        emb = rng.normal(size=(512, 64)).astype(np.float32)
        q = rng.normal(size=(64,)).astype(np.float32)
        ref = jpk.cosine_scores_pallas(jnp.asarray(emb), jnp.asarray(q),
                                       interpret=True, block=128)
        got = tk.cosine_scores(torch.from_numpy(emb), torch.from_numpy(q))
        assert got.shape == (512,)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)

    def test_valid_mask_and_multi_query(self):
        rng = np.random.default_rng(4)
        emb = rng.normal(size=(96, 32)).astype(np.float32)
        qs = rng.normal(size=(3, 32)).astype(np.float32)
        valid = np.arange(96) < 70
        got = tk.cosine_scores(torch.from_numpy(emb), torch.from_numpy(qs),
                               torch.from_numpy(valid)).numpy()
        assert got.shape == (96, 3)
        np.testing.assert_allclose(got[:70], emb[:70] @ qs.T, atol=1e-4)
        assert np.all(np.isneginf(got[70:]))


class TestWrapperDispatch:
    """A wrapper takes its plain version only for CPU tensors: any other
    device launches the kernel or raises, never falls back."""

    def test_non_cpu_tensors_never_fall_back(self):
        meta = torch.device("meta")
        with pytest.raises(ValueError, match="no kernel"):
            tk.fused_patch_embed(torch.empty(1, 32, 32, 3, device=meta),
                                 torch.empty(192, 8, device=meta),
                                 torch.empty(8, device=meta), 8)
        with pytest.raises(ValueError, match="no kernel"):
            tattn.flash_attention(*(torch.empty(1, 2, 50, 64, device=meta)
                                    for _ in range(3)))
        with pytest.raises(ValueError, match="no kernel"):
            tk.cosine_scores(torch.empty(8, 4, device=meta),
                             torch.empty(4, device=meta))

    def test_cpu_path_counts_no_launch(self):
        before = (tk.fused_patch_embed.launches,
                  tattn.flash_attention.launches, tk.cosine_scores.launches)
        tk.fused_patch_embed(torch.zeros(1, 16, 16, 3), torch.zeros(48, 4),
                             torch.zeros(4), 4)
        tattn.flash_attention(*(torch.zeros(1, 1, 5, 16) for _ in range(3)))
        tk.cosine_scores(torch.zeros(4, 8), torch.zeros(8))
        assert (tk.fused_patch_embed.launches,
                tattn.flash_attention.launches,
                tk.cosine_scores.launches) == before
