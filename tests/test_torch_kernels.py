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

import jax

from avede_tpu.models import layers as jlayers
from avede_tpu.ops import attention as jattn
from avede_tpu.ops import pallas_kernels as jpk
from avede_tpu.ops.preprocess import CLIP_MEAN, CLIP_STD
from avede_tpu.ops.preprocess import clip_preprocess_i420 as j_i420
from avede_tpu_torch.models.convert import params_from_jax
from avede_tpu_torch.models.layers import MultiHeadAttention
from avede_tpu_torch.ops import attention as tattn
from avede_tpu_torch.ops import kernels as tk


def _unsplit(w_hi, w_lo, patch):
    """``w_hi + w_lo`` back in ``W'``'s [P·P·3, D] layout, in f32."""
    d, k = w_hi.shape
    w = (w_hi.float() + w_lo.float()).reshape(d, patch // 2, 3, 2, patch)
    return w.permute(1, 3, 4, 2, 0).reshape(k, d)


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

    @pytest.mark.parametrize("patch,dim", [(16, 32), (32, 96)])
    def test_i420_plain_matches_pallas(self, patch, dim):
        """The serving entry's plain version against the JAX package's
        device unpack (``normalize=False``, × 255) into its Pallas kernel."""
        rng = np.random.default_rng(patch)
        s = 2 * patch
        packed = rng.integers(0, 256, (3, s * 3 // 2, s), dtype=np.uint8)
        kernel = rng.normal(0, 0.02, (patch, patch, 3, dim)).astype(np.float32)
        bias = rng.normal(0, 0.01, (dim,)).astype(np.float32)
        px = j_i420(jnp.asarray(packed), normalize=False) * 255.0
        ref = jpk.fused_patch_embed(px, jnp.asarray(kernel),
                                    jnp.asarray(bias), interpret=True)
        w2, delta = tk.fold_for_uint8(torch.from_numpy(kernel))
        got = tk.fused_patch_embed_i420(torch.from_numpy(packed), w2,
                                        delta + torch.from_numpy(bias),
                                        patch, out_dtype=torch.float32)
        assert got.shape == (3, 4, dim) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=2e-4, atol=2e-4)

    def test_i420_plain_casts_to_out_dtype(self):
        rng = np.random.default_rng(4)
        packed = torch.from_numpy(rng.integers(0, 256, (2, 48, 32),
                                               dtype=np.uint8))
        w2 = torch.from_numpy(rng.normal(0, 1e-3, (768, 8)).astype(
            np.float32))
        b2 = torch.zeros(8)
        f32 = tk.fused_patch_embed_i420(packed, w2, b2, 16,
                                        out_dtype=torch.float32)
        bf = tk.fused_patch_embed_i420(packed, w2, b2, 16)
        assert bf.dtype == torch.bfloat16
        assert torch.equal(bf, f32.to(torch.bfloat16))

    @pytest.mark.parametrize("patch", [32, 16])
    def test_split_reconstructs_weights(self, patch):
        """w_hi + w_lo gives W' back within 2^-16 relative, in W''s own
        layout after the kernel's K reordering is undone."""
        rng = np.random.default_rng(patch)
        w2 = torch.from_numpy(rng.normal(0, 1e-3, (patch * patch * 3, 96)
                                         ).astype(np.float32))
        hi, lo = tk.split_patch_weights(w2, patch)
        assert hi.shape == lo.shape == (96, patch * patch * 3)
        assert hi.dtype == lo.dtype == torch.bfloat16
        back = _unsplit(hi, lo, patch)
        assert torch.all((back - w2).abs() <= w2.abs() * 2.0 ** -16)
        # column k' = (pair, channel, row, px) of the kernel's K order
        k = 2 * 3 * patch + 1 * 2 * patch + 1 * patch + 5   # pair 1, c 1, r 1
        ref = w2[(2 * 1 + 1) * patch * 3 + 5 * 3 + 1]
        assert torch.equal(hi[:, k], ref.to(torch.bfloat16))

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

    @pytest.mark.parametrize("L", [50, 70, 130])
    def test_blhd_plain_matches_pallas(self, L):
        """The serving entry's layout ([B, L, H, hd] in, [B, L, H·hd]
        out) against the Pallas kernel on transposed inputs."""
        rng = np.random.default_rng(L + 1)
        q, k, v = (rng.normal(size=(2, L, 3, 16)).astype(np.float32)
                   for _ in range(3))
        ref = jattn.flash_attention(*(jnp.asarray(t).transpose(0, 2, 1, 3)
                                      for t in (q, k, v)), interpret=True)
        ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(2, L, 48)
        got = tattn.flash_attention_blhd(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v))
        assert got.shape == (2, L, 48) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)

    def test_blhd_plain_keeps_bf16_dtype(self):
        q = torch.randn(1, 9, 2, 64).to(torch.bfloat16)
        out = tattn.flash_attention_blhd(q, q, q)
        assert out.dtype == torch.bfloat16
        ref = tattn.attention_reference(*(q.float().transpose(1, 2),) * 3)
        assert torch.equal(out, ref.transpose(1, 2).reshape(1, 9, 128)
                           .to(torch.bfloat16))

    @pytest.mark.parametrize("L", [50, 17])
    def test_attention_layer_with_flash_matches_jax(self, L):
        """``MultiHeadAttention(use_flash=True)`` on the CPU against the
        JAX layer with its Pallas flash kernel (interpret), same weights."""
        rng = np.random.default_rng(L)
        x = rng.normal(size=(2, L, 64)).astype(np.float32)
        jl = jlayers.MultiHeadAttention(64, 4, use_flash=True)
        params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        ref = jl.apply({"params": params}, jnp.asarray(x))
        layer = MultiHeadAttention(64, 4, use_flash=True)
        layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                           params)))
        with torch.no_grad():
            got = layer(torch.from_numpy(x))
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
        with pytest.raises(ValueError, match="no kernel"):
            tattn.flash_attention_blhd(*(torch.empty(
                1, 50, 2, 64, device=meta, dtype=torch.bfloat16)
                for _ in range(3)))
        with pytest.raises(ValueError, match="no kernel"):
            w = torch.empty(3072, 96, device=meta)
            tk.fused_patch_embed_i420(
                torch.empty(1, 96, 64, device=meta, dtype=torch.uint8), w,
                torch.empty(96, device=meta), 32,
                split=(torch.empty(96, 3072, device=meta,
                                   dtype=torch.bfloat16),) * 2)

    def test_cpu_path_counts_no_launch_new_entries(self):
        before = (tk.fused_patch_embed_i420.launches,
                  tattn.flash_attention_blhd.launches_by_length.total())
        tk.fused_patch_embed_i420(torch.zeros(1, 48, 32, dtype=torch.uint8),
                                  torch.zeros(768, 4), torch.zeros(4), 16)
        tattn.flash_attention_blhd(*(torch.zeros(1, 5, 2, 16)
                                     for _ in range(3)))
        assert (tk.fused_patch_embed_i420.launches,
                tattn.flash_attention_blhd.launches_by_length.total()) \
            == before

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
