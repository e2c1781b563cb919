"""Port CLIP towers against the JAX towers on the same weights
(``models.convert.params_from_jax``), at the tiny test geometry and at
full ViT-B/32 geometry. Bars: ≤2e-4 abs and ≥1−1e-3 cosine (the
BASELINE bar of ``tests/test_clip_parity.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.models import clip as jclip
from avede_tpu.ops.pallas_kernels import fused_patch_embed as j_fused
from avede_tpu.ops.preprocess import (central_square_crop,
                                      clip_preprocess as j_preprocess,
                                      resize_frames)
from avede_tpu_torch.models import clip as tclip
from avede_tpu_torch.models.convert import (flatten_params, load_params,
                                            params_from_jax)
from avede_tpu_torch.ops import kernels as tk
from avede_tpu_torch.ops.preprocess import clip_preprocess


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1)
                                * np.linalg.norm(b, axis=-1))


def _assert_parity(got, ref, atol=2e-4):
    cos = _cos(got, ref)
    assert np.all(cos >= 1 - 1e-3), f"cosine drift {1 - cos}"
    np.testing.assert_allclose(got, ref, atol=atol)


@pytest.fixture(scope="module")
def pair():
    """JAX tiny CLIP + the port model on the same weights."""
    model, params = jclip.init_clip(jclip.tiny_test_config(), seed=0)
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    ours = {}
    for flash in (False, True):
        m = tclip.CLIPModel(dataclasses.replace(tclip.tiny_test_config(),
                                                use_flash=flash))
        m.load_state_dict(sd)
        ours[flash] = m.eval()
    return model, params, ours


class TestTinyTowers:
    def test_image_conv_path(self, pair):
        jm, jp, ours = pair
        rng = np.random.default_rng(0)
        px = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
        ref = jm.apply({"params": jp}, jnp.asarray(px),
                       method=jm.encode_image)
        with torch.no_grad():
            got = ours[False].encode_image(torch.from_numpy(px))
        _assert_parity(got.numpy(), np.asarray(ref))

    def test_image_fused_patch_and_flash_path(self, pair):
        """Serving path: 0..255 frames → fused patch embed → tower with
        flash attention, against the JAX fused Pallas path (interpret)
        into its use_flash tower."""
        jm, jp, ours = pair
        cfg = jclip.tiny_test_config()
        rng = np.random.default_rng(5)
        frames = rng.integers(0, 255, (2, 40, 56, 3), dtype=np.uint8)
        x = central_square_crop(jnp.asarray(frames)).astype(jnp.float32)
        x = resize_frames(x, cfg.image_size, "bicubic")
        k = jp["vision"]["patch_embedding"]["kernel"]
        tokens = j_fused(x, k, jnp.zeros((k.shape[-1],), jnp.float32),
                         interpret=True)
        jflash = jclip.CLIPModel(dataclasses.replace(cfg, use_flash=True))
        ref = jflash.apply({"params": jp}, tokens,
                           method=jflash.encode_image_from_patches)

        model = ours[True]
        w2, b2 = tk.fold_for_uint8(
            model.vision.patch_embedding.kernel().detach())
        with torch.no_grad():
            px = clip_preprocess(torch.from_numpy(frames), cfg.image_size,
                                 normalize=False) * 255.0
            got = model.encode_image_from_patches(
                tk.fused_patch_embed(px, w2, b2, cfg.patch_size))
        _assert_parity(got.numpy(), np.asarray(ref))

    def test_text_tower(self, pair):
        jm, jp, ours = pair
        rng = np.random.default_rng(1)
        ids = rng.integers(1, 250, size=(3, 16)).astype(np.int32)
        ids[:, -1] = 255           # EOT = max id → argmax pooling
        ids[1, 9:] = 0
        ids[1, 8] = 255            # a padded sequence
        ref = jm.apply({"params": jp}, jnp.asarray(ids),
                       method=jm.encode_text)
        with torch.no_grad():
            got = ours[False].encode_text(torch.from_numpy(ids))
        _assert_parity(got.numpy(), np.asarray(ref))

    def test_text_too_long_raises(self, pair):
        _, _, ours = pair
        with pytest.raises(ValueError, match="max_text_len"):
            ours[False].encode_text(torch.zeros(1, 17, dtype=torch.long))

    def test_npz_round_trip_loads_same_weights(self, pair, tmp_path):
        """The JAX package's flat .npz loads into the port unchanged."""
        from avede_tpu.models.convert import save_params

        jm, jp, ours = pair
        path = tmp_path / "clip.npz"
        save_params(jax.tree.map(np.asarray, jp), str(path))
        sd = load_params(str(path))
        ref = ours[False].state_dict()
        assert set(sd) == set(ref)
        for key, val in sd.items():
            np.testing.assert_array_equal(val.numpy(), ref[key].numpy())
        assert len(flatten_params(jp)) == len(sd)

    def test_init_is_seeded(self):
        a = tclip.init_clip(tclip.tiny_test_config(), seed=3).state_dict()
        b = tclip.init_clip(tclip.tiny_test_config(), seed=3).state_dict()
        c = tclip.init_clip(tclip.tiny_test_config(), seed=4).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["vision.projection.weight"],
                               c["vision.projection.weight"])


class TestViTB32Geometry:
    def test_image_tower_full_geometry(self):
        """Full ViT-B/32 vision tower, 2 frames: the port's serving path
        (fused patch embed + flash attention) against the JAX conv
        path, on the same seeded weights."""
        cfg = jclip.vit_b32()
        jm = jclip.CLIPModel(cfg)
        shapes = jax.eval_shape(
            lambda: jm.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)),
                            jnp.zeros((1, 77), jnp.int32)))["params"]
        rng = np.random.default_rng(0)

        def fill(path, s):
            name = path[-1].key
            if name == "scale":
                return np.ones(s.shape, np.float32)
            if name == "bias":
                return rng.normal(0, 0.01, s.shape).astype(np.float32)
            return rng.normal(0, 0.02, s.shape).astype(np.float32)

        params = jax.tree_util.tree_map_with_path(
            fill, {"vision": shapes["vision"],
                   "logit_scale": shapes["logit_scale"]})
        frames = rng.integers(0, 255, (2, 224, 224, 3), dtype=np.uint8)
        px = j_preprocess(jnp.asarray(frames), size=224)
        ref = jm.apply({"params": params}, px, method=jm.encode_image)

        sd = params_from_jax(params)
        vision = tclip.CLIPVisionEncoder(
            dataclasses.replace(tclip.vit_b32(), use_flash=True))
        vision.load_state_dict({k[len("vision."):]: v for k, v in sd.items()
                                if k.startswith("vision.")})
        w2, b2 = tk.fold_for_uint8(
            vision.patch_embedding.kernel().detach())
        with torch.no_grad():
            tokens = tk.fused_patch_embed(torch.from_numpy(frames), w2, b2,
                                          32)
            got = tclip.CLIPModel._unit(vision(patch_tokens=tokens.float()))
        cos = _cos(got.numpy(), np.asarray(ref))
        assert np.all(cos >= 1 - 1e-3), f"cosine drift {1 - cos}"
