"""The port's BLIP captioner, grounding head and their helpers against
the JAX package on the CPU: the same numpy-seeded inputs, JAX weights
carried across with ``params_from_jax``, f32.

Bars: hidden states, logits, saliency and offsets within 1e-4 (f32 sums
in another order); greedy and beam tokens exactly equal; the resize and
the host helpers equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu_torch.models.convert import params_from_jax

TOL = 1e-4


def _port(model_cls, cfg, params):
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model = model_cls(cfg).eval()
    model.load_state_dict(sd)
    return model, sd


@pytest.fixture(scope="module")
def tiny_blip():
    from avede_tpu.models.blip import init_blip, tiny_blip_config as jtiny

    from avede_tpu_torch.models.blip import BlipCaptioner, tiny_blip_config

    jmodel, params = init_blip(jtiny(), seed=0)
    tmodel, sd = _port(BlipCaptioner, tiny_blip_config(), params)
    return jmodel, params, tmodel, sd


def _pixels(seed, n=3, size=32):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


class TestBlipCaptioner:
    def test_config_fields_match_jax(self):
        from avede_tpu.models import blip as jblip

        from avede_tpu_torch.models import blip as tblip

        # every JAX field, plus the port's serving switch (flash attention
        # in the vision tower, on by default; the trainers turn it off)
        for make in ("blip_base", "tiny_blip_config"):
            tcfg = dataclasses.asdict(getattr(tblip, make)())
            assert tcfg.pop("use_flash") is True
            assert tcfg == dataclasses.asdict(getattr(jblip, make)())

    def test_every_jax_leaf_maps_onto_a_parameter(self, tiny_blip):
        _, _, tmodel, sd = tiny_blip
        params = {k: tuple(p.shape) for k, p in tmodel.named_parameters()}
        assert set(sd) == set(params)
        assert all(tuple(sd[k].shape) == params[k] for k in sd)
        assert "vision.patch_embedding.weight" in sd    # 4-D conv, OIHW
        assert sd["vision.patch_embedding.weight"].shape == (64, 3, 8, 8)
        for raw in ("vision.class_embedding", "vision.position_embedding",
                    "text.word_embeddings", "text.position_embeddings"):
            assert raw in sd

    def test_vision_states_and_logits_match_jax(self, tiny_blip):
        jmodel, params, tmodel, _ = tiny_blip
        x = _pixels(0)
        ids = np.random.default_rng(1).integers(1, 90, (3, 6)).astype(
            np.int32)
        ids[:, 0] = jmodel.cfg.bos_token_id
        with torch.no_grad():
            v = tmodel.encode_vision(torch.from_numpy(x)).numpy()
            logits = tmodel(torch.from_numpy(x), torch.from_numpy(ids))
        ref_v = jmodel.apply({"params": params}, x,
                             method=jmodel.encode_vision)
        ref_l = jmodel.apply({"params": params}, x, ids)
        assert np.abs(v - np.asarray(ref_v)).max() <= TOL
        assert logits.dtype == torch.float32
        assert np.abs(logits.numpy() - np.asarray(ref_l)).max() <= TOL

    @pytest.mark.parametrize("seed", [2, 3])
    def test_greedy_tokens_equal_jax(self, tiny_blip, seed):
        jmodel, params, tmodel, _ = tiny_blip
        x = _pixels(seed)
        with torch.no_grad():
            got = tmodel.generate(torch.from_numpy(x)).numpy()
        ref = np.asarray(jmodel.apply({"params": params}, x,
                                      method=jmodel.generate))
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("beams", [2, 3])
    def test_beam_tokens_equal_jax(self, tiny_blip, beams):
        jmodel, params, tmodel, _ = tiny_blip
        x = _pixels(4)
        with torch.no_grad():
            got = tmodel.generate_beam(torch.from_numpy(x), beams).numpy()
        ref = np.asarray(jmodel.apply({"params": params}, x, beams,
                                      method=jmodel.generate_beam))
        np.testing.assert_array_equal(got, ref)

    def test_greedy_stops_once_every_row_ended(self, tiny_blip):
        """A decoder bias that makes EOS the argmax: JAX's while_loop
        exits after one step; the port checks every few steps and writes
        PAD meanwhile, so the tokens are the same."""
        from avede_tpu_torch.models.blip import EOS_CHECK_EVERY

        jmodel, params, tmodel, sd = tiny_blip
        eos = jmodel.cfg.eos_token_id
        jp = jax.tree.map(np.asarray, params)
        bias = jp["text"]["decoder"]["bias"].copy()
        bias[eos] += 100.0
        jp["text"]["decoder"]["bias"] = bias
        tmodel = type(tmodel)(tmodel.cfg).eval()
        tmodel.load_state_dict(params_from_jax(jp))
        x = _pixels(5)
        with torch.no_grad():
            got = tmodel.generate(torch.from_numpy(x)).numpy()
        ref = np.asarray(jmodel.apply({"params": jp}, x,
                                      method=jmodel.generate))
        np.testing.assert_array_equal(got, ref)
        assert (got[:, 1] == eos).all() and (got[:, 2:] == 0).all()
        assert tmodel.decode_steps == EOS_CHECK_EVERY


def test_flash_entry_takes_fused_qkv_thirds_in_place():
    """The card entry reads BLIP's q, k and v at the fused projection's
    row stride; its checks (which run before the device check) accept
    those views, with one token too, and refuse mixed layouts. On the CPU
    the entry is the plain attention of the same views."""
    from avede_tpu_torch.ops import attention

    for length in (577, 1):
        qkv = torch.randn(3, length, 3 * 4 * 64)
        q, k, v = (t.unflatten(-1, (4, 64)) for t in qkv.chunk(3, dim=-1))
        with pytest.raises(ValueError, match="no kernel for device"):
            attention._row_stride(q, k, v)
        with pytest.raises(ValueError, match="strides"):
            attention._row_stride(q, k.contiguous(), v)
    ref = attention.attention_reference(*(t.transpose(1, 2)
                                          for t in (q, k, v)))
    got = attention.flash_attention_blhd(q, k, v)
    assert torch.allclose(got, ref.transpose(1, 2).flatten(2))


def test_full_width_blip_matches_jax():
    """BLIP-base widths (384 px, patch 16 → 577 tokens, 768 wide, 12
    vision heads, 8 text heads, vocab 30524) at depth 1 on each side,
    one image: vision states and teacher-forced logits."""
    from avede_tpu.models.blip import BlipCaptioner as JBlip
    from avede_tpu.models.blip import blip_base as jbase

    from avede_tpu_torch.models.blip import BlipCaptioner, blip_base

    cfg = dataclasses.replace(blip_base(), vision_depth=1, text_depth=1)
    jcfg = dataclasses.replace(jbase(), vision_depth=1, text_depth=1)
    jmodel = JBlip(jcfg)
    x = _pixels(6, n=1, size=384)
    ids = np.array([[cfg.bos_token_id, 2023, 2003, 1037, 4937]], np.int32)
    params = jmodel.init(jax.random.PRNGKey(0), x, ids)["params"]
    tmodel, _ = _port(BlipCaptioner, cfg, params)
    with torch.no_grad():
        v = tmodel.encode_vision(torch.from_numpy(x)).numpy()
        logits = tmodel(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
    ref_v = np.asarray(jmodel.apply({"params": params}, x,
                                    method=jmodel.encode_vision))
    ref_l = np.asarray(jmodel.apply({"params": params}, x, ids))
    assert v.shape == (1, 577, 768) and logits.shape == (1, 5, 30524)
    assert np.abs(v - ref_v).max() <= TOL
    assert np.abs(logits - ref_l).max() <= TOL


def test_blip_preprocess_matches_jax():
    """The 288×512 decode geometry → 384×384: up in height, down in
    width; and a small frame."""
    from avede_tpu.ops.preprocess import blip_preprocess as jprep

    from avede_tpu_torch.ops.preprocess import blip_preprocess

    rng = np.random.default_rng(7)
    for shape, size in (((2, 288, 512, 3), 384), ((2, 48, 64, 3), 32)):
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
        got = blip_preprocess(torch.from_numpy(frames), size).numpy()
        ref = np.asarray(jprep(jnp.asarray(frames), size=size))
        assert got.shape == ref.shape == (2, size, size, 3)
        assert np.abs(got - ref).max() <= 1e-5


class TestGroundingHead:
    @pytest.fixture(scope="class")
    def heads(self):
        from avede_tpu.models.univtg import init_grounding
        from avede_tpu.models.univtg import tiny_grounding_config as jtiny

        from avede_tpu_torch.models.univtg import (TemporalGroundingHead,
                                                   tiny_grounding_config)

        jmodel, params = init_grounding(jtiny(32), seed=0)
        tmodel, sd = _port(TemporalGroundingHead, tiny_grounding_config(32),
                           params)
        return jmodel, params, tmodel, sd

    def test_every_jax_leaf_maps_onto_a_parameter(self, heads):
        _, _, tmodel, sd = heads
        params = {k: tuple(p.shape) for k, p in tmodel.named_parameters()}
        assert set(sd) == set(params)
        assert all(tuple(sd[k].shape) == params[k] for k in sd)

    def test_saliency_and_offsets_match_jax(self, heads):
        """Including a partly padded window and two all-False windows
        (phase 3's power-of-two window padding): finfo.min masks give
        those a uniform softmax, finite offsets, as in JAX."""
        jmodel, params, tmodel, _ = heads
        rng = np.random.default_rng(8)
        fe = rng.normal(size=(4, 16, 32)).astype(np.float32)
        te = rng.normal(size=(4, 32)).astype(np.float32)
        valid = np.ones((4, 16), bool)
        valid[1, 10:] = False
        valid[2:] = False
        with torch.no_grad():
            sal, off = tmodel(*(torch.from_numpy(a) for a in (fe, te, valid)))
        ref_s, ref_o = jmodel.apply({"params": params}, fe, te, valid)
        assert np.isfinite(off.numpy()).all()
        assert np.abs(sal.numpy() - np.asarray(ref_s)).max() <= TOL
        assert np.abs(off.numpy() - np.asarray(ref_o)).max() <= TOL
        assert (sal.numpy()[~valid] == np.finfo(np.float32).min).all()

    def test_gelu_is_the_tanh_approximation(self):
        from avede_tpu.models.layers import ACTIVATIONS as JACT

        from avede_tpu_torch.models.layers import ACTIVATIONS

        x = np.linspace(-6, 6, 101).astype(np.float32)
        for name in ("gelu", "quick_gelu", "relu", "silu"):
            got = ACTIVATIONS[name](torch.from_numpy(x)).numpy()
            np.testing.assert_allclose(got, np.asarray(JACT[name](x)),
                                       atol=1e-6)


def test_bounds_and_suppression_equal_jax():
    from avede_tpu.pipelines import phase3 as jphase3

    from avede_tpu_torch.pipelines import phase3

    rng = np.random.default_rng(9)
    n = 60
    prob = rng.uniform(0, 1, n)
    prob[20:30] = 0.9
    off = rng.uniform(0, 3, (n, 2))
    ts = np.arange(n) / 25.0
    for i in (0, 5, 25, 59):
        assert phase3._run_averaged_bounds(prob, off, ts, 0.04, i) \
            == jphase3._run_averaged_bounds(prob, off, ts, 0.04, i)
    results = [{"timestamp": float(t), "start_time": float(t - w),
                "end_time": float(t + w), "confidence": float(c)}
               for t, w, c in zip(rng.uniform(0, 20, 30),
                                  rng.uniform(0.1, 2, 30),
                                  rng.uniform(0, 1, 30))]
    results.append({"timestamp": 3.0, "confidence": 0.5})   # no bounds
    assert phase3.temporal_consistency(results) \
        == jphase3.temporal_consistency(results)


def test_wordpiece_and_hash_decoders_match_jax():
    from avede_tpu.models.tokenizer import HashCaptionDecoder as JHash
    from avede_tpu.models.tokenizer import WordPieceTokenizer as JWP
    from avede_tpu.utils.config import settings as jsettings

    from avede_tpu_torch.models.tokenizer import (HashCaptionDecoder,
                                                  WordPieceTokenizer)
    from avede_tpu_torch.utils.config import settings

    tok, ref = WordPieceTokenizer(settings.BLIP_VOCAB), \
        JWP(jsettings.BLIP_VOCAB)
    assert tok.inv == ref.inv
    text = "A man riding a horse, unbelievably quickly!"
    assert tok.encode(text) == ref.encode(text)
    ids = tok.encode(text) + [0, 101, 30522, 40000]
    assert tok.decode(ids) == ref.decode(ids)
    assert HashCaptionDecoder().decode([1, 5, 99]) \
        == JHash().decode([1, 5, 99])
