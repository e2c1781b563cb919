"""The port's BLIP-2 Q-Former reranker against the JAX package on the
CPU: the same numpy-seeded inputs, JAX weights carried across with
``params_from_jax`` (or one ``.npz`` both packages load), f32.

Bars: image and text embeddings and ITC scores within 1e-4 (unit
vectors; f32 sums in another order); token ids and converted weights
exactly equal; the rerank order equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.utils.config import settings as jsettings
from avede_tpu_torch.models.convert import params_from_jax
from avede_tpu_torch.utils.config import settings as tsettings

TOL = 1e-4
QUERIES = ["a person walking a dog", "Red CAR turning left!",
           "unbelievably-hyphenated words, xyzzy",
           " ".join(f"word{i}" for i in range(40))]   # past 30 pieces


def _port_model(cfg, params):
    from avede_tpu_torch.models.qformer import Blip2Retrieval

    sd = params_from_jax(jax.tree.map(np.asarray, params))
    model = Blip2Retrieval(cfg).eval()
    model.load_state_dict(sd)
    return model, sd


@pytest.fixture(scope="module")
def tiny():
    from avede_tpu.models.qformer import init_blip2
    from avede_tpu.models.qformer import tiny_qformer_config as jtiny

    from avede_tpu_torch.models.qformer import tiny_qformer_config

    jmodel, params = init_blip2(jtiny(), seed=0)
    tmodel, sd = _port_model(tiny_qformer_config(), params)
    return jmodel, params, tmodel, sd


def _ids(seed, rows=3, length=7, vocab=100):
    ids = np.random.default_rng(seed).integers(1, vocab, (rows, length))
    ids[1, 5:] = 0                      # padding: masked as ids != 0
    return ids.astype(np.int32)


def _embeds(jmodel, params, tmodel, px, ids):
    with torch.no_grad():
        got = (tmodel.image_embeds(torch.from_numpy(px)).numpy(),
               tmodel.text_embeds(torch.from_numpy(ids)).numpy(),
               tmodel(torch.from_numpy(px), torch.from_numpy(ids)).numpy())
    v = {"params": params}
    ref = (jmodel.apply(v, px, method=jmodel.image_embeds),
           jmodel.apply(v, ids, method=jmodel.text_embeds),
           jmodel.apply(v, px, ids))
    return got, [np.asarray(r) for r in ref]


def test_config_fields_match_jax():
    from avede_tpu.models import qformer as jq

    from avede_tpu_torch.models import qformer as tq

    for make in ("QFormerConfig", "tiny_qformer_config"):
        tcfg, jcfg = getattr(tq, make)(), getattr(jq, make)()
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        for sub in ("vision_cfg", "text_attn_cfg"):
            tsub = dataclasses.asdict(getattr(tcfg, sub))
            jsub = dataclasses.asdict(getattr(jcfg, sub))
            assert {k: tsub[k] for k in jsub} == jsub


def test_every_jax_leaf_maps_onto_a_parameter(tiny):
    _, _, tmodel, sd = tiny
    params = {k: tuple(p.shape) for k, p in tmodel.named_parameters()}
    # JAX's init creates no ITM head (its ITC path never calls it)
    assert set(sd) == set(params) - {"itm_head.weight", "itm_head.bias"}
    assert all(tuple(sd[k].shape) == params[k] for k in sd)
    # a cross-attention layer only where i % cross_frequency == 0
    assert "qformer.layers.0.cross_attn.key.weight" in sd
    assert not any(k.startswith("qformer.layers.1.cross") for k in sd)


def test_tiny_embeddings_and_itc_match_jax(tiny):
    jmodel, params, tmodel, _ = tiny
    px = np.random.default_rng(0).normal(size=(2, 32, 32, 3)
                                         ).astype(np.float32)
    (img, txt, itc), (rimg, rtxt, ritc) = _embeds(jmodel, params, tmodel,
                                                  px, _ids(1))
    assert img.shape == (2, 4, 24) and txt.shape == (3, 24)
    assert np.abs(img - rimg).max() <= TOL
    assert np.abs(txt - rtxt).max() <= TOL
    assert itc.shape == (2, 3) and np.abs(itc - ritc).max() <= TOL
    np.testing.assert_allclose(np.linalg.norm(img, axis=-1), 1.0,
                               atol=1e-5)


def test_full_width_geometry_matches_jax():
    """``QFormerConfig()`` widths (ViT-g 1408 × 16 heads of 88 at 224 px,
    Q-Former 768 × 12 heads, 32 queries, vocab 30523) at vision depth 1
    and Q-Former depth 2: one layer with cross-attention over the
    1408-wide vision tokens, one without. Weights are numpy draws into
    JAX's shapes (no full-size init)."""
    from avede_tpu.models.qformer import Blip2Retrieval as JModel
    from avede_tpu.models.qformer import QFormerConfig as JCfg

    from avede_tpu_torch.models.qformer import QFormerConfig

    jcfg = dataclasses.replace(JCfg(), vision_depth=1, depth=2)
    jmodel = JModel(jcfg)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.zeros((1, 224, 224, 3)), jnp.ones((1, 4), jnp.int32))["params"]
    rng = np.random.default_rng(7)

    def fill(path, s):
        name = path[-1].key
        x = rng.normal(size=s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.05 * x
        if name == "kernel":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        return 0.02 * x

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    tcfg = dataclasses.replace(QFormerConfig(), vision_depth=1, depth=2)
    tmodel, sd = _port_model(tcfg, params)
    assert sd["qformer.layers.0.cross_attn.key.weight"].shape == (768, 1408)
    px = np.random.default_rng(3).normal(size=(2, 224, 224, 3)
                                         ).astype(np.float32)
    ids = _ids(4, length=9, vocab=30523)
    (img, txt, itc), (rimg, rtxt, ritc) = _embeds(jmodel, params, tmodel,
                                                  px, ids)
    assert img.shape == (2, 32, 256)
    assert np.abs(img - rimg).max() <= TOL
    assert np.abs(txt - rtxt).max() <= TOL
    assert np.abs(itc - ritc).max() <= TOL


def _fake_hf_state_dict(cfg, seed):
    """A seeded stand-in for HF ``Blip2ForImageTextRetrieval``'s state
    dict at ``cfg`` (HF's key names and torch layouts)."""
    rng = np.random.default_rng(seed)
    d, h, m, vm = cfg.vision_dim, cfg.hidden, cfg.mlp, cfg.vision_mlp
    p = cfg.patch_size
    n_pos = (cfg.image_size // p) ** 2 + 1
    shapes = {
        "vision_model.embeddings.patch_embedding.weight": (d, 3, p, p),
        "vision_model.embeddings.patch_embedding.bias": (d,),
        "vision_model.embeddings.class_embedding": (1, 1, d),
        "vision_model.embeddings.position_embedding": (1, n_pos, d),
        "vision_model.post_layernorm.weight": (d,),
        "vision_model.post_layernorm.bias": (d,),
        "query_tokens": (1, cfg.num_query_tokens, h),
        "embeddings.word_embeddings.weight": (cfg.vocab_size, h),
        "embeddings.position_embeddings.weight": (cfg.max_pos, h),
        "qformer.layernorm.weight": (h,), "qformer.layernorm.bias": (h,),
        "vision_projection.weight": (cfg.projection_dim, h),
        "vision_projection.bias": (cfg.projection_dim,),
        "text_projection.weight": (cfg.projection_dim, h),
        "text_projection.bias": (cfg.projection_dim,),
        "itm_head.weight": (2, h), "itm_head.bias": (2,),
    }

    def linear(name, out_dim, in_dim):
        shapes[f"{name}.weight"] = (out_dim, in_dim)
        shapes[f"{name}.bias"] = (out_dim,)

    for i in range(cfg.vision_depth):
        s = f"vision_model.encoder.layers.{i}"
        linear(f"{s}.self_attn.qkv", 3 * d, d)
        linear(f"{s}.self_attn.projection", d, d)
        linear(f"{s}.mlp.fc1", vm, d)
        linear(f"{s}.mlp.fc2", d, vm)
        for ln in ("layer_norm1", "layer_norm2"):
            shapes[f"{s}.{ln}.weight"] = shapes[f"{s}.{ln}.bias"] = (d,)
    for i in range(cfg.depth):
        s = f"qformer.encoder.layer.{i}"
        blocks = [("attention", h)]
        if i % cfg.cross_frequency == 0:
            blocks.append(("crossattention", d))
        for blk, kv in blocks:
            linear(f"{s}.{blk}.attention.query", h, h)
            linear(f"{s}.{blk}.attention.key", h, kv)
            linear(f"{s}.{blk}.attention.value", h, kv)
            linear(f"{s}.{blk}.output.dense", h, h)
            shapes[f"{s}.{blk}.output.LayerNorm.weight"] = (h,)
            shapes[f"{s}.{blk}.output.LayerNorm.bias"] = (h,)
        for branch in ("", "_query"):
            linear(f"{s}.intermediate{branch}.dense", m, h)
            linear(f"{s}.output{branch}.dense", h, m)
            shapes[f"{s}.output{branch}.LayerNorm.weight"] = (h,)
            shapes[f"{s}.output{branch}.LayerNorm.bias"] = (h,)
    return {k: torch.from_numpy(rng.normal(size=v).astype(np.float32))
            for k, v in sorted(shapes.items())}


def test_convert_hf_state_dict_matches_jax():
    from avede_tpu.models.qformer import Blip2Retrieval as JModel
    from avede_tpu.models.qformer import \
        convert_blip2_state_dict as jconvert
    from avede_tpu.models.qformer import tiny_qformer_config as jtiny

    from avede_tpu_torch.models.qformer import (Blip2Retrieval,
                                                convert_blip2_state_dict,
                                                tiny_qformer_config)

    cfg = dataclasses.replace(tiny_qformer_config(), vision_dim=48,
                              vision_heads=4, depth=3)
    hf = _fake_hf_state_dict(cfg, seed=0)
    got = convert_blip2_state_dict(hf, cfg)
    jparams = jconvert(hf, dataclasses.replace(jtiny(), vision_dim=48,
                                               vision_heads=4, depth=3))
    want = params_from_jax(jparams)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    model = Blip2Retrieval(cfg).eval()
    model.load_state_dict(got)                   # every key, every shape
    px = np.random.default_rng(1).normal(size=(1, 32, 32, 3)
                                         ).astype(np.float32)
    with torch.no_grad():
        img = model.image_embeds(torch.from_numpy(px)).numpy()
    ref = JModel(dataclasses.replace(jtiny(), vision_dim=48, vision_heads=4,
                                     depth=3)).apply(
        {"params": jparams}, px, method=JModel.image_embeds)
    assert np.abs(img - np.asarray(ref)).max() <= TOL


def _frames(seed, n=5):
    return np.random.default_rng(seed).integers(
        0, 255, (n, 48, 64, 3), dtype=np.uint8)


def service_config(jax_package=False):
    """``tiny_qformer_config()`` with a 128-row word table: the service
    wraps every query in [CLS] = 101 and [SEP] = 102, past the tiny
    config's 100 rows (see ``test_tiny_table_cannot_hold_sep``)."""
    if jax_package:
        from avede_tpu.models.qformer import tiny_qformer_config
    else:
        from avede_tpu_torch.models.qformer import tiny_qformer_config
    return dataclasses.replace(tiny_qformer_config(), vocab_size=128)


@functools.lru_cache(maxsize=1)
def tiny_blip2_weights():
    """(JAX model, JAX params, port state dict) of the service config,
    JAX's init from seed 0; read only."""
    from avede_tpu.models.qformer import init_blip2

    jmodel, params = init_blip2(service_config(jax_package=True), seed=0)
    return jmodel, params, params_from_jax(jax.tree.map(np.asarray, params))


def use_tiny_blip2(monkeypatch, tmp_path):
    """``BLIP_MODEL`` naming BLIP-2 in both packages, their default
    Q-Former config the service's tiny one, and one ``.npz`` of
    ``tiny_blip2_weights`` as ``BLIP_WEIGHTS`` for both → its path."""
    from avede_tpu.models import qformer as jq
    from avede_tpu.models.convert import save_params

    from avede_tpu_torch.services import captioner as tcap

    path = tmp_path / "blip2_tiny.npz"
    save_params(jax.tree.map(np.asarray, tiny_blip2_weights()[1]),
                str(path))
    for s in (jsettings, tsettings):
        monkeypatch.setattr(s, "BLIP_MODEL", "blip2-itm-vit-g")
        monkeypatch.setattr(s, "BLIP_WEIGHTS", str(path))
    jcfg = service_config(jax_package=True)    # before the patch below
    monkeypatch.setattr(jq, "QFormerConfig", lambda: jcfg)
    monkeypatch.setattr(tcap, "QFormerConfig", service_config)
    return path


def test_rerank_service_matches_jax():
    from avede_tpu.services.captioner import \
        Blip2RerankService as JService

    from avede_tpu_torch.models.tokenizer import HashTokenizer
    from avede_tpu_torch.services.captioner import Blip2RerankService

    jmodel, params, sd = tiny_blip2_weights()
    jsvc = JService(cfg=jmodel.cfg, params=params)
    tsvc = Blip2RerankService(cfg=service_config(), state_dict=sd,
                              device="cpu")
    # the bundled 30524-piece vocab does not fit a 128-id table: both
    # hash words into it
    assert isinstance(tsvc.tokenizer, HashTokenizer)
    assert tsvc.repr_kind == jsvc.repr_kind == "blip2img"
    assert tsvc.repr_tag.endswith("|torch")
    frames = _frames(0)
    got, ref = tsvc.frame_repr(frames), jsvc.frame_repr(frames)
    assert len(got) == len(ref) == 5
    assert np.abs(np.stack(got) - np.stack(ref)).max() <= TOL
    for q in QUERIES:
        want = [101] + jsvc.tokenizer.encode(q)[:30] + [102]
        assert tsvc.query_ids(q).tolist() == [want]
        s, aux = tsvc.scores_from_repr(got, q)
        rs, raux = jsvc.scores_from_repr(ref, q)
        assert s.dtype == np.float32 and np.abs(s - rs).max() <= TOL
        assert [a["itc_score"] for a in aux] == [float(v) for v in s]
        assert len(raux) == len(aux)
    assert tsvc.frame_repr(frames[:0]) == []
    s, aux = tsvc.scores_from_repr([], "q")
    assert s.shape == (0,) and aux == []


def test_tiny_table_cannot_hold_sep(tiny):
    """A deliberate difference: at ``tiny_qformer_config()`` (100 word
    rows) [CLS] and [SEP] fall outside the table; JAX's gather fills
    NaN and scores every frame NaN, the port refuses the query."""
    from avede_tpu.services.captioner import \
        Blip2RerankService as JService

    from avede_tpu_torch.models.qformer import tiny_qformer_config
    from avede_tpu_torch.services.captioner import Blip2RerankService

    jmodel, params, _, sd = tiny
    frames = _frames(1, n=2)
    jsvc = JService(cfg=jmodel.cfg, params=params)
    assert np.isnan(jsvc.rerank_scores(frames, "a dog")[0]).all()
    tsvc = Blip2RerankService(cfg=tiny_qformer_config(), state_dict=sd,
                              device="cpu")
    with pytest.raises(ValueError, match="embedding table"):
        tsvc.rerank_scores(frames, "a dog")


def test_wordpiece_encode_rule_matches_jax():
    """BLIP-2's table is 30523 wide against the bundled 30524-entry
    vocab: the encode rule takes the vocab (every real piece fits), the
    decode rule refuses it, in both packages; the ids are equal."""
    from avede_tpu.services.captioner import _wordpiece_for as jrule

    from avede_tpu_torch.models.tokenizer import WordPieceTokenizer
    from avede_tpu_torch.services.captioner import _wordpiece_for

    tok, jtok = (_wordpiece_for(None, 30523, mode="encode"),
                 jrule(None, 30523, mode="encode"))
    assert isinstance(tok, WordPieceTokenizer) and jtok is not None
    assert _wordpiece_for(None, 30523) is None
    assert jrule(None, 30523) is None
    assert _wordpiece_for(None, 100, mode="encode") is None
    for q in QUERIES:
        ids = tok.encode(q)
        assert ids == jtok.encode(q)
        assert max(ids) < 30523


def test_make_reranker_chooses_blip2(monkeypatch, tmp_path):
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.captioner import (Blip2RerankService,
                                                    make_reranker)

    path = use_tiny_blip2(monkeypatch, tmp_path)
    engine = ClipEngine(cfg=tiny_test_config(), device="cpu")
    svc = make_reranker(engine)
    assert isinstance(svc, Blip2RerankService)
    assert svc.device == engine.device
    assert svc.cfg == service_config()              # f32 on the CPU
    assert svc.repr_tag.split("|")[-2] == f"ckpt:{path}"
    frames = _frames(2, n=2)
    scores, aux = svc.rerank_scores(frames, "a dog")
    assert scores.shape == (2,) and set(aux[0]) == {"itc_score"}
