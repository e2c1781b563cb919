"""Kimi-VL at the tiny preset on the CPU, against the plain f32 reference
of the benchmark (``benchmark/reference/kimi_vl.py``, which imports
nothing of the port) on the same seeded f32 weights: the prefill, greedy
decoding through the latent cache, the expert layer, the routing,
MoonViT's positions, the reranker end to end, and the weight digest.

Tolerances: both sides compute in f32 on the CPU; they differ only in
the order of sums (the absorbed against the expanded MLA, stacked
against per-token expert products, the shared experts split in two), so
logits agree to 1e-4 (absolute, on logits of size ~1) and an expert
layer to 1e-5.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from avede_tpu_torch.models import kimi_vl as K
from avede_tpu_torch.ops import moe
from benchmark import weights_by_tensor
from benchmark.reference import kimi_vl as R
from benchmark.reference.tokens import ClipBPE
from benchmark.spec import Bench

SEED = 2 ** 31 + 4242


def _file_cfg():
    """The benchmark's configuration file with its tiny cut, as a dict."""
    bench = Bench()
    cfg = dict(bench.config("kimi-vl-a3b-instruct"))
    cfg.update(__import__("json").loads(
        bench.find("tiny", "kimi-vl-a3b-instruct", ".json").read_text()))
    return cfg


@pytest.fixture(scope="module")
def tiny():
    d = _file_cfg()
    cfg = K.KimiVLConfig.from_dict(d)
    sd = weights_by_tensor.make(R.param_spec(d), SEED, "cpu", torch.float32)
    model = K.state_dict_on(cfg, sd, "cpu")
    ref = R.KimiRef(d, R.Weights(d, SEED, "cpu", torch.float32))
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 48, 64, 3), dtype=np.uint8))
    return d, cfg, model, ref, frames


def _inputs(d, cfg, frames, ref):
    before, after = R.prompt(d)
    ids = torch.tensor(before + [cfg.media_pad_id] * cfg.image_tokens
                       + after).expand(len(frames), -1)
    px = R.preprocess(frames, cfg.image_height, cfg.image_width)
    return ids, px, len(before)


def _ref_logits(ref, ids, img, at):
    """Reference logits at every position of ids, its own routes."""
    x = ref.embed(ids, img, at)
    routes = []
    for i in range(ref.m.layers):
        x, own, _ = ref.layer(i, ref.w.get(f"model.layers.{i}."), x, 0)
        if own is not None:
            routes.append(own)
    return ref._head(x), torch.stack(routes)


def test_reference_spec_is_the_models_state_dict(tiny):
    d, cfg, model, _, _ = tiny
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} \
        == dict(R.param_spec(d))
    full = Bench().config("kimi-vl-a3b-instruct")
    with torch.device("meta"):
        big = K.KimiVL(K.KimiVLConfig.from_dict(full))
    assert {k: tuple(v.shape) for k, v in big.state_dict().items()} \
        == dict(R.param_spec(full))
    n = sum(np.prod(s) for _, s in R.param_spec(full))
    assert 16.3e9 < n < 16.5e9                    # 16.4 B, nothing cut
    for name, shape in R.param_spec(full):
        weights_by_tensor.kind(name, shape)       # every weight has a rule


def test_image_tokens_match_reference(tiny):
    d, cfg, model, ref, frames = tiny
    _, px, _ = _inputs(d, cfg, frames, ref)
    with torch.no_grad():
        got = model.image_embeds(px)
        want = ref.image_embeds(px)
    assert got.shape == (2, cfg.image_tokens, cfg.hidden_size)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_prefill_logits_match_reference(tiny):
    d, cfg, model, ref, frames = tiny
    ids, px, at = _inputs(d, cfg, frames, ref)
    with torch.no_grad():
        img = model.image_embeds(px)
        cache = model.new_cache(2, ids.shape[1] + 1)
        last, routes = model.prefill(ids, img, at, cache, keep_routes=True)
        want, own = _ref_logits(ref, ids, img, at)
    torch.testing.assert_close(last, want[:, -1], atol=1e-4, rtol=0)
    assert torch.equal(routes.long(), own)


def test_decode_through_the_latent_cache_matches_full_forward(tiny):
    """Prefill, then 8 greedy steps through the latent cache (absorbed
    MLA), each step's logits against the reference's full expanded
    forward over the prompt and the ids generated so far."""
    d, cfg, model, ref, frames = tiny
    ids, px, at = _inputs(d, cfg, frames, ref)
    p = ids.shape[1]
    with torch.no_grad():
        img = model.image_embeds(px)
        cache = model.new_cache(2, p + 8)
        logits, _ = model.prefill(ids, img, at, cache)
        seq = ids
        for step in range(8):
            tok = logits.argmax(-1)
            seq = torch.cat([seq, tok[:, None]], 1)
            logits, _ = model.decode_step(tok, p + step, cache)
            want, _ = _ref_logits(ref, seq, img, at)
            torch.testing.assert_close(logits, want[:, -1], atol=1e-4,
                                       rtol=0)
        out = K.generate(model, ids, img, at, 8, cfg.im_end_id,
                         keep_routes=True)
        bare = K.generate(model, ids, img, at, 8, cfg.im_end_id)
    assert out["ids"].shape == (2, 8)
    assert out["routes"].shape == (cfg.n_moe_layers, 2, p + 7,
                                   cfg.num_experts_per_tok)
    # routes are kept only when asked for; the ids do not depend on it
    assert "routes" not in bare and torch.equal(bare["ids"], out["ids"])


def _per_token_layer(x, slots, weights, wg, wu, wd):
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for e, w in zip(slots[t].tolist(), weights[t].tolist()):
            out[t] += w * moe.expert_swiglu(x[t:t + 1], wg[e], wu[e],
                                            wd[e])[0]
    return out


def test_plain_moe_matches_per_token_loop_at_uneven_loads():
    """An expert with no token, one with every token, the shared experts
    with every token: no row dropped; the stacked shared halves equal
    one SwiGLU of the whole shared width."""
    g = torch.Generator().manual_seed(0)
    t, dim, f, e, s = 12, 16, 8, 6, 2
    wg, wu = (torch.randn(e + s, f, dim, generator=g) * dim ** -0.5
              for _ in range(2))
    wd = torch.randn(e + s, dim, f, generator=g) * f ** -0.5
    x = torch.randn(t, dim, generator=g)
    choice = torch.stack([torch.full((t,), 3), torch.arange(t) % 2,
                          torch.arange(t) % 2 + 4], 1)
    slots = torch.cat([choice, torch.tensor([e, e + 1]).expand(t, -1)], 1)
    w = torch.rand(t, 5, generator=g)
    r = moe.Routing(slots, w)
    d = moe.dispatch(slots, e + s)
    assert d.counts.tolist() == [t // 2, t // 2, 0, t, t // 2, t // 2, t, t]
    got = moe.grouped_swiglu(x, r, d, wg, wu, wd)
    torch.testing.assert_close(got, _per_token_layer(x, slots, w, wg, wu,
                                                     wd), atol=1e-5,
                               rtol=1e-5)
    # the shared experts as stacked halves = one SwiGLU of width 2F
    only = moe.Routing(slots[:, 3:], torch.ones(t, 2))
    half = moe.grouped_swiglu(x, only, moe.dispatch(slots[:, 3:], e + s),
                              wg, wu, wd)
    whole = moe.expert_swiglu(x, wg[e:].flatten(0, 1), wu[e:].flatten(0, 1),
                              wd[e:].permute(1, 0, 2).flatten(1))
    torch.testing.assert_close(half, whole, atol=1e-5, rtol=1e-5)


def test_noaux_tc_bias_moves_the_choice_not_the_weights():
    h = torch.tensor([[1.0, 0.0]])
    gate = torch.tensor([[2.0, 0.0], [1.9, 0.0], [0.0, 0.0], [-1.0, 0.0]])
    r0 = moe.route(h, gate, torch.zeros(4), 2, 2.446, 1)
    assert sorted(r0.slots[0, :2].tolist()) == [0, 1]
    bias = torch.tensor([0.0, -1.0, 0.0, 0.0])      # expert 1 pushed out
    r1 = moe.route(h, gate, bias, 2, 2.446, 1)
    assert sorted(r1.slots[0, :2].tolist()) == [0, 2]
    s = torch.sigmoid(h @ gate.T)[0]
    want = torch.stack([s[0], s[2]]) / (s[0] + s[2]) * 2.446
    got = r1.weights[0, :2][torch.argsort(r1.slots[0, :2])]
    torch.testing.assert_close(got, want)
    assert r1.slots[0, 2] == 4 and r1.weights[0, 2] == 1.0   # the shared


def test_moonvit_rope_table_and_merge_on_a_non_square_grid():
    """A 6×4 grid: pair 2j turns by the column, 2j + 1 by the row; the
    position table resized bicubically to 6×4; each 2×2 block merged
    row-major into one token."""
    hd, gh, gw = 16, 6, 4
    cos, sin = K.vision_rope(hd, gh, gw, 10000.0, "cpu")
    freqs = 1.0 / 10000.0 ** (torch.arange(0, hd, 4).float() / hd)
    for i in range(gh * gw):
        r, c = divmod(i, gw)
        ang = torch.stack([c * freqs, r * freqs], -1).flatten()
        torch.testing.assert_close(cos[i], torch.cos(ang))
        torch.testing.assert_close(sin[i], torch.sin(ang))
    x = torch.randn(gh * gw, 2, hd)
    y = K.rotate_pairs(x, cos[:, None], sin[:, None])
    a, b = x[..., 0::2], x[..., 1::2]
    torch.testing.assert_close(y[..., 0::2], a * cos[:, None] - b * sin[:, None])
    cfg = K.tiny_kimi_vl_config()
    vt = K.MoonViT(cfg)
    with torch.no_grad():
        vt.patch_embed.pos_emb.normal_()
    want = F.interpolate(vt.patch_embed.pos_emb.permute(2, 0, 1)[None],
                         size=(gh, gw), mode="bicubic",
                         align_corners=False)[0].permute(1, 2, 0)
    torch.testing.assert_close(vt.position_table(gh, gw),
                               want.reshape(gh * gw, -1))
    proj = K.Projector(cfg)
    d = cfg.vision_hidden_size
    tokens = torch.arange(gh * gw, dtype=torch.float32)[None, :, None] \
        .expand(1, -1, d)
    seen = {}

    class Grab(torch.nn.Module):
        def forward(self, z):
            seen["x"] = z
            return z

    proj.pre_norm = torch.nn.Identity()
    proj.linear_1 = torch.nn.Identity()
    proj.linear_2 = Grab()
    with torch.no_grad():
        proj(tokens, gh, gw)
    merged = seen["x"][0, :, ::d]   # GELU of each patch's index, 4 a token
    assert merged.shape == (gh * gw // 4, 4)
    for tok, patches in ((0, [0, 1, 4, 5]), (1, [2, 3, 6, 7]),
                         (2, [8, 9, 12, 13])):
        torch.testing.assert_close(merged[tok],
                                   F.gelu(torch.tensor(patches).float()))


def test_prompt_caption_and_clip_ids_match_the_reference():
    from avede_tpu_torch.models.tokenizer import HashCaptionDecoder, Tokenizer
    from avede_tpu_torch.services.captioner import kimi_prompt

    d = _file_cfg()
    cfg = K.KimiVLConfig.from_dict(d)
    assert kimi_prompt(cfg) == R.prompt(d)
    assert [len(p) for p in R.prompt(d)] == [12, 12]
    full = Bench().config("kimi-vl-a3b-instruct")
    assert kimi_prompt(K.KimiVLConfig.from_dict(full)) == R.prompt(full)
    ids = [7, 3, 163000, 12, cfg.im_end_id, 99]
    assert R.caption(ids, cfg.im_end_id) == HashCaptionDecoder().decode(
        [7, 3, 163000, 12])
    caps = ["tok404 tok36 tok451", "image content", "tok7"]
    assert np.array_equal(R.clip_ids(ClipBPE(), caps, 77),
                          Tokenizer(vocab_size=49408, context_len=77)(caps))


def test_siglip_preprocess_matches_reference():
    from avede_tpu_torch.ops.preprocess import siglip_preprocess

    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 72, 128, 3), dtype=np.uint8))
    got = siglip_preprocess(x, 36, 64)
    assert got.shape == (2, 36, 64, 3)
    torch.testing.assert_close(got, R.preprocess(x, 36, 64))


def test_make_reranker_kimi_vl_end_to_end(monkeypatch):
    """``BLIP_MODEL`` "kimi-vl" picks the Kimi-VL captioner (its default
    config patched to the tiny one), deterministic across two calls."""
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services import captioner
    from avede_tpu_torch.utils.config import settings

    monkeypatch.setattr(settings, "BLIP_MODEL", "kimi-vl-a3b-instruct")
    monkeypatch.setattr(captioner, "KimiVLConfig",
                        lambda: K.tiny_kimi_vl_config())
    engine = ClipEngine(cfg=tiny_test_config(), device="cpu")
    svc = captioner.make_reranker(engine)
    assert isinstance(svc, captioner.KimiVLCaptionService)
    frames = np.random.default_rng(2).integers(0, 256, (3, 48, 64, 3),
                                               dtype=np.uint8)
    a = svc.rerank_scores(frames, "a dog on a beach")
    b = svc.rerank_scores(frames, "a dog on a beach")
    assert a[0].shape == (3,) and np.isfinite(a[0]).all()
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    assert svc.repr_tag.startswith("kimicap|32x16|") and "rand0" in \
        svc.repr_tag


def _old_identity(state_dict):
    """The digest as it was computed before: every tensor to the host as
    f32, its first and last KB."""
    h = hashlib.md5()
    for name in sorted(state_dict):
        a = np.ascontiguousarray(
            state_dict[name].detach().float().cpu().numpy())
        h.update(str(a.shape).encode())
        b = a.tobytes()
        h.update(b[:1024])
        h.update(b[-1024:])
    return "explicit:" + h.hexdigest()[:8]


def test_params_identity_keeps_its_tags():
    """Sliced on the tensor's device, the digest is the one it was for
    every shape: 0-d, under 256 values, between 256 and 512, large,
    non-contiguous, bf16 and f64."""
    from avede_tpu_torch.services.captioner import _params_identity

    g = torch.Generator().manual_seed(3)
    sd = {"a.scalar": torch.tensor(1.5),
          "b.small": torch.randn(7, generator=g),
          "c.mid": torch.randn(3, 100, generator=g),
          "d.big": torch.randn(64, 65, generator=g).to(torch.bfloat16),
          "e.strided": torch.randn(40, 30, generator=g).t(),
          "f.double": torch.randn(300, generator=g, dtype=torch.float64)}
    assert _params_identity(sd) == _old_identity(sd)
    sd2 = dict(sd, **{"d.big": sd["d.big"].clone()})
    sd2["d.big"][-1, -1] += 1
    assert _params_identity(sd2) != _params_identity(sd)


def test_config_from_the_benchmark_file_is_the_published_model():
    cfg = K.KimiVLConfig.from_dict(Bench().config("kimi-vl-a3b-instruct"))
    assert cfg == dataclasses.replace(K.KimiVLConfig(), dtype="bfloat16")
    assert cfg.grid == (36, 64) and cfg.image_tokens == 576
    assert cfg.vision_hidden_size // cfg.vision_heads == 72
