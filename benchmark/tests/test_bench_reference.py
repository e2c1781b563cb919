"""The plain references against the port at tiny sizes on the CPU,
through the harness's whole run (the chip's look skipped), and the
references' own parts."""

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import blip2_itc, clip_text, library_topk
from benchmark.reference.tokens import ClipBPE, WordPiece
from benchmark.spec import Bench

from conftest import KEPT

# every cell of BENCHMARK.json, and the kept mix: a new cell is run here
# by being there
CELLS = [w["name"] for w in Bench().spec["workloads"]] + [KEPT["name"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct(tiny, cell, trace):
    r = harness.run_cell(tiny, cell, 2 ** 31 + 12345, 0.3, trace, "cpu",
                         0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    want = {m["name"] for m in (tiny.cell(cell).per_layer if trace
                                else tiny.cell(cell).end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want


def test_the_port_at_f32_matches_the_blip2_reference_closely(tiny):
    r = harness.run_cell(tiny, "blip2.rerank.cold30", 5, 0.2, False, "cpu",
                         0.0)
    assert r["checks"]["score_gap"]["value"] < 1e-5


def test_tokenizers_match_the_ports():
    from avede_tpu_torch.models.tokenizer import Tokenizer
    from avede_tpu_torch.services.captioner import _wordpiece_for

    words = (Bench().data("words.txt").read_text().split()
             + ["unhappiness", "tokenization", "zzzqx"])
    rng = np.random.default_rng(0)
    bpe, wp = ClipBPE(), WordPiece()
    port_bpe = Tokenizer(vocab_size=49408, context_len=77)
    port_wp = _wordpiece_for(None, 30523, mode="encode")
    for _ in range(100):
        text = " ".join(rng.choice(words, rng.integers(1, 14)))
        assert np.array_equal(bpe([text], 77), port_bpe([text]))
        assert np.array_equal(
            wp(text), [[101] + port_wp.encode(text)[:30] + [102]])
    with pytest.raises(ValueError):
        bpe(["Not lowercase"], 77)


def test_weights_repeat_from_the_seed_and_cover_the_models():
    from avede_tpu_torch.models.clip import CLIPModel
    from avede_tpu_torch.models.qformer import Blip2Retrieval, QFormerConfig

    bench = Bench()
    for name, model, spec_of in (
            ("blip2-vitg-itc", lambda c: Blip2Retrieval(QFormerConfig(**{
                k: c[k] for k in QFormerConfig.__dataclass_fields__
                if k in c})), blip2_itc.param_spec),
            ("clip-vit-b32", lambda c: CLIPModel(__import__(
                "avede_tpu_torch.models.clip", fromlist=["CLIPConfig"]
            ).CLIPConfig(**{k: c[k] for k in ("image_size", "patch_size",
                                              "vision_dim", "vision_depth",
                                              "vision_heads", "text_dim",
                                              "text_depth", "text_heads",
                                              "vocab_size", "max_text_len",
                                              "projection_dim")})),
             clip_text.param_spec)):
        cfg = bench.config(name)
        with torch.device("meta"):
            sd = model(cfg).state_dict()
        spec = spec_of(cfg)
        assert {k: tuple(v.shape) for k, v in sd.items()} == dict(spec)
        for k, shape in spec:
            weights.kind(k, shape)          # every weight has a rule
    tiny = [("a.weight", (8, 4)), ("a.bias", (8,)), ("n.layer_norm1.weight",
                                                      (4,))]
    a = weights.make(tiny, 3, "cpu", torch.bfloat16)
    b = weights.make(tiny, 3, "cpu", torch.bfloat16)
    c = weights.make(tiny, 4, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["a.weight"], c["a.weight"])
    assert a["a.weight"].dtype == torch.bfloat16


def test_tier_rounding_and_the_capped_search():
    g = torch.Generator().manual_seed(0)
    rows = torch.randn(64, 32, generator=g)
    rows = rows / rows.norm(dim=1, keepdim=True)
    b = library_topk.tier_rows(rows, "bfloat16")
    assert torch.equal(b, rows.to(torch.bfloat16).float())
    q = library_topk.tier_rows(rows, "int8")
    scale = rows.abs().amax(1, keepdim=True) / 127
    assert torch.allclose(q / scale, torch.round(q / scale), atol=1e-3)
    assert (q - rows).abs().max() <= scale.max() / 2 + 1e-7
    # ties go to the lower row; the cap skips a full video's rows
    s = torch.tensor([0.5, 0.9, 0.9, 0.8, 0.7, 0.1])
    assert library_topk.stable_order(s).tolist() == [1, 2, 3, 4, 0, 5]
    got = library_topk.capped_search(s, lambda r: r // 3, top_k=3,
                                     threshold=0.2, per_video_k=1)
    assert got == [1, 3]                   # row 5 is under the threshold
    gap, err = library_topk.judge(s, [1, 3], [(1, 0.9), (4, 0.75)])
    assert gap == pytest.approx(0.1) and err == pytest.approx(0.05)
    assert library_topk.judge(s, [1, 3], [(1, 0.9)])[0] == float("inf")
