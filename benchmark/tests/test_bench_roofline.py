"""The yardstick's counts against PERF.md's kernel table, and the
per-layer readers on a made-up traced window."""

import pytest

from benchmark import harness, roofline, stats
from benchmark.spec import Bench

BLIP2 = Bench().config("blip2-vitg-itc")
CLIP = Bench().config("clip-vit-b32")


def test_flash_row_2i():
    # [30, 257, 16, 88]: 0.0113 ms by operations, 0.0259 ms by bytes
    assert roofline.flash_flops(30, 16, 257, 88) / roofline.PEAK_BF16_FLOPS \
        == pytest.approx(0.0113e-3, rel=2e-3)
    assert roofline.flash_bytes(30, 16, 257, 88) / roofline.PEAK_HBM_BYTES \
        == pytest.approx(0.0259e-3, rel=2e-3)
    assert roofline.flash_bound_s(30, 16, 257, 88) == pytest.approx(
        0.0259e-3, rel=2e-3)


def test_topk_rows_3e_3f_and_the_library():
    assert roofline.topk_bound_s(1 << 20, 512, "bfloat16", 64) \
        == pytest.approx(0.3208e-3, rel=1e-3)
    assert roofline.topk_bound_s(1 << 20, 512, "int8", 64) \
        == pytest.approx(0.1618e-3, rel=2e-3)
    # 2^22 bf16 rows: 4.29 GB, 1.28 ms
    assert roofline.topk_bytes(1 << 22, 512, "bfloat16") / 1e9 \
        == pytest.approx(4.30, abs=0.01)
    assert roofline.topk_bound_s(1 << 22, 512, "bfloat16") \
        == pytest.approx(1.283e-3, rel=1e-3)


def test_blip2_request_counts():
    # ViT-g: 2.02 GFLOP a token × 257 tokens × 30 frames ≈ 15.6 TFLOP
    assert roofline.vit_flops(BLIP2, 30) == pytest.approx(15.62e12,
                                                          rel=2e-3)
    total = roofline.blip2_request_flops(BLIP2, 30, 10)
    assert 15.9e12 < total < 16.1e12
    # the text tower: ~5.9 GFLOP at 77 positions
    assert roofline.clip_text_flops(CLIP) == pytest.approx(5.89e9, rel=1e-2)


class _Cell:
    def __init__(self, config, traffic):
        self.config, self.traffic = config, traffic


def _ctx(config, traffic, records, events, window_s):
    w = harness.Window(0.0, window_s, records)
    from benchmark.devtrace import busy_s
    return harness.Context(_Cell(config, traffic), w, events,
                           busy_s(events), window_s)


def test_rerank_readers():
    bench = Bench()
    recs = [stats.Record(i, 0, i * 0.1, i * 0.1 + 0.05, True, 30,
                         spans=[("frame_repr", i * 0.1, i * 0.1 + 0.04),
                                ("scores_from_repr", i * 0.1 + 0.04,
                                 i * 0.1 + 0.05)],
                         request={"tokens": 10}) for i in range(10)]
    need = 39 * roofline.flash_bound_s(30, 16, 257, 88)
    per = int(need * 1e9 / 39 / 0.5)          # 50% of the bound
    events = [("void flash_wgmma_kernel<88, 96>(...)", j * per * 2,
               j * per * 2 + per) for j in range(390)]
    ctx = _ctx(BLIP2, {}, recs, events, 1.0)
    read = {m: bench.reader(m).read(ctx) for m in (
        "flash_vitg_roofline", "mfu.rerank", "idle_share.rerank",
        "image_side_ms.rerank", "text_side_ms.rerank")}
    assert read["flash_vitg_roofline"] == pytest.approx(50.0, rel=1e-3)
    assert read["mfu.rerank"] == pytest.approx(
        100 * 10 * roofline.blip2_request_flops(BLIP2, 30, 10)
        / roofline.PEAK_BF16_FLOPS)
    assert read["image_side_ms.rerank"] == pytest.approx(40.0)
    assert read["text_side_ms.rerank"] == pytest.approx(10.0)
    assert 0 < read["idle_share.rerank"] < 100
    # no flash kernel in the trace: the roofline says nothing
    assert bench.reader("flash_vitg_roofline").read(
        _ctx(BLIP2, {}, recs, [("gemm", 0, 10)], 1.0)) is None


def test_search_readers():
    bench = Bench()
    traffic = bench.traffic("library.bf16_4m")
    recs = [stats.Record(i, 0, 0, 0.01, True, 1) for i in range(4)]
    scan = roofline.topk_bound_s(1 << 22, 512, "bfloat16")
    ns = int(scan * 1e9 / 0.8)                 # 80% of the bound
    events = []
    for j in range(5):                         # 5 scans, 4 searches
        t = j * 10 * ns
        events += [("void lowp_scores_fast<Bf16Rows, 2>(...)", t,
                    t + ns // 2),
                   ("select_pass(Select)", t + ns // 2, t + ns)]
    events.append(("ampere_bf16_gemm", 0, 5))
    ctx = _ctx(CLIP, traffic, recs, events, 1.0)
    got = {m: bench.reader(m).read(ctx) for m in (
        "topk_launches_per_search", "topk_roofline", "mfu.search",
        "idle_share.search")}
    assert got["topk_launches_per_search"] == pytest.approx(1.25)
    assert got["topk_roofline"] == pytest.approx(80.0, rel=1e-3)
    want = 100 * (4 * roofline.bound_s(flops=roofline.clip_text_flops(CLIP))
                  + 5 * scan) / 1.0
    assert got["mfu.search"] == pytest.approx(want)
