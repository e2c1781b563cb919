"""The whole caption rerank's share of the card's bf16 peak, %: the
operations of every request the traced window finished (MoonViT, the
projector, the prefill of each 600-id prompt and the decode of its ids,
``roofline_kimi.request_flops``; the CLIP scoring is left out) over the
window's seconds."""

from benchmark import roofline, roofline_kimi
from benchmark.reference.kimi_vl import prompt


def read(ctx):
    done = [r for r in ctx.records if r.ok]
    if not done or ctx.window_s <= 0:
        return None
    cfg = ctx.cell.config
    before, after = prompt(cfg)
    length = len(before) + roofline_kimi.image_tokens(cfg) + len(after)
    flops = sum(roofline_kimi.request_flops(
        cfg, int(r.units), length, len(r.output["ids"][0])) for r in done)
    return 100.0 * flops / ctx.window_s / roofline.PEAK_BF16_FLOPS
