"""The whole rerank's share of the card's bf16 peak, %: the operations
of every request the traced window finished (ViT-g and the Q-Former's
query side over its candidates, the text side over its query; see
``roofline.blip2_request_flops``) over the window's seconds."""

from benchmark import roofline


def read(ctx):
    done = [r for r in ctx.records if r.ok]
    if not done or ctx.window_s <= 0:
        return None
    flops = sum(roofline.blip2_request_flops(
        ctx.cell.config, int(r.units), r.request["tokens"]) for r in done)
    return 100.0 * flops / ctx.window_s / roofline.PEAK_BF16_FLOPS
