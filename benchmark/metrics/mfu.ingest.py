"""The whole ingest's share of the card's bf16 peak, %: the vision
tower's operations over every frame the traced window embedded
(``roofline_clip.clip_vision_flops``), over the window's seconds."""

from benchmark import roofline, roofline_clip


def read(ctx):
    frames = sum(r.units for r in ctx.records if r.ok)
    if frames == 0 or ctx.window_s <= 0:
        return None
    flops = roofline_clip.clip_vision_flops(ctx.cell.config, int(frames))
    return 100.0 * flops / ctx.window_s / roofline.PEAK_BF16_FLOPS
