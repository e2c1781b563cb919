"""The whole search's share of the card's peaks, %: for each search the
traced window finished, the text tower's operations at the bf16 peak,
plus each scan's table bytes at the memory peak (``topk_roofline``'s
count), summed and divided by the window's seconds."""

from benchmark import roofline
from benchmark.metrics_common import count


def read(ctx):
    searches = sum(r.ok for r in ctx.records)
    if searches == 0 or ctx.window_s <= 0:
        return None
    c, t = ctx.cell.config, ctx.cell.traffic
    rows = int(t["videos"]) * int(t["rows_per_video"])
    need = (searches * roofline.bound_s(flops=roofline.clip_text_flops(c))
            + count(ctx.events, ("scores",)) * roofline.topk_bound_s(
                rows, int(c["projection_dim"]),
                t["settings"]["LIBRARY_INDEX_DTYPE"]))
    return 100.0 * need / ctx.window_s
