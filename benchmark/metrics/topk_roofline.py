"""The index's fused score and top-k against its roofline, %: a scan's
least time (the valid rows at the tier's width, their valid mask,
int8's scales, the query; at the memory peak) times the scans (scoring
launches), over the device time of the scoring, select and sort
kernels of the top-k. Nothing when no scan ran."""

from benchmark import roofline
from benchmark.metrics_common import count, device_s

TOPK_KERNELS = ("scores", "select_pass", "sort", "topk")


def read(ctx):
    scans = count(ctx.events, ("scores",))
    busy = device_s(ctx.events, TOPK_KERNELS)
    if scans == 0 or busy == 0:
        return None
    t = ctx.cell.traffic
    rows = int(t["videos"]) * int(t["rows_per_video"])
    need = scans * roofline.topk_bound_s(
        rows, int(ctx.cell.config["projection_dim"]),
        t["settings"]["LIBRARY_INDEX_DTYPE"])
    return 100.0 * need / busy
