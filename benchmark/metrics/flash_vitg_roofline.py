"""Flash attention in ViT-g against its roofline, %: the least time the
window's attention needs (per request, each of the ``vision_depth``
layers over [candidates, L, heads, head dim]: 4·B·H·L²·hd operations
at the bf16 peak, or q, k, v read and o written once at the memory
peak, whichever is longer), over the device time of every kernel whose
name holds ``flash``. Nothing when no such kernel ran."""

from benchmark import roofline
from benchmark.metrics_common import device_s


def read(ctx):
    busy = device_s(ctx.events, ("flash",))
    if busy == 0:
        return None
    c = ctx.cell.config
    length = (c["image_size"] // c["patch_size"]) ** 2 + 1
    hd = c["vision_dim"] // c["vision_heads"]
    need = sum(c["vision_depth"] * roofline.flash_bound_s(
        int(r.units), c["vision_heads"], length, hd)
        for r in ctx.records if r.ok)
    return 100.0 * need / busy
