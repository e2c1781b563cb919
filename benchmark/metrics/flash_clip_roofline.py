"""Flash attention in CLIP's vision tower against its roofline, %: the
least time the window's attention needs (each of the ``vision_depth``
layers over [frames, L, heads, head dim]: 4·B·H·L²·hd operations at the
bf16 peak, or q, k, v read and o written once at the memory peak,
whichever is longer), over the device time of every kernel whose name
holds ``flash``. Nothing when no such kernel ran."""

from benchmark import roofline
from benchmark.metrics_common import device_s


def read(ctx):
    busy = device_s(ctx.events, ("flash",))
    frames = sum(r.units for r in ctx.records if r.ok)
    if busy == 0 or frames == 0:
        return None
    c = ctx.cell.config
    length = (c["image_size"] // c["patch_size"]) ** 2 + 1
    need = c["vision_depth"] * roofline.flash_bound_s(
        int(frames), c["vision_heads"], length,
        c["vision_dim"] // c["vision_heads"])
    return 100.0 * need / busy
