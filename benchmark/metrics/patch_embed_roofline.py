"""The I420 patch embedding against its roofline, %: the least time the
window's launches need (each over its share of the window's frames: the
patch projection's operations at the bf16 peak, or the packed frames
read, the bf16 projection read and the bf16 tokens written once at the
memory peak, whichever is longer), over the device time of every kernel
whose name holds ``patch_embed``. Nothing when no such kernel ran."""

from benchmark import roofline_clip
from benchmark.metrics_common import count, device_s


def read(ctx):
    busy = device_s(ctx.events, ("patch_embed",))
    launches = count(ctx.events, ("patch_embed",))
    frames = sum(r.units for r in ctx.records if r.ok)
    if busy == 0 or frames == 0:
        return None
    need = launches * roofline_clip.patch_embed_bound_s(
        ctx.cell.config, frames / launches)
    return 100.0 * need / busy
