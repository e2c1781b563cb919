"""Flash attention in MoonViT against its roofline, %: the least time
the window's vision attention needs (per request, each of the 27 layers
over [candidates, 2304, 16, 72]: ``roofline.flash_bound_s``) over the
device time of every kernel whose name holds ``flash_wgmma_kernel<72``.
Nothing when no such kernel ran."""

from benchmark import roofline_kimi
from benchmark.metrics_common import device_s


def read(ctx):
    busy = device_s(ctx.events, ("flash_wgmma_kernel<72",))
    if busy == 0:
        return None
    need = sum(roofline_kimi.moonvit_flash_bound_s(ctx.cell.config,
                                                   int(r.units))
               for r in ctx.records if r.ok)
    return 100.0 * need / busy
