"""The grouped expert GEMM against its roofline, %: the least time the
window's expert work needs over the device time of every kernel whose
name holds ``grouped_kernel`` (gate and up with their SiLU product, and
down; the combine is not counted on either side). The least time, from
the program's span counters: each ``kimi.prefill`` span's rows
(assignments, the shared experts' included) times ``3 · 2·D·F``
operations at the bf16 peak, and each ``kimi.decode`` span's experts
touched (summed over layers and steps) times their ``3·D·F`` bf16
weights read once at the memory peak. The sum of per-phase bounds is at
most the sum of per-launch ones, so this stays a lower bound whatever
implements the layer. Nothing when no such kernel or span is there."""

from benchmark import roofline, roofline_kimi
from benchmark.metrics_common import device_s
from benchmark.program_spans import window_spans


def read(ctx):
    busy = device_s(ctx.events, ("grouped_kernel",))
    if busy == 0:
        return None
    cfg = ctx.cell.config
    need = 0.0
    for s in window_spans(ctx):
        if s.name == "kimi.prefill" and "assignments" in s.attrs:
            need += roofline.bound_s(flops=roofline_kimi.expert_flops(
                cfg, s.attrs["assignments"]))
        elif s.name == "kimi.decode" and "experts_touched" in s.attrs:
            need += roofline.bound_s(nbytes=roofline_kimi.expert_bytes(
                cfg, s.attrs["experts_touched"]))
    return 100.0 * need / busy if need else None
