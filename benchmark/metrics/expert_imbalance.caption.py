"""Expert load imbalance in the prefill, the mean over the window's
``kimi.prefill`` spans of ``max_load / mean_load``: the routed experts'
largest rows over their mean rows, each summed over the 26 MoE layers
(1 when every expert takes as many rows; the grouped GEMM's slowest
expert sets a layer's tail). From the program's span counters."""

from benchmark.program_spans import window_spans


def read(ctx):
    r = [s.attrs["max_load"] / s.attrs["mean_load"]
         for s in window_spans(ctx)
         if s.name == "kimi.prefill" and s.attrs.get("mean_load")]
    return sum(r) / len(r) if r else None
