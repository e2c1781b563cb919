"""Mean host wall of ``Blip2RerankService.scores_from_repr`` a request in
the traced window, ms: tokenizing, the Q-Former's text side and the
max-over-queries dot products on the host. From the harness's span
around the call."""

from benchmark.metrics_common import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx.records, "scores_from_repr")
