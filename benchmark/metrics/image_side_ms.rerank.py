"""Mean host wall of ``Blip2RerankService.frame_repr`` a request in the
traced window, ms: the upload of the candidate frames, BLIP
preprocessing, ViT-g and the Q-Former's query side, the embeddings back
on the host. From the harness's span around the call."""

from benchmark.metrics_common import mean_span_ms


def read(ctx):
    return mean_span_ms(ctx.records, "frame_repr")
