"""Mean host wall of the candidates' upload a request in the traced
window, ms: the pageable host-to-device copy of the uint8 frames in
``Blip2RerankService.frame_repr``, the client's thread held until the
copy is done (behind whatever the stream already holds). From the
program's ``blip2.upload`` spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "blip2.upload", "blip2.frame_repr")
