"""Mean host wall of the candidates' upload a request in the traced
window, ms: the pageable host-to-device copy of the 30 uint8 1280×720
frames in ``KimiVLCaptionService.frame_repr``, the client's thread held
until the copy is done (behind whatever the stream already holds). From
the program's ``kimi.upload`` spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "kimi.upload", "kimi.frame_repr")
