"""Mean host wall a request in the traced window inside
``kimi.scores_from_repr``, ms: the 30 captions and the query through
``ClipEngine.embed_texts`` (31 texts: more than its CUDA graph's
largest bucket holds, so the eager tower) and the dot products on the
host (``KimiVLCaptionService.scores_from_repr``). From the program's
spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "kimi.scores_from_repr", "kimi.frame_repr")
