"""Mean host wall a request in the traced window inside the image side's
``blip2.vision`` span, ms: ``blip_preprocess`` and ``image_embeds`` (ViT-g
and the Q-Former's query side), with any wait inside them (a
synchronising call, the other client's thread holding the interpreter
lock), up to the readback's ``.cpu()``, which it leaves out. It is not
the launch cost alone: the span must be split (preprocess, ViT-g,
Q-Former) before a claim rests on that."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "blip2.vision", "blip2.frame_repr")
