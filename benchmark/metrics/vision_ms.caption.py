"""Mean host wall a request in the traced window inside ``kimi.vision``,
ms: the SigLIP resize and normalisation, MoonViT and the projector, as
the host enqueues them (``KimiVLCaptionService.frame_repr``), any wait
inside included. From the program's spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "kimi.vision", "kimi.frame_repr")
