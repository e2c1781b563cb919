"""Mean host wall a request in the traced window inside ``kimi.prefill``,
ms: the decoder over the 30 prompts of 600 ids, writing the latent
cache. While spans record, the span ends by reading the phase's expert
counters back, so it covers the card's prefill work. From the program's
spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "kimi.prefill", "kimi.frame_repr")
