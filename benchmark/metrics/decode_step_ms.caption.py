"""Host wall a decode step in the traced window, ms: the summed length
of the ``kimi.decode`` spans over the decode forwards they record
(their ``steps`` attribute: ids after the first, each a forward of the
batch through the latent cache). Nothing where no span has steps."""

from benchmark.program_spans import window_spans


def read(ctx):
    spans = [s for s in window_spans(ctx)
             if s.name == "kimi.decode" and s.attrs.get("steps")]
    steps = sum(s.attrs["steps"] for s in spans)
    if not steps:
        return None
    return sum(s.t1 - s.t0 for s in spans) / 1e6 / steps
