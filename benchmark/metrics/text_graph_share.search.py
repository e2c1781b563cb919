"""Share of the traced window's text-tower calls that replayed a
captured CUDA graph, %: the program's ``clip.encode_text`` spans whose
``graph`` attribute (the batch bucket replayed; 0 where the tower ran
eagerly) is above 0. ``None`` from a program whose spans carry no
``graph``."""

from benchmark.program_spans import window_spans


def read(ctx):
    spans = [s for s in window_spans(ctx)
             if s.name == "clip.encode_text" and "graph" in s.attrs]
    if not spans:
        return None
    return 100.0 * sum(s.attrs["graph"] > 0 for s in spans) / len(spans)
