"""Mean host wall of ``LibrarySearch.prewarm`` a search in the traced
window, ms: listing ``VIDEO_DIR``, the set differences against the
index and the ``has`` loop under the populate lock. From the program's
``library.prewarm`` spans."""

from benchmark.program_spans import mean_ms


def read(ctx):
    return mean_ms(ctx, "library.prewarm", "library.search")
