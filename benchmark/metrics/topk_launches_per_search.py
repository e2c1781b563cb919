"""Scans of the library table a search, in the traced window: launches
of the index's scoring kernels (names holding ``scores``) over the
searches. Above 1 when the per-video cap starved a pass and K' grew."""

from benchmark.metrics_common import count


def read(ctx):
    n = count(ctx.events, ("scores",))
    searches = sum(r.ok for r in ctx.records)
    if n == 0 or searches == 0:
        return None
    return n / searches
