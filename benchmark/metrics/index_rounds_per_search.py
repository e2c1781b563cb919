"""K' rounds a search in the traced window: the program's
``index.search`` spans (one a round; a round past the first when the
per-video cap starved the last) over the finished searches. The
device trace's count of the same is ``topk_launches_per_search``."""

from benchmark.program_spans import count_per_request


def read(ctx):
    return count_per_request(ctx, "index.search", "library.search")
