"""The program's own spans in a traced window, for the per-layer
metrics that read them.

The port records a span around work inside it (``avede_tpu_torch.utils.
trace.span``) while a ``torch.profiler`` profile runs, as the window of a
``--trace 1`` run does; its spans carry ``perf_counter_ns`` times, which
``harness.EPOCH_NS`` maps onto the profiler's clock, as the harness maps
its own spans. A program without spans (no ``spans_between``) gives an
empty list, and every reader here then gives ``None``.

- ``window_spans(ctx)``: the spans inside the window, on the profiler's
  clock;
- ``mean_ms(ctx, name, root)``: the summed length of the spans named
  ``name`` over the window's finished requests, ms (``None`` when no
  span named ``root`` is there);
- ``count_per_request(ctx, name, root)``: the spans named ``name`` over
  the finished requests;
- ``idle_outside(ctx, metric)``: the share of the device's idle time,
  %, during which no program span was open on any thread; writes the
  idle seconds by program span to stderr.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from . import devtrace, harness

NO_SPAN = "between requests"       # devtrace.idle_by_host's label for none


class Span(NamedTuple):
    id: int
    parent: int
    root: int
    thread: int
    name: str
    t0: int                         # ns, the profiler's clock
    t1: int
    attrs: Dict[str, Any]


def _recorded(t0_ns: int, t1_ns: int) -> List[tuple]:
    """The program's spans inside ``[t0_ns, t1_ns]`` (``perf_counter``)."""
    try:
        from avede_tpu_torch.utils.trace import spans_between
    except ImportError:             # a program that records no spans
        return []
    return spans_between(t0_ns, t1_ns)


def window_spans(ctx) -> List[Span]:
    lo, hi = int(ctx.window.t0 * 1e9), int(ctx.window.t1 * 1e9)
    e = harness.EPOCH_NS
    return [Span(i, p, r, th, name, e + a, e + b, attrs)
            for i, p, r, th, name, a, b, attrs in _recorded(lo, hi)]


def _requests(ctx) -> int:
    return sum(r.ok for r in ctx.records)


def _named(ctx, name: str, root: str) -> Optional[List[Span]]:
    spans = window_spans(ctx)
    if _requests(ctx) == 0 or not any(s.name == root for s in spans):
        return None
    return [s for s in spans if s.name == name]


def mean_ms(ctx, name: str, root: str) -> Optional[float]:
    spans = _named(ctx, name, root)
    if spans is None:
        return None
    return sum(s.t1 - s.t0 for s in spans) / 1e6 / _requests(ctx)


def count_per_request(ctx, name: str, root: str) -> Optional[float]:
    spans = _named(ctx, name, root)
    if spans is None:
        return None
    return len(spans) / _requests(ctx)


def innermost(spans: List[Span]) -> List[Tuple[str, int, int]]:
    """Each span's own time, ``(name, start, end)`` pieces: its interval
    less its children's (a child, on its parent's thread, cuts it)."""
    kids: Dict[int, List[Span]] = defaultdict(list)
    for s in spans:
        kids[s.parent].append(s)
    out = []
    for s in spans:
        cur = s.t0
        for c in sorted(kids[s.id], key=lambda c: c.t0):
            if c.t0 > cur:
                out.append((s.name, cur, c.t0))
            cur = max(cur, c.t1)
        if s.t1 > cur:
            out.append((s.name, cur, s.t1))
    return out


def idle_outside(ctx, metric: str) -> Optional[float]:
    spans = window_spans(ctx)
    if not spans or ctx.window_s <= 0:
        return None
    lo, hi = harness.epoch_ns(ctx.window.t0), harness.epoch_ns(ctx.window.t1)
    table = devtrace.idle_by_host(ctx.events, lo, hi, innermost(spans),
                                  n=1 << 30)
    idle = sum(s for _, s in table)
    if idle <= 0:
        return None
    outside = sum(s for label, s in table if label == NO_SPAN)
    _report(metric, ctx, spans, table, idle)
    return 100.0 * outside / idle


def _report(metric: str, ctx, spans: List[Span], table: List[list],
            idle: float) -> None:
    """The idle seconds by program span (each thread's innermost open
    span, joined by ``+``), and each span's mean a finished request."""
    n = max(_requests(ctx), 1)
    lines = [f"{metric}: device idle {idle:.6f} s of a {ctx.window_s:.6f}"
             f" s window, {n} requests; idle s by open program span:"]
    lines += [f"  {label if label != NO_SPAN else 'no span open'}"
              f"  {s:.6f}" for label, s in table]
    total: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
    for s in spans:
        total[s.name][0] += 1
        total[s.name][1] += s.t1 - s.t0
    lines.append(f"{metric}: spans (count, ms a request):")
    lines += [f"  {name}  {c}  {ns / 1e6 / n:.6f}"
              for name, (c, ns) in sorted(total.items())]
    print("\n".join(lines), file=sys.stderr)
