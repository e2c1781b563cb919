"""Tails and rates over a whole measured window.

A request is in the window when its client sent it before the window's
end; every such request is waited for. A failed request counts against
``attempted`` and sits in the tail as infinitely late. A rate is the
work of all the window's requests over the time from the window's start
to the last of them ending; never a median of chunks.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Any, List, Sequence


@dataclass
class Record:
    """One request: its index, client, host times (``perf_counter``
    seconds), outcome, work units, output and the harness's spans
    (name, start, end) around the calls it made."""

    index: int
    client: int
    sent: float
    done: float
    ok: bool
    units: float
    output: Any = None
    spans: List[tuple] = field(default_factory=list)
    request: Any = None
    error: str = ""

    @property
    def latency(self) -> float:
        return self.done - self.sent if self.ok else math.inf


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(v)))
    return v[rank - 1]


def tail_ms(records: Sequence[Record], q: float = 95.0) -> float:
    return percentile([r.latency for r in records], q) * 1e3


def rate(records: Sequence[Record], t0: float) -> float:
    """Units of every request of the window over the seconds from the
    window's start to the last one's end."""
    if not records:
        return 0.0
    end = max(r.done for r in records)
    return sum(r.units for r in records if r.ok) / (end - t0)


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median (Python's quartiles)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
