"""Helpers the per-layer metrics' readers share: spans and device events
of a traced window."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence


def _match(name: str, parts: Iterable[str]) -> bool:
    low = name.lower()
    return any(p in low for p in parts)


def device_s(events: Sequence[tuple], parts: Sequence[str]) -> float:
    """Seconds of the device events whose names hold any of ``parts``
    (case-blind), summed."""
    return sum(hi - lo for name, lo, hi in events
               if _match(name, parts)) / 1e9


def count(events: Sequence[tuple], parts: Sequence[str]) -> int:
    """Device events whose names hold any of ``parts`` (case-blind)."""
    return sum(_match(name, parts) for name, _, _ in events)


def mean_span_ms(records, span: str) -> Optional[float]:
    """Mean length of the harness spans named ``span`` over the window's
    finished requests, ms."""
    d = [b - a for r in records if r.ok for name, a, b in r.spans
         if name == span]
    return 1e3 * sum(d) / len(d) if d else None


def idle_share(ctx) -> Optional[float]:
    """100 · (1 - device busy / window)."""
    if ctx.window_s <= 0 or not ctx.events:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
