"""The device trace of a measured window: kernel and copy intervals from
``torch.profiler`` (CUPTI), and what is read from them.

Only device activity is recorded (no host operator events), so the
trace costs a launch little. Event times are the profiler's, on the
host's wall clock in nanoseconds; the harness's spans are mapped onto
the same clock to say what the host was doing in a gap.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Event = Tuple[str, int, int]          # (name, start ns, end ns)


def start(cuda: bool = True):
    """Start the profiler on the card's activity (on the host's only
    where a CPU run rehearses the path; it then finds no device
    events)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()
                                              * 1000)


def stop(prof, lo_ns: int, hi_ns: int) -> List[Event]:
    """Stop ``prof`` and return its device events (kernels, copies,
    sets) that overlap ``[lo_ns, hi_ns]``, clipped to it, by start."""
    import torch

    prof.__exit__(None, None, None)
    cuda = torch.autograd.DeviceType.CUDA
    out: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        s = _ns(e, "start")
        t = s + int(e.duration_ns()) if hasattr(e, "duration_ns") \
            else _ns(e, "end")
        if t <= lo_ns or s >= hi_ns:
            continue
        out.append((e.name(), max(s, lo_ns), min(t, hi_ns)))
    out.sort(key=lambda ev: ev[1])
    return out


def merged(events: Sequence[Event]) -> List[Tuple[int, int]]:
    """The union of the events' intervals, as disjoint sorted spans."""
    spans: List[Tuple[int, int]] = []
    for _, lo, hi in sorted(events, key=lambda ev: ev[1]):
        if spans and lo <= spans[-1][1]:
            if hi > spans[-1][1]:
                spans[-1] = (spans[-1][0], hi)
        else:
            spans.append((lo, hi))
    return spans


def busy_s(events: Sequence[Event]) -> float:
    """Seconds in which at least one kernel or copy ran."""
    return sum(hi - lo for lo, hi in merged(events)) / 1e9


def top_ops(events: Sequence[Event], n: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time."""
    total: Dict[str, int] = defaultdict(int)
    for name, lo, hi in events:
        total[name] += hi - lo
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], ns / 1e9] for name, ns in top]


def idle_by_host(events: Sequence[Event], lo_ns: int, hi_ns: int,
                 host_spans: Sequence[Tuple[str, int, int]],
                 n: int = 10) -> List[list]:
    """[label, seconds]: the device's idle time inside ``[lo_ns, hi_ns]``
    summed by what the host was doing at each gap's middle (the names
    of the harness spans open then, joined by ``+``; ``between
    requests`` when none was)."""
    busy = merged(events)
    gaps, cur = [], lo_ns
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi_ns > cur:
        gaps.append((cur, hi_ns))
    # sweep the spans' opening and closing times along the gaps' middles
    marks = sorted([(s, 1, name) for name, s, _ in host_spans]
                   + [(t, -1, name) for name, _, t in host_spans])
    open_: Dict[str, int] = defaultdict(int)
    total: Dict[str, int] = defaultdict(int)
    i = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while i < len(marks) and marks[i][0] <= mid:
            open_[marks[i][2]] += marks[i][1]
            i += 1
        names = sorted(name for name, c in open_.items() if c > 0)
        total["+".join(names) or "between requests"] += b - a
    top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[label, ns / 1e9] for label, ns in top]
