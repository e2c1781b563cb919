"""Tracing and profiling hooks (counterpart of
``avede_tpu/utils/trace.py``).

- ``span(name, **attrs)`` marks a piece of work inside the program. It
  records only while a ``torch.profiler`` profile runs in the process
  (``torch.autograd.profiler._is_profiler_enabled``, set by the
  profiler's start whatever its activities); otherwise it reads that
  one flag and does nothing else. While on, a span opens a
  ``record_function`` range of its name, reads ``time.perf_counter_ns``
  at its start and end, and appends ``(span_id, parent_id, root_id,
  thread_id, name, t0_ns, t1_ns, attrs)`` to a bounded in-memory ring
  (``RING_SIZE`` spans; what the ring drops is counted). The parent is
  the span open on the same thread; a root's id is its request's id,
  and every span of the request carries it as ``root_id``. Spans are
  written nowhere: ``spans_between(t0_ns, t1_ns)`` returns those inside
  an interval of ``perf_counter_ns``, which ``time.time_ns() -
  time.perf_counter_ns()`` maps onto the profiler's clock. They never
  reach the metrics monitor;
- ``trace(label)`` is ``span(label)`` that also records its wall time
  into the live metrics monitor, so ``GET /api/metrics`` lists the
  operation;
- ``profile_to(dir)`` captures a ``torch.profiler`` trace (host, and
  the card's kernels and copies where there is one) around a block and
  writes it into ``dir`` as a Chrome/TensorBoard trace file; with no
  directory it reads ``AVEDE_PROFILE``, and without that it does
  nothing. Spans record while it runs; it empties the ring as it starts
  and as it ends, since the trace file holds them as ranges.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from .logging import get_logger
from .metrics import get_monitor

logger = get_logger(__name__)

RING_SIZE = 1 << 20

# (span_id, parent_id, root_id, thread_id, name, t0_ns, t1_ns, attrs);
# a root's parent_id is 0
Span = Tuple[int, int, int, int, str, int, int, Dict[str, Any]]


class SpanRing:
    """The last ``size`` finished spans, and a count of those dropped to
    make room."""

    def __init__(self, size: int = RING_SIZE) -> None:
        self._spans: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        self.dropped = 0

    def add(self, s: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)

    def between(self, t0_ns: int, t1_ns: int) -> List[Span]:
        with self._lock:
            spans = list(self._spans)
        return [s for s in spans if s[5] >= t0_ns and s[6] <= t1_ns]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def __len__(self) -> int:
        return len(self._spans)


RING = SpanRing()
_ids = itertools.count(1)
_open: contextvars.ContextVar[Optional["_Span"]] = contextvars.ContextVar(
    "avede_open_span", default=None)


class _Off:
    """``span``'s value while nothing records: enters and exits; one
    instance serves every call."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "t0", "_range",
                 "_token")

    def __init__(self, name: str, attrs: Dict[str, Any]) -> None:
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Span":
        parent = _open.get()
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else 0
        self.root = parent.root if parent is not None else self.id
        self._token = _open.set(self)
        self.t0 = time.perf_counter_ns()
        self._range = record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _open.reset(self._token)
        RING.add((self.id, self.parent, self.root, threading.get_ident(),
                  self.name, self.t0, t1, self.attrs))


def span(name: str, **attrs: Any):
    """A context manager around one piece of work (see the module
    docstring); records only while a ``torch.profiler`` profile runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def recording() -> bool:
    """Whether ``span`` records now (a ``torch.profiler`` profile runs):
    a caller reads counters it keeps on the device only then."""
    return bool(_profiler._is_profiler_enabled)


def spans_between(t0_ns: int, t1_ns: int) -> List[Span]:
    """The recorded spans that start at or after ``t0_ns`` and end at or
    before ``t1_ns`` (``perf_counter_ns``), oldest first."""
    return RING.between(t0_ns, t1_ns)


@contextlib.contextmanager
def trace(label: str, **labels) -> Iterator[None]:
    t0 = time.perf_counter()
    with span(label, **labels):
        yield
    get_monitor().record(label, time.perf_counter() - t0, **labels)


@contextlib.contextmanager
def profile_to(log_dir: Optional[str] = None) -> Iterator[None]:
    """Capture a device profile into ``log_dir`` (or ``AVEDE_PROFILE``);
    no-op when neither names a directory."""
    log_dir = log_dir or os.environ.get("AVEDE_PROFILE")
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info("Capturing device profile → %s", log_dir)
    RING.clear()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield
    finally:
        RING.clear()
    logger.info("Profile written to %s", log_dir)
