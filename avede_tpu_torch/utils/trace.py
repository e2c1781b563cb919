"""Tracing hook (counterpart of ``avede_tpu/utils/trace.py``).

``trace(label)`` wraps work in a ``torch.profiler.record_function``
range, visible in a profiler trace, AND records its wall time into the
live metrics monitor, so ``GET /api/metrics`` lists the span.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

from torch.profiler import record_function

from .metrics import get_monitor


@contextlib.contextmanager
def trace(label: str, **labels) -> Iterator[None]:
    t0 = time.time()
    with record_function(label):
        yield
    get_monitor().record(label, time.time() - t0, **labels)
