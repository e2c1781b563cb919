"""Host-process tuning for the server (counterpart of
``avede_tpu/utils/system.py``): video decode allocates large frame
stacks, and a leaky request storm can exhaust host RAM.

- ``optimized_context()`` — GC thresholds tuned for large-array churn,
  restored on exit;
- ``ResourceMonitor`` — samples host memory pressure into the metrics
  monitor (``/api/metrics``) and collects garbage with a warning above
  the high-water mark.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Iterator, Optional

from .logging import get_logger
from .memory import snapshot
from .metrics import get_monitor

logger = get_logger(__name__)

GC_THRESHOLDS = (700, 10, 10)


@contextlib.contextmanager
def optimized_context() -> Iterator[None]:
    """Set ``GC_THRESHOLDS``; restore the prior thresholds on exit."""
    old_thresholds = gc.get_threshold()
    gc.set_threshold(*GC_THRESHOLDS)
    try:
        yield
    finally:
        gc.set_threshold(*old_thresholds)


class ResourceMonitor:
    """Background sampler: host memory pressure → metrics, and gc above
    the high-water mark."""

    INTERVAL_S = 5.0
    HIGH_WATER = 0.9

    def __init__(self) -> None:
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ResourceMonitor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="avede-resource-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.INTERVAL_S + 1)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.INTERVAL_S):
            mem = snapshot()
            get_monitor().record("host_memory_pressure", mem.pressure)
            if mem.pressure >= self.HIGH_WATER:
                logger.warning(
                    "Host memory pressure %.2f ≥ %.2f — forcing gc "
                    "(available %.0f MB)", mem.pressure, self.HIGH_WATER,
                    mem.available_mb)
                gc.collect()
