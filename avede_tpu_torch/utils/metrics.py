"""Runtime metrics of the request path (counterpart of
``avede_tpu/utils/metrics.py``): per-operation timings, slow-operation
alarms and process memory/CPU, served at ``GET /api/metrics``. API
handlers wrap work in ``get_monitor().track(name)``."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Any, Deque, Dict, Optional

from .config import settings
from .logging import get_logger

logger = get_logger(__name__)


class PerformanceMonitor:
    def __init__(self, window: int = 200) -> None:
        self._lock = threading.Lock()
        self._records: Dict[str, Deque[Dict[str, Any]]] = defaultdict(
            lambda: deque(maxlen=window))
        self._counts: Dict[str, int] = defaultdict(int)
        self._alarms: Deque[Dict[str, Any]] = deque(maxlen=50)
        self._start = time.time()

    @contextlib.contextmanager
    def track(self, operation: str, **labels: Any):
        t0 = time.time()
        ok = True
        try:
            yield
        except Exception:
            ok = False
            raise
        finally:
            dt = time.time() - t0
            rec = {"t": t0, "seconds": dt, "ok": ok, **labels}
            with self._lock:
                self._records[operation].append(rec)
                self._counts[operation] += 1
                if dt > settings.ALARM_PROC_SECONDS:
                    self._alarms.append({"operation": operation,
                                         "seconds": dt, "time": t0})
                    logger.warning("SLOW: %s took %.2fs (budget %.1fs)",
                                   operation, dt, settings.ALARM_PROC_SECONDS)

    def record(self, operation: str, seconds: float, **labels: Any) -> None:
        with self._lock:
            self._records[operation].append(
                {"t": time.time(), "seconds": seconds, "ok": True, **labels})
            self._counts[operation] += 1

    def _system(self) -> Dict[str, Any]:
        try:
            import psutil
        except ImportError:        # psutil is optional
            return {}
        p = psutil.Process()
        return {
            "rss_mb": p.memory_info().rss / (1024 ** 2),
            "cpu_percent": p.cpu_percent(interval=None),
            "host_available_mb":
                psutil.virtual_memory().available / (1024 ** 2),
        }

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            ops = {}
            for op, recs in self._records.items():
                if not recs:
                    continue
                times = sorted(r["seconds"] for r in recs)
                n = len(times)
                ops[op] = {
                    "count_total": self._counts[op],
                    "count_window": n,
                    "p50_seconds": times[n // 2],
                    "p95_seconds": times[min(int(n * 0.95), n - 1)],
                    "mean_seconds": sum(times) / n,
                    "errors_window": sum(1 for r in recs if not r["ok"]),
                }
            alarms = list(self._alarms)
        return {"uptime_seconds": time.time() - self._start,
                "operations": ops, "alarms": alarms,
                "system": self._system()}


_MONITOR: Optional[PerformanceMonitor] = None
_MONITOR_LOCK = threading.Lock()


def get_monitor() -> PerformanceMonitor:
    """The process-wide monitor, built on first use."""
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None:
            _MONITOR = PerformanceMonitor()
        return _MONITOR
