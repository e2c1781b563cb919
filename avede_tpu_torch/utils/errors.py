"""Error taxonomy, structured error log, the ``degrade`` decorator and
the API error envelope (counterpart of ``avede_tpu/utils/errors.py``)."""

from __future__ import annotations

import functools
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional

from .logging import get_logger

logger = get_logger(__name__)


class AvedeError(Exception):
    """Base framework error with a stable error code."""

    code = "AVEDE_ERROR"

    def __init__(self, message: str, **context: Any) -> None:
        super().__init__(message)
        self.context = context


class VideoValidationError(AvedeError):
    code = "VIDEO_VALIDATION"


class VideoDecodeError(AvedeError):
    code = "VIDEO_DECODE"


class ModelLoadError(AvedeError):
    code = "MODEL_LOAD"


class InferenceError(AvedeError):
    code = "INFERENCE"


class DetectionError(AvedeError):
    code = "DETECTION"


class MatchingError(AvedeError):
    code = "MATCHING"


class ClipExtractionError(AvedeError):
    code = "CLIP_EXTRACTION"


class ConfigurationError(AvedeError):
    code = "CONFIGURATION"


class ErrorLog:
    """Thread-safe rolling error log with severity stats."""

    def __init__(self, maxlen: int = 1000) -> None:
        self._lock = threading.Lock()
        self._entries: Deque[Dict[str, Any]] = deque(maxlen=maxlen)

    def record(self, exc: BaseException, severity: str = "error",
               component: str = "unknown") -> None:
        entry = {
            "time": time.time(),
            "severity": severity,
            "component": component,
            "code": getattr(exc, "code", type(exc).__name__),
            "message": str(exc),
            "traceback": traceback.format_exc(limit=6),
        }
        with self._lock:
            self._entries.append(entry)
        log = logger.critical if severity == "critical" else (
            logger.error if severity == "error" else logger.warning)
        log("[%s] %s: %s", component, entry["code"], entry["message"])

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            entries = list(self._entries)
        by_code: Dict[str, int] = {}
        for e in entries:
            by_code[e["code"]] = by_code.get(e["code"], 0) + 1
        return {"total": len(entries), "by_code": by_code,
                "recent": entries[-5:]}

    def health(self) -> Dict[str, Any]:
        s = self.stats()
        return {"status": "degraded" if s["total"] > 0 else "healthy", **s}


error_log = ErrorLog()


def degrade(default: Any = None, severity: str = "error",
            component: Optional[str] = None,
            exceptions: tuple = (Exception,)) -> Callable:
    """Decorator: on one of ``exceptions``, record it in ``error_log``
    and return ``default`` (called first when it is callable, so each
    failure gets a fresh ``list`` or ``dict``)."""

    def deco(fn: Callable) -> Callable:
        comp = component or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            try:
                return fn(*args, **kwargs)
            except exceptions as exc:  # noqa: BLE001 — deliberate degradation
                error_log.record(exc, severity=severity, component=comp)
                return default() if callable(default) else default

        return wrapper

    return deco


def error_envelope(task_id: str, exc: BaseException) -> Dict[str, Any]:
    """Typed error envelope for API responses."""
    return {
        "task_id": task_id,
        "status": "error",
        "error_code": getattr(exc, "code", type(exc).__name__),
        "error": str(exc),
        "results": [],
        "total_found": 0,
    }
