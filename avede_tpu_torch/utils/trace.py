"""Tracing and profiling hooks (counterpart of
``avede_tpu/utils/trace.py``).

- ``trace(label)`` wraps work in a ``torch.profiler.record_function``
  range, visible in a profiler trace, AND records its wall time into
  the live metrics monitor, so ``GET /api/metrics`` lists the span;
- ``profile_to(dir)`` captures a ``torch.profiler`` trace (host, and
  the card's kernels and copies where there is one) around a block and
  writes it into ``dir`` as a Chrome/TensorBoard trace file; with no
  directory it reads ``AVEDE_PROFILE``, and without that it does
  nothing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

from .logging import get_logger
from .metrics import get_monitor

logger = get_logger(__name__)


@contextlib.contextmanager
def trace(label: str, **labels) -> Iterator[None]:
    t0 = time.time()
    with record_function(label):
        yield
    get_monitor().record(label, time.time() - t0, **labels)


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
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    logger.info("Profile written to %s", log_dir)
