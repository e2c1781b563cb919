"""Host-memory guard for the decode path (counterpart of
``avede_tpu/utils/memory.py:23-70``): video decode can exhaust host
RAM, so the frame sampler consults ``decode_budget``; ``snapshot``
also feeds ``utils/system.ResourceMonitor``."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence, Tuple

from .logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class HostMemory:
    total_mb: float
    available_mb: float

    @property
    def pressure(self) -> float:
        """0 (free) → 1 (exhausted)."""
        if self.total_mb <= 0:
            return 0.0
        return 1.0 - self.available_mb / self.total_mb


def snapshot() -> HostMemory:
    """Host total and available MB; (0, inf) when psutil is missing."""
    try:
        import psutil
    except ImportError:
        return HostMemory(0.0, float("inf"))
    vm = psutil.virtual_memory()
    return HostMemory(vm.total / 2 ** 20, vm.available / 2 ** 20)


def decode_budget(n_frames: int, frame_hw: Tuple[int, int],
                  sample_rate: int) -> Tuple[int, int]:
    """Adapt (max_frames, sample_rate) to available host RAM: at most
    25% of it for the decoded stack; above 85% pressure the sample
    rate doubles before the cap shrinks."""
    mem = snapshot()
    if mem.available_mb == float("inf"):
        return n_frames, sample_rate
    frame_mb = frame_hw[0] * frame_hw[1] * 3 / 2 ** 20
    budget_frames = int(max(mem.available_mb * 0.25 / max(frame_mb, 1e-6),
                            16))
    if mem.pressure > 0.85:
        sample_rate *= 2
        logger.warning("Host memory pressure %.0f%% — doubling sample "
                       "rate to %d", mem.pressure * 100, sample_rate)
    if n_frames > budget_frames:
        logger.info("Decode budget: capping %d → %d frames "
                    "(%.0f MB available)", n_frames, budget_frames,
                    mem.available_mb)
        n_frames = budget_frames
    return n_frames, sample_rate


def chunked(seq: Sequence, size: int) -> Iterator[Sequence]:
    """Consecutive slices of ``seq`` of ``size`` items (the last may be
    shorter)."""
    for lo in range(0, len(seq), max(size, 1)):
        yield seq[lo: lo + size]
