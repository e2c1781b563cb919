"""Batching executor: coalesces concurrent requests into one device batch
(counterpart of ``avede_tpu/parallel/scheduler.py``).

Under load many API requests each want a handful of crops embedded;
one tower call per request leaves the card mostly idle between tiny
batches. ``BatchingExecutor`` queues work items, and a dispatcher thread
drains the queue every ``max_wait_ms`` (or as soon as ``max_batch`` rows
are pending), concatenates the tensors with ``torch.cat``, runs ONE
batched call, and scatters the result rows back to the waiting futures
by offset. An exception in the call reaches every waiter of that batch.

Thread and stream rules on the card:
- the dispatcher thread enters the batch's device itself
  (``torch.cuda.device``): the current device is per thread;
  ``inference_mode`` is per thread too, so the batched function carries
  its own decorator (``ClipEngine.embed_pixels`` does);
- each submitted CUDA tensor comes with an event recorded on the
  submitting thread's current stream, and the dispatcher's stream waits
  on it before it reads the tensor; the batched function returns host
  arrays (``embed_pixels`` ends in ``.cpu()``, which waits for the
  device), so nothing made on the dispatcher's stream is read elsewhere,
  and a submitted tensor is not freed before the call that reads it has
  finished (the dispatcher holds it until then);
- the thread is a daemon, so it never keeps the process alive.

Usage:
    ex = BatchingExecutor(engine.embed_pixels, max_batch=128)
    fut = ex.submit(pixels_a)        # from any thread
    emb_a = fut.result()
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import get_logger

logger = get_logger(__name__)

_Item = Tuple[torch.Tensor, Optional["torch.cuda.Event"], Future]


class BatchingExecutor:
    def __init__(self, batched_fn: Callable[[torch.Tensor], np.ndarray],
                 max_batch: int = 256, max_wait_ms: float = 5.0) -> None:
        self._fn = batched_fn
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._stats = {"batches": 0, "items": 0, "requests": 0}
        self._thread = threading.Thread(target=self._dispatch, daemon=True,
                                        name="avede-batcher")
        self._thread.start()

    def submit(self, items: torch.Tensor) -> Future:
        """items: [n, ...] tensor; the future resolves to the [n, D]
        rows of the batched function's result."""
        fut: Future = Future()
        ready = None
        if items.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(items.device))
        self._q.put((items, ready, fut))
        return fut

    def __call__(self, items: torch.Tensor) -> np.ndarray:
        return self.submit(items).result()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=5)

    @property
    def stats(self) -> dict:
        return dict(self._stats)

    # ------------------------------------------------------------------
    def _dispatch(self) -> None:
        while True:
            first = self._q.get()
            if first is None:
                return
            pending: List[_Item] = [first]
            count = len(first[0])
            t0 = time.monotonic()
            while count < self._max_batch:
                remaining = self._max_wait - (time.monotonic() - t0)
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run(pending)
                    return
                pending.append(nxt)
                count += len(nxt[0])
            self._run(pending)

    def _run(self, pending: List[_Item]) -> None:
        try:
            device = pending[0][0].device
            if device.type == "cuda":
                with torch.cuda.device(device):
                    stream = torch.cuda.current_stream(device)
                    for _, ready, _ in pending:
                        stream.wait_event(ready)
                    out = self._call(pending)
            else:
                out = self._call(pending)
            lo = 0
            for items, _, fut in pending:
                hi = lo + len(items)
                fut.set_result(out[lo:hi])
                lo = hi
            self._stats["batches"] += 1
            self._stats["items"] += lo
            self._stats["requests"] += len(pending)
        except Exception as exc:  # noqa: BLE001 — delivered to every waiter
            for _, _, fut in pending:
                if not fut.done():
                    fut.set_exception(exc)

    def _call(self, pending: List[_Item]) -> np.ndarray:
        return self._fn(torch.cat([items for items, _, _ in pending]))
