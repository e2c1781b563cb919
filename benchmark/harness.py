"""One run of one cell: set-up, warm-up, the measured window, the
metrics, then the check that decides ``correct``.

The window is a closed loop: ``clients`` threads, each sending its next
request when the last one has come back. Request ``i`` is made from
``(seed, i)`` alone, before its send time is taken, so every seed asks
for the same kind of work and the same seed for the same requests.
With ``trace`` the window runs under the device profiler and the run
reports the cell's per-layer metrics; without, its end-to-end metrics.
"""

from __future__ import annotations

import gc
import itertools
import math
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from . import devtrace, stats
from .spec import Bench, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "avede_tpu")
WARM_BASE = 1 << 40          # request indices of the warm-up pass
EPOCH_NS = time.time_ns() - time.perf_counter_ns()


def epoch_ns(t: float) -> int:
    """A ``perf_counter`` time on the profiler's clock (wall ns)."""
    return EPOCH_NS + int(t * 1e9)


@dataclass
class Window:
    t0: float
    t1: float                     # the last request's end
    records: List[stats.Record] = field(default_factory=list)


def drive(entry, clients: int, seconds: Optional[float] = None,
          count: Optional[int] = None, base: int = 0) -> Window:
    """Run the closed loop until ``seconds`` have passed since its start
    (requests sent before then are finished) or ``count`` requests were
    sent."""
    counter = itertools.count()
    records: List[stats.Record] = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds

    def client(c: int) -> None:
        while True:
            n = next(counter)
            if count is not None and n >= count:
                return
            req = entry.request(base + n)
            sent = time.perf_counter()
            if deadline is not None and sent >= deadline:
                return
            spans: List[tuple] = []
            try:
                out, ok, err = entry.serve(req, spans), True, ""
            except Exception as exc:  # noqa: BLE001 — a failed request
                out, ok, err = None, False, repr(exc)
            rec = stats.Record(base + n, c, sent, time.perf_counter(), ok,
                               entry.units(req), out, spans, req, err)
            with lock:
                records.append(rec)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    records.sort(key=lambda r: r.index)
    t1 = max((r.done for r in records), default=t0)
    return Window(t0, t1, records)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: Cell
    window: Window
    events: List[devtrace.Event]
    busy_s: float
    window_s: float

    @property
    def records(self) -> List[stats.Record]:
        return self.window.records


def sample_checked(records: List[stats.Record], n: int, seed: int,
                   size) -> List[stats.Record]:
    """``n`` finished requests drawn from the seed, the largest by
    ``size`` always among them."""
    ok = [r for r in records if r.ok]
    if not ok:
        return []
    largest = max(ok, key=lambda r: (size(r.request), -r.index))
    rest = [r for r in ok if r is not largest]
    rng = np.random.default_rng([abs(int(seed)), 0x636865636b])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [largest] + [rest[i] for i in sorted(pick)]


def judge(checks: Dict[str, float], limits: Dict[str, Dict]
          ) -> Dict[str, Dict[str, float]]:
    return {name: {"value": float(v),
                   "limit": float(limits.get(name, {}).get("limit", -1))}
            for name, v in checks.items()}


def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             entry_factory=None) -> Dict[str, Any]:
    """One run → the result's fields (see ``run.py``)."""
    import torch

    cell = bench.cell(workload)
    limits = bench.limits(workload)
    make = entry_factory or bench.entry(cell.traffic["entry"]).Entry
    entry = make(cell.config, cell.traffic, seed, device, bench)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    t_entry = time.perf_counter() - t_start
    entry.warmup()
    clients = int(cell.traffic["clients"])
    drive(entry, clients, count=int(cell.traffic.get("warmup_requests",
                                                     2 * clients)),
          base=WARM_BASE)
    sync()
    setup_s = time.perf_counter() - t_start

    prof = devtrace.start(cuda) if trace else None
    window = drive(entry, clients, seconds=seconds)
    sync()
    events: List[devtrace.Event] = []
    if prof is not None:
        events = devtrace.stop(prof, epoch_ns(window.t0),
                               epoch_ns(window.t1))

    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that the port may not use: "
                           f"{found}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    records = window.records
    failed = sum(not r.ok for r in records)
    window_s = window.t1 - window.t0
    result: Dict[str, Any] = {
        "correct": False, "attempted": len(records), "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": int(peak),
                   "power": power_limit() if cuda else "cpu"}}
    report = cell.traffic["report"]
    if not trace:
        values = {"setup_s": setup_s}
        if records:
            values[report["tail"]] = stats.tail_ms(records, 95.0)
            values[report["rate"]] = stats.rate(records, window.t0)
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"{workload} cannot report {m['name']}")
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        busy = devtrace.busy_s(events)
        ctx = Context(cell, window, events, busy, window_s)
        for m in cell.per_layer:
            v = bench.reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = busy
        result["device"]["window_s"] = window_s
        host_spans = [(name, epoch_ns(a), epoch_ns(b))
                      for r in records for name, a, b in r.spans]
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(events),
            "idle_gaps": devtrace.idle_by_host(
                events, epoch_ns(window.t0), epoch_ns(window.t1),
                host_spans)}

    entry.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checked = sample_checked(records, int(cell.traffic["check_requests"]),
                             seed, entry.size)
    checks = judge(entry.check(checked), limits)
    errors = sorted({r.error for r in records if not r.ok})
    result["correct"] = bool(
        failed == 0 and checked and all(
            not math.isnan(c["value"]) and c["limit"] >= 0
            and c["value"] <= c["limit"] for c in checks.values()))
    if errors:
        result["errors"] = errors[:5]
    result["setup_phases"] = dict(getattr(entry, "setup_phases", {}),
                                  warmup=setup_s - t_entry)
    result["checks"] = checks
    return result
