#!/usr/bin/env python3
"""Adds to the port's ``DeviceLibraryIndex`` on the card: add p50 and the
device operations of one add.

    python3 tools/index_add_ops.py [--root DIR] [--dtype int8] [--videos N]

Imports ``avede_tpu_torch`` from ``--root`` (default: this checkout; give
an unpacked older commit to compare two trees in one call), adds ``N``
seeded videos of 1000 unit rows of 512 (each span padded to 1024 rows,
as ``chip_smoke.py`` phase 7 does), times each add to its
``torch.cuda.synchronize()``, then adds one more under ``torch.profiler``
and lists the copies and kernels it ran on the device, in order. Prints
one JSON line. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dtype", default="int8")
    ap.add_argument("--videos", type=int, default=1000)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avede_tpu_torch.services.library_index import DeviceLibraryIndex

    if not torch.cuda.is_available():
        print("index_add_ops: no card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dim, rows_per = 512, 1000
    ts = [i / 30.0 for i in range(rows_per)]

    def rows(seed):
        x = np.random.default_rng(seed).normal(size=(rows_per, dim))
        x = x.astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    index = DeviceLibraryIndex(dim, dtype=args.dtype, device="cuda")
    add_ms = []
    for v in range(args.videos):
        x = rows(v)
        t0 = time.perf_counter()
        index.add(f"video-{v:04d}", x, ts)
        torch.cuda.synchronize()
        add_ms.append((time.perf_counter() - t0) * 1e3)
    x = rows(args.videos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        index.add("profiled", x, ts)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == cuda
         and not getattr(e, "is_user_annotation", False)),
        key=lambda e: e.time_range.start)]
    print(json.dumps({"root": str(root), "card": card, "dtype": args.dtype,
                      "videos": args.videos, "capacity": index.capacity,
                      "add_p50_ms": statistics.median(add_ms),
                      "add_ms_quartiles": statistics.quantiles(add_ms, n=4),
                      "device_ops_per_add": len(ops),
                      "device_op_names": ops}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
