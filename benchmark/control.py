"""Readings that the limits deciding ``correct`` are set from, on the
card at a cell's own sizes (not run by the benchmark's own runs).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \
        [--side control|program] [--tier <index tier>]

For each seed: the cell's data and weights from that seed, the first
``check_requests`` requests of its traffic, served by ``--side``, then
judged by the cell's check against the plain reference, as a run
judges its window's requests. ``control`` (the default) serves them
with the reference one step below the configuration's precision: its
readings have to fail the limits. ``program`` serves them with the
program, once a request: its readings bound the limits from below.
``--tier`` runs a library program on another index tier than the
cell's, still judged by the cell's reference (the program's own lower
precision path). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import tempfile
import time
from pathlib import Path

from . import stats
from .run import prepare_env
from .spec import ROOT, Bench


def readings(bench: Bench, workload: str, seed: int, side: str,
             device: str, tier=None) -> dict:
    import torch

    cell = bench.cell(workload)
    traffic = dict(cell.traffic)
    if tier is not None:
        traffic["settings"] = dict(traffic["settings"],
                                   LIBRARY_INDEX_DTYPE=tier)
    entry = bench.entry(traffic["entry"]).Entry(
        cell.config, traffic, seed, device, bench,
        program=(side == "program"))
    n = int(traffic["check_requests"])
    reqs = [entry.request(i) for i in range(n)]
    t0 = time.perf_counter()
    if side == "program":
        outs = [entry.serve(r, []) for r in reqs]
        entry.free()
    else:
        outs = entry.control_outputs(reqs)
    records = [stats.Record(i, 0, 0.0, 0.0, True, entry.units(r), o, [], r)
               for i, (r, o) in enumerate(zip(reqs, outs))]
    if tier is not None:       # judged as the cell's own tier
        entry.tier = cell.traffic["settings"]["LIBRARY_INDEX_DTYPE"]
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks = entry.check(records)
    return {"workload": workload, "seed": seed, "side": side, "tier": tier,
            "served_s": time.perf_counter() - t0, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("control", "program"),
                    default="control")
    ap.add_argument("--tier", default=None)
    args = ap.parse_args(argv)
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    with tempfile.TemporaryDirectory(prefix="avede-control-") as tmp:
        settings = dict(cell.traffic.get("settings", {}))
        if args.tier:
            settings["LIBRARY_INDEX_DTYPE"] = args.tier
        prepare_env(Path(tmp), settings)
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        for s in args.seeds.split(","):
            print(json.dumps(readings(bench, args.workload, int(s),
                                      args.side, "cuda", args.tier)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
