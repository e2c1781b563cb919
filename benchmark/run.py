"""Run one benchmark cell on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up builds the program's kernels (into
the checkout's ``build/``, once), makes weights and data on the card from
the seed and warms up the cell's shapes; then the window runs for
``--seconds``; then the run checks what the window's requests got back
against the plain reference. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, last the ``checks``, each
number compared beside its limit); the checks are also the last lines
of standard error. No card, too few cards, or a module of JAX or of the
JAX package loaded: no result and a non-zero exit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from .spec import ROOT, Bench  # noqa: E402

# the program's path settings, pointed into the run's own directory
_PATH_SETTINGS = ("DATA_DIR", "VIDEO_DIR", "CLIP_DIR", "FRAME_DIR",
                  "EMBEDDING_DIR", "IMAGE_DIR", "LOG_DIR")


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def prepare_env(workdir: Path, settings: dict) -> None:
    """Environment for the program, before it is imported: its paths in
    ``workdir``, the traffic's settings, no JAX in libraries that would
    load it, and build caches inside the checkout."""
    for name in _PATH_SETTINGS:
        os.environ[name] = str(workdir / name.lower())
    for name, value in settings.items():
        os.environ[name] = value if isinstance(value, str) \
            else json.dumps(value)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    with tempfile.TemporaryDirectory(prefix="avede-bench-") as tmp:
        prepare_env(Path(tmp), cell.traffic.get("settings", {}))
        import torch

        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        from .harness import run_cell

        result = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START)
    phases = result.pop("setup_phases")
    print("setup " + " ".join(f"{k} {v:.2f}" for k, v in phases.items()),
          file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(_finite(result)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
