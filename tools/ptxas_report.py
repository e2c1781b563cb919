#!/usr/bin/env python3
"""Registers, stack frame and spills of every kernel the port compiles.

    python3 tools/ptxas_report.py [flash_attention patch_embed ...]

Compiles each named ``avede_tpu_torch/csrc/<name>.cu`` (default: all of
them, all at once) with the port's own ``nvcc`` command plus ``-Xptxas
-v`` into a temporary object, and prints one JSON object a line per
kernel instantiation: its source, its demangled name (by ``c++filt``
where the toolkit's host has it), registers, stack frame bytes, spill
stores and loads, and shared memory bytes. Needs ``nvcc``: run it on the
machine with the card.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from avede_tpu_torch.ops import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\w+)'")
STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def demangle(names):
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def parse(source: str, log: str):
    kernels, cur = [], None
    for line in log.splitlines():
        if (m := ENTRY.search(line)):
            cur = {"source": source, "kernel": m.group(1)}
            kernels.append(cur)
        elif cur is not None and (m := STACK.search(line)):
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := USED.search(line)):
            cur.update(registers=int(m.group(1)),
                       smem_bytes=int(m.group(2) or 0))
    for k, name in zip(kernels, demangle([k["kernel"] for k in kernels])):
        k["kernel"] = name
    return kernels


def main(argv) -> int:
    names = argv or _build.sources()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in names:
            cmd = _build._command(name, Path(tmp) / f"{name}.o")
            cmd = [c for c in cmd if c not in ("-shared", "-Xcompiler",
                                               "-fPIC")]
            procs[name] = subprocess.Popen(
                cmd[:1] + ["-c", "-Xptxas", "-v"] + cmd[1:],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        failed = 0
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(log, file=sys.stderr)
                failed += 1
                continue
            for k in parse(f"avede_tpu_torch/csrc/{name}.cu", log):
                print(json.dumps(k), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
