"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix. Everything particular to
one of them is a file of its own, looked up by name in the benchmark's
directories (the first that has it wins), so a later change adds a
model, a mix, a metric or a cell's limits by adding files:

- ``configs/<name>.json`` — a configuration (its path is also given in
  ``BENCHMARK.json``);
- ``traffic/<name>.json`` — a traffic mix: its parameters and the entry
  it drives;
- ``entries/<entry>.py`` — the runner of one entry of the program;
- ``metrics/<metric>.py`` — a per-layer metric's reader, ``read(ctx)``;
- ``limits/<cell>.json`` — the limits that decide ``correct``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Sequence

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _for_cell(metrics: Sequence[Dict], cell: str) -> List[Dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


class Bench:
    """The benchmark's definition rooted at ``root`` (the directory of
    ``BENCHMARK.json``), its named files looked up in ``dirs``."""

    def __init__(self, root: Path = ROOT,
                 dirs: Optional[Sequence[Path]] = None) -> None:
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dirs = [Path(d) for d in (dirs or [BENCH])]

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.exists():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} in "
                                f"{[str(d) for d in self.dirs]}")

    def _json(self, kind: str, name: str) -> Dict:
        return json.loads(self.find(kind, name, ".json").read_text())

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self.find(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"benchmark_{kind}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def config(self, name: str) -> Dict:
        entry = next(c for c in self.spec["configs"] if c["name"] == name)
        cfg = json.loads((self.root / entry["file"]).read_text())
        return dict(cfg, name=name)

    def traffic(self, name: str) -> Dict:
        return dict(self._json("traffic", name), name=name)

    def limits(self, cell: str) -> Dict:
        return self._json("limits", cell)

    def entry(self, name: str) -> ModuleType:
        return self._module("entries", name)

    def reader(self, metric: str) -> ModuleType:
        return self._module("metrics", metric)

    def data(self, name: str) -> Path:
        """A traffic mix's data file (a word list, ...)."""
        return self.find("traffic", name, "")

    def cell(self, name: str) -> Cell:
        w = next((w for w in self.spec["workloads"] if w["name"] == name),
                 None)
        if w is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return Cell(name, int(w["chips"]),
                    self.config(w["config"]), self.traffic(w["traffic"]),
                    _for_cell(self.spec["end_to_end"], name),
                    _for_cell(self.spec["per_layer"], name))
