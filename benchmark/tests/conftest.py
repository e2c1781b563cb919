"""A tiny copy of the benchmark for CPU tests: the real metrics, entries,
references and limits, with the cells' configurations and traffic cut to
sizes a CPU runs in seconds (the widths of the port's tiny test models,
the real vocabularies) by the files under ``benchmark/tiny/``."""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.spec import Bench  # noqa: E402

# a mix whose traffic and limits files are kept to be added as a
# cell (PERF.md §7); its entry and reference still run here
KEPT = {"name": "clip.library.int8_4m", "config": "clip-vit-b32",
        "traffic": "library.int8_4m", "chips": 1, "why": "kept"}


def _cut(bench: Bench, name: str) -> Dict:
    return json.loads(bench.find("tiny", name, ".json").read_text())


def make_tiny(tmp: Path, root: Path = ROOT,
              dirs: Optional[Sequence[Path]] = None) -> Bench:
    """A benchmark root at ``tmp`` whose cells are those of ``root``'s
    ``BENCHMARK.json`` and the kept int8 library mix, cut by files found
    by name in ``dirs`` (the benchmark's own by default), as every other
    named file is: a configuration by ``tiny/<config>.json``, a traffic
    mix by its entry's ``tiny/entry.<entry>.json`` and then, where there
    is one, its own ``tiny/<traffic>.json``. A configuration or entry
    with no cut raises ``FileNotFoundError`` naming the file to add."""
    src = Bench(root, dirs)
    for d in ("configs", "traffic"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    spec = json.loads(json.dumps(src.spec))
    if KEPT["name"] not in [w["name"] for w in spec["workloads"]]:
        spec["workloads"].append(KEPT)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "clip.library.bf16_4m" in m.get("workloads", []):
                m["workloads"].append(KEPT["name"])
    for c in spec["configs"]:
        cfg = json.loads((root / c["file"]).read_text())
        cfg.update(_cut(src, c["name"]))
        c["file"] = f"configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads(src.find("traffic", w["traffic"], ".json")
                       .read_text())
        t.update(_cut(src, f"entry.{t['entry']}"))
        try:
            t.update(_cut(src, w["traffic"]))
        except FileNotFoundError:
            pass                      # the entry's cut is the mix's
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp, [tmp, *src.dirs])


@pytest.fixture
def tiny(tmp_path, monkeypatch) -> Bench:
    from avede_tpu_torch.utils.config import settings

    for f in dataclasses.fields(settings):    # what a mix's entry sets
        monkeypatch.setattr(settings, f.name, getattr(settings, f.name))
    settings.VIDEO_DIR = str(tmp_path / "videos")
    return make_tiny(tmp_path / "bench")
