"""A tiny copy of the benchmark for CPU tests: the real metrics, entries,
references and limits, with the cells' configurations and traffic cut to
sizes a CPU runs in seconds (the widths of the port's tiny test models,
the real vocabularies)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.spec import BENCH, Bench  # noqa: E402

TINY_BLIP2 = dict(image_size=32, patch_size=8, vision_dim=64, vision_depth=2,
                  vision_heads=4, vision_mlp=128, hidden=64, depth=2, heads=4,
                  mlp=128, max_pos=32, num_query_tokens=4, projection_dim=24,
                  dtype="float32")
TINY_CLIP = dict(image_size=32, patch_size=8, vision_dim=64, vision_depth=2,
                 vision_heads=4, text_dim=64, text_depth=2, text_heads=4,
                 max_text_len=16, projection_dim=32, dtype="float32")
TINY_RERANK = dict(candidates=4, frame_height=48, frame_width=64,
                   frame_pool=8, check_requests=3)
TINY_LIBRARY = dict(videos=8, rows_per_video=512, scenes_per_video=4,
                    check_requests=5, clients=2, warmup_requests=2)


# a mix whose traffic and limits files are kept to be added as a
# cell (PERF.md §7); its entry and reference still run here
KEPT = {"name": "clip.library.int8_4m", "config": "clip-vit-b32",
        "traffic": "library.int8_4m", "chips": 1, "why": "kept"}


def make_tiny(tmp: Path) -> Bench:
    """A benchmark root at ``tmp`` whose cells are the real ones and the
    kept int8 library mix, cut."""
    for d in ("configs", "traffic"):
        (tmp / d).mkdir(parents=True, exist_ok=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(KEPT)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "clip.library.bf16_4m" in m.get("workloads", []):
            m["workloads"].append(KEPT["name"])
    cuts = {"blip2-vitg-itc": TINY_BLIP2, "clip-vit-b32": TINY_CLIP}
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(cuts[c["name"]])
        c["file"] = f"configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json"
                        ).read_text())
        t.update(TINY_RERANK if t["entry"] == "blip2_rerank"
                 else TINY_LIBRARY)
        (tmp / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp, [tmp, BENCH])


@pytest.fixture
def tiny(tmp_path, monkeypatch) -> Bench:
    from avede_tpu_torch.utils.config import settings

    for name in ("VIDEO_DIR", "LIBRARY_INDEX_DTYPE", "BLIP_MODEL"):
        monkeypatch.setattr(settings, name, getattr(settings, name))
    settings.VIDEO_DIR = str(tmp_path / "videos")
    return make_tiny(tmp_path / "bench")
