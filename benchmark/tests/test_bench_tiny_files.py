"""A third configuration and a new entry join the benchmark as files
only: each a new file in a directory of its own, with entries appended
to a copy of ``BENCHMARK.json``. The tiny copy takes them up, cuts
included, and runs the new cell, with no file of the benchmark edited."""

import json

import pytest

from benchmark import harness
from benchmark.spec import BENCH, ROOT

from conftest import make_tiny

CELL = "clipb16.text.fresh"

# a new entry: fresh texts through ClipEngine.embed_texts, judged
# against the plain text tower
ENTRY = '''
import dataclasses

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import clip_text
from benchmark.reference.tokens import ClipBPE


class Entry:
    def __init__(self, config, traffic, seed, device, bench, program=True):
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.words = bench.data(traffic["vocabulary"]).read_text().split()
        self.engine = None
        if program:
            from avede_tpu_torch.models.clip import CLIPConfig
            from avede_tpu_torch.parallel.embed import ClipEngine

            names = {f.name for f in dataclasses.fields(CLIPConfig)}
            self.engine = ClipEngine(
                cfg=CLIPConfig(**{k: v for k, v in config.items()
                                  if k in names}),
                state_dict=self._weights(), device=self.device)

    def _weights(self):
        return weights.make(clip_text.param_spec(self.cfg), self.seed,
                            self.device, getattr(torch, self.cfg["dtype"]))

    def request(self, i):
        rng = np.random.default_rng([abs(self.seed), 2, i])
        return " ".join(self.words[j] for j in rng.integers(
            len(self.words), size=int(self.traffic["words"])))

    def units(self, req):
        return 1

    def size(self, req):
        return len(req)

    def serve(self, req, spans):
        return self.engine.embed_texts([req])[0]

    def warmup(self):
        self.serve(self.request(1 << 41), [])

    def free(self):
        self.engine = None

    def _reference(self, reqs, lowp=None):
        ids = ClipBPE()(reqs, int(self.cfg["max_text_len"]))
        model = clip_text.ClipText(self._weights(), self.cfg, lowp)
        with torch.no_grad():
            return model.encode(torch.from_numpy(ids)).numpy()

    def control_outputs(self, reqs):
        return list(self._reference(reqs, "fp8"))

    def check(self, records):
        want = self._reference([r.request for r in records])
        got = np.stack([r.output for r in records])
        return {"emb_err": float(np.abs(got - want).max())}
'''


def _extra(tmp_path):
    """The new files, in a directory of their own, and a root whose
    ``BENCHMARK.json`` is the real one with the new entries appended."""
    extra = tmp_path / "extra"
    for d in ("configs", "traffic", "entries", "metrics", "limits", "tiny"):
        (extra / d).mkdir(parents=True)
    cfg = json.loads((BENCH / "configs" / "clip-vit-b32.json").read_text())
    cfg["patch_size"] = 16
    (extra / "configs" / "clip-vit-b16.json").write_text(json.dumps(cfg))
    (extra / "traffic" / "text.fresh.json").write_text(json.dumps({
        "entry": "clip_text_embed", "clients": 1, "words": 12,
        "vocabulary": "words.txt", "check_requests": 4,
        "report": {"tail": "text_p95_ms", "rate": "texts_per_s"}}))
    (extra / "entries" / "clip_text_embed.py").write_text(ENTRY)
    (extra / "metrics" / "texts_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records))\n")
    (extra / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"emb_err": {"limit": 1e-4, "lower": None, "upper": None,
                     "why": "a test's"}}))
    tiny = json.loads((BENCH / "tiny" / "clip-vit-b32.json").read_text())
    (extra / "tiny" / "clip-vit-b16.json").write_text(json.dumps(tiny))
    (extra / "tiny" / "entry.clip_text_embed.json").write_text(
        json.dumps({"words": 6, "check_requests": 3}))
    (extra / "tiny" / "text.fresh.json").write_text(
        json.dumps({"check_requests": 2}))       # the mix's own cut
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "clip-vit-b16", "source": "x",
                            "file": str(extra / "configs" /
                                        "clip-vit-b16.json"),
                            "reduced": [], "why": "t"})
    spec["workloads"].append({"name": CELL, "config": "clip-vit-b16",
                              "traffic": "text.fresh", "chips": 1,
                              "why": "t"})
    spec["end_to_end"] += [
        {"name": "text_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": [CELL]},
        {"name": "texts_per_s", "unit": "texts/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": [CELL]}]
    spec["per_layer"].append({"name": "texts_seen", "unit": "texts",
                              "better": "higher", "source": "host_clock",
                              "layer": "text", "moves": "texts_per_s",
                              "workloads": [CELL]})
    root = tmp_path / "root"
    root.mkdir()
    (root / "benchmark").symlink_to(BENCH)      # the files already there
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, extra


def test_a_new_configuration_and_entry_run_from_files_alone(
        tmp_path, tiny):
    root, extra = _extra(tmp_path)
    bench = make_tiny(tmp_path / "cut", root, [BENCH, extra])
    cell = bench.cell(CELL)
    assert cell.config["patch_size"] == 8            # its tiny cut
    assert cell.config["vision_dim"] == 64
    assert cell.traffic["words"] == 6 and cell.traffic["check_requests"] \
        == 2                                          # entry's, then mix's
    r = harness.run_cell(bench, CELL, 2 ** 31 + 99, 0.2, False, "cpu", 0.0)
    assert r["correct"] and r["attempted"] > 0, r["checks"]
    assert set(r["metrics"]) == {"setup_s", "text_p95_ms", "texts_per_s"}
    # the cells that were there keep their cuts
    assert bench.cell("blip2.rerank.cold30").config["vision_dim"] == 64
    assert bench.cell("clip.library.bf16_4m").traffic["videos"] == 8


@pytest.mark.parametrize("missing", ["clip-vit-b16.json",
                                     "entry.clip_text_embed.json"])
def test_a_missing_cut_names_the_file_to_add(tmp_path, missing):
    root, extra = _extra(tmp_path)
    (extra / "tiny" / missing).unlink()
    with pytest.raises(FileNotFoundError, match=f"tiny/{missing}"):
        make_tiny(tmp_path / "cut", root, [BENCH, extra])
