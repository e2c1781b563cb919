"""``BENCHMARK.json`` keeps to its contract, and its cells, mixes,
configurations, metrics and limits are found by name, a new one taken
up from new files alone."""

import json
import re
import shutil
import pytest

from benchmark import harness
from benchmark.spec import BENCH, ROOT, Bench

from conftest import make_tiny

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    n = 24
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).exists() and c["file"].startswith(
            "benchmark/")
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_each_metric_and_cell():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    bench = Bench()
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e and len(e) >= 2 and cell.per_layer
        report = cell.traffic["report"]
        assert e == {"setup_s", report["tail"], report["rate"]}
        for m in cell.per_layer:
            # a per-layer metric moves an end-to-end metric of its cell
            assert m["moves"] in e
            assert hasattr(bench.reader(m["name"]), "read")
        for name, lim in bench.limits(w["name"]).items():
            assert lim["limit"] >= 0, name
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(1 <= len(x) <= 200 for x in layers)


def test_a_cell_added_as_files_only_is_taken_up(tmp_path):
    """A new configuration, traffic mix, per-layer metric and limits,
    each a new file in a directory of its own, and a new cell naming
    them: found by name, no existing file touched."""
    extra = tmp_path / "extra"
    for d in ("configs", "traffic", "metrics", "limits"):
        (extra / d).mkdir(parents=True)
    cfg = json.loads((BENCH / "configs" / "clip-vit-b32.json").read_text())
    cfg["text_depth"] = 6
    (extra / "configs" / "clip-half.json").write_text(json.dumps(cfg))
    t = json.loads((BENCH / "traffic" / "library.int8_4m.json").read_text())
    t["clients"] = 8
    (extra / "traffic" / "library.int8_4m.c8.json").write_text(json.dumps(t))
    (extra / "metrics" / "searches_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.records))\n")
    shutil.copy(BENCH / "limits" / "clip.library.int8_4m.json",
                extra / "limits" / "clip.library.int8_4m.c8.json")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "clip-half", "source": "x",
                            "file": str(extra / "configs" /
                                        "clip-half.json"),
                            "reduced": ["text_depth"], "why": "t"})
    spec["workloads"].append({"name": "clip.library.int8_4m.c8",
                              "config": "clip-half",
                              "traffic": "library.int8_4m.c8",
                              "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "searches_seen", "unit": "searches",
                              "better": "higher", "source": "host_clock",
                              "layer": "library service",
                              "moves": "searches_per_s",
                              "workloads": ["clip.library.int8_4m.c8"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "clip.library.bf16_4m" in m["workloads"]:
            m["workloads"].append("clip.library.int8_4m.c8")
    root = tmp_path / "root"
    root.mkdir()
    (root / "benchmark").symlink_to(BENCH)      # the files already there
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root, [BENCH, extra])
    cell = bench.cell("clip.library.int8_4m.c8")
    assert cell.config["text_depth"] == 6
    assert cell.traffic["clients"] == 8
    assert "searches_seen" in [m["name"] for m in cell.per_layer]
    assert "searches_per_s" in [m["name"] for m in cell.end_to_end]
    assert bench.reader("searches_seen").read(
        harness.Context(cell, harness.Window(0, 1, [1, 2]), [], 0, 1)) == 2
    assert bench.limits("clip.library.int8_4m.c8")
    # the existing cells are as they were
    assert Bench(root, [BENCH, extra]).cell("clip.library.bf16_4m").traffic \
        == Bench().cell("clip.library.bf16_4m").traffic


def test_the_tiny_copy_keeps_the_cells(tmp_path):
    bench = make_tiny(tmp_path)
    assert "clip.library.int8_4m" not in [w["name"] for w in
                                          SPEC["workloads"]]
    assert bench.cell("clip.library.int8_4m").traffic["settings"] == {
        "LIBRARY_INDEX_DTYPE": "int8"}
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        assert cell.traffic["entry"] == Bench().cell(w["name"]).traffic[
            "entry"]


def test_unknown_names_are_refused():
    bench = Bench()
    with pytest.raises(KeyError):
        bench.cell("no.such.cell")
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric")
