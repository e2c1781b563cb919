"""What the harness and the references load: no JAX and no JAX package
(top-level module names compared whole: the port's own name begins with
the JAX package's), and the references nothing of the port."""

import json
import subprocess
import sys

from benchmark.spec import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "avede_tpu"}

_PROBE = """
import json, sys, importlib, importlib.util, pathlib
for name in {mods!r}:
    importlib.import_module(name)
for path in {files!r}:
    spec = importlib.util.spec_from_file_location(
        "probe_" + pathlib.Path(path).stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(mods, files=()):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(mods=list(mods),
                                             files=[str(f) for f in files])],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0", "USE_JAX": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_references_load_neither_jax_nor_the_port():
    refs = [f"benchmark.reference.{p.stem}"
            for p in (BENCH / "reference").glob("*.py")
            if p.stem != "__init__"]
    top = _loaded(refs)
    assert not top & FORBIDDEN
    assert "avede_tpu_torch" not in top


def test_the_harness_entries_and_readers_load_no_jax():
    mods = ["benchmark.run", "benchmark.harness", "benchmark.control",
            "avede_tpu_torch.services.captioner",
            "avede_tpu_torch.services.library_search",
            "avede_tpu_torch.parallel.embed"]
    files = (list((BENCH / "entries").glob("*.py"))
             + list((BENCH / "metrics").glob("*.py")))
    top = _loaded(mods, files)
    assert not top & FORBIDDEN
    assert "avede_tpu_torch" in top          # the name is told apart whole
