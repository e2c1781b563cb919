"""On the card: a short run of each cell through the command, its last
line kept to the result's contract. Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.spec import ROOT, Bench


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Bench().spec["workloads"]])
def test_a_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell,
         "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert set(r["metrics"]) == {m["name"] for m in
                                 Bench().cell(cell).end_to_end}
