"""``correct`` comes out false when the timed path is broken underneath
or the control stands in for the program: a whole run at tiny sizes on
the CPU (the chip's look skipped), judged by the committed limits.

Faults planted in the program: an answer altered where it is produced,
and half of the batch left out (half the candidates' image side, half
the library's videos). The control: the reference one step below the
configuration's precision, in the program's place.
"""

import numpy as np
import pytest

from benchmark import harness
from benchmark.spec import Bench

from conftest import KEPT

SEED = 2 ** 31 + 777
CELLS = [w["name"] for w in Bench().spec["workloads"]] + [KEPT["name"]]


def _run(bench, cell, factory=None):
    return harness.run_cell(bench, cell, SEED, 0.3, False, "cpu", 0.0,
                            entry_factory=factory)


def test_sound_runs_pass(tiny):
    for cell in ("blip2.rerank.cold30", "clip.library.int8_4m"):
        assert _run(tiny, cell)["correct"]


def test_rerank_scores_altered(tiny, monkeypatch):
    from avede_tpu_torch.services.captioner import Blip2RerankService

    real = Blip2RerankService.scores_from_repr

    def altered(self, reprs, query):
        scores, meta = real(self, reprs, query)
        return scores[::-1].copy(), meta      # each score on another frame

    monkeypatch.setattr(Blip2RerankService, "scores_from_repr", altered)
    assert not _run(tiny, "blip2.rerank.cold30")["correct"]


def test_rerank_half_the_candidates_left_out(tiny, monkeypatch):
    from avede_tpu_torch.services.captioner import Blip2RerankService

    real = Blip2RerankService.frame_repr

    def half(self, frames):
        h = (len(frames) + 1) // 2
        reprs = real(self, frames[:h])
        return (reprs + reprs)[:len(frames)]

    monkeypatch.setattr(Blip2RerankService, "frame_repr", half)
    assert not _run(tiny, "blip2.rerank.cold30")["correct"]


@pytest.mark.parametrize("cell", ["clip.library.bf16_4m",
                                  "clip.library.int8_4m"])
def test_search_result_altered(tiny, monkeypatch, cell):
    from avede_tpu_torch.services.library_index import DeviceLibraryIndex

    real = DeviceLibraryIndex.search

    def altered(self, q, k):
        out = real(self, q, k)
        if out:                 # the best hit moved to its next frame
            f = (out[0]["frame_index"] + 1) % 512
            out[0] = dict(out[0], frame_index=f, timestamp=float(f))
        return out

    monkeypatch.setattr(DeviceLibraryIndex, "search", altered)
    assert not _run(tiny, cell)["correct"]


@pytest.mark.parametrize("cell", ["clip.library.bf16_4m",
                                  "clip.library.int8_4m"])
def test_search_half_the_library_left_out(tiny, monkeypatch, cell):
    from avede_tpu_torch.services.library_index import DeviceLibraryIndex

    real = DeviceLibraryIndex.search

    def half(self, q, k):
        return [c for c in real(self, q, k)
                if int(c["video_id"][1:]) % 2 == 0]

    monkeypatch.setattr(DeviceLibraryIndex, "search", half)
    assert not _run(tiny, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_fails(tiny, cell):
    entry_cls = tiny.entry(tiny.cell(cell).traffic["entry"]).Entry

    class Control(entry_cls):
        def __init__(self, *a):
            super().__init__(*a, program=False)

        def serve(self, req, spans):
            return self.control_outputs([req])[0]

        def warmup(self):
            pass

    r = _run(tiny, cell, Control)
    assert r["failed"] == 0 and not r["correct"], r["checks"]
    assert np.isfinite([c["value"] for c in r["checks"].values()]).all()
