"""The ingest cell at tiny sizes on the CPU: the reference codec gives the
program's bytes, a sound run passes, faults planted in the program read
``correct`` false (the control in its place: ``test_bench_faults.py``),
and a traced run reads every per-layer metric; the readers' arithmetic
on a made-up window."""

import numpy as np
import pytest
import torch

from benchmark import devtrace, harness, roofline, roofline_clip, stats
from benchmark.reference import clip_vision
from benchmark.spec import Bench

CELL = "clip.ingest.720p"
SEED = 2 ** 31 + 4242
CLIP = Bench().config("clip-vit-b32")


def _run(bench, factory=None, trace=False):
    return harness.run_cell(bench, CELL, SEED, 0.3, trace, "cpu", 0.0,
                            entry_factory=factory)


@pytest.mark.parametrize("shape,size", [((3, 720, 1280, 3), 224),
                                        ((4, 48, 64, 3), 32),
                                        ((2, 64, 64, 3), 32),
                                        ((2, 70, 90, 3), 32)])
def test_the_reference_codec_gives_the_programs_bytes(shape, size):
    from avede_tpu_torch.ops.preprocess import (clip_preprocess_i420,
                                                pack_frames_i420)

    frames = np.random.default_rng(size).integers(0, 256, shape, np.uint8)
    want = pack_frames_i420(frames, size)
    got = clip_vision.pack_i420(torch.from_numpy(frames), size)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(clip_vision.unpack_i420(got),
                       clip_preprocess_i420(torch.from_numpy(want)))


def test_a_sound_run_matches_the_reference_closely(tiny):
    r = _run(tiny)
    assert r["correct"] and r["attempted"] > 0, r["checks"]
    assert r["checks"]["emb_err"]["value"] < 1e-5


def _swap_pairs(out):
    out = out.copy()
    out[0:-1:2], out[1::2] = out[1::2].copy(), out[0:-1:2].copy()
    return out


def _half(out):
    h = (len(out) + 1) // 2
    out = out.copy()
    out[h:] = out[:len(out) - h]
    return out


FAULTS = {
    "frames_swapped": ("stream", _swap_pairs),
    "half_of_each_request_left_out": ("stream", _half),
    "last_frame_left_out": ("stream", lambda out: out[:-1]),
    "chunk_left_out": ("chunks", lambda chunks: list(chunks)[:-1]),
    "chroma_zeroed": ("pack", None),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_program_is_caught(tiny, monkeypatch, fault):
    import avede_tpu_torch.parallel.embed as embed

    where, f = FAULTS[fault]
    real_stream, real_pack = (embed.ClipEngine.embed_stream,
                              embed.pack_frames_i420)
    if where == "stream":
        monkeypatch.setattr(embed.ClipEngine, "embed_stream",
                            lambda self, chunks: f(real_stream(self, chunks)))
    elif where == "chunks":
        monkeypatch.setattr(embed.ClipEngine, "embed_stream",
                            lambda self, chunks: real_stream(self, f(chunks)))
    else:
        def grey(frames, size, src="rgb"):
            out = real_pack(frames, size, src)
            out[:, size:] = 128              # U and V planes: no colour
            return out

        monkeypatch.setattr(embed, "pack_frames_i420", grey)
    r = _run(tiny)
    assert not r["correct"], r["checks"]


# kernel and copy names as torch.profiler reports them on an H100
CARD_OPS = ("void (anonymous namespace)::patch_embed_kernel<0, "
            "__nv_bfloat16>(...)",
            "void (anonymous namespace)::flash_bf16_kernel<64, 64>(...)",
            "Memcpy HtoD (Pinned -> Device)", "nvjet_tst_128x160_64x5")


def test_a_traced_run_reads_every_per_layer_metric(tiny, monkeypatch):
    def stop(prof, lo, hi):                  # a made-up device trace
        step = (hi - lo) // 40
        return [(name, lo + (4 * j + i) * step, lo + (4 * j + i) * step
                 + step // 2) for j in range(10)
                for i, name in enumerate(CARD_OPS)]

    monkeypatch.setattr(devtrace, "start", lambda cuda=True: object())
    monkeypatch.setattr(devtrace, "stop", stop)
    r = _run(tiny, trace=True)
    assert r["correct"], r["checks"]
    want = {m["name"] for m in tiny.cell(CELL).per_layer}
    assert len(want) == 5 and set(r["metrics"]) == want
    for name, m in r["metrics"].items():
        assert m["value"] is not None and m["value"] > 0, name
        if m["unit"] == "%":
            assert m["value"] <= 100, name


def test_the_yardstick_against_the_kernel_table():
    # row 1, [128] packed frames: 0.0898 ms by operations at three bf16
    # passes, so one pass (the shapes' work) is a third of it
    assert roofline_clip.patch_embed_bound_s(CLIP, 128) == pytest.approx(
        0.0898e-3 / 3, rel=2e-3)
    # row 2, [128, 50, 12, 64]: 0.0117 ms by bytes
    assert roofline.flash_bound_s(128, 12, 50, 64) == pytest.approx(
        0.0117e-3, rel=5e-3)
    # ViT-B/32: about 8.8 GFLOP a frame (2 operations a multiply-add)
    assert roofline_clip.clip_vision_flops(CLIP, 1) == pytest.approx(
        8.82e9, rel=1e-3)


def test_ingest_readers():
    bench = Bench()
    recs = [stats.Record(i, 0, i * 0.1, i * 0.1 + 0.05, True, 128)
            for i in range(4)]
    pe = roofline_clip.patch_embed_bound_s(CLIP, 128)
    fl = roofline.flash_bound_s(128, 12, 50, 64)
    events = []
    for j in range(4):                          # one launch a request
        t = j * 10 ** 8
        events.append((CARD_OPS[0], t, t + int(pe * 1e9 / 0.25)))
        events += [(CARD_OPS[1], t + 10 ** 7 + k * 10 ** 6,
                    t + 10 ** 7 + k * 10 ** 6 + int(fl * 1e9 / 0.5))
                   for k in range(12)]
        events.append((CARD_OPS[2], t + 5 * 10 ** 7, t + 5 * 10 ** 7
                       + 400_000))
    w = harness.Window(0.0, 1.0, recs)
    ctx = harness.Context(bench.cell(CELL), w, events,
                          devtrace.busy_s(events), 1.0)
    got = {m: bench.reader(m).read(ctx) for m in (
        "patch_embed_roofline", "flash_clip_roofline", "mfu.ingest",
        "idle_share.ingest", "h2d_ms.ingest")}
    assert got["patch_embed_roofline"] == pytest.approx(25.0, rel=1e-3)
    assert got["flash_clip_roofline"] == pytest.approx(50.0, rel=1e-3)
    assert got["mfu.ingest"] == pytest.approx(
        100 * roofline_clip.clip_vision_flops(CLIP, 512)
        / roofline.PEAK_BF16_FLOPS)
    assert got["h2d_ms.ingest"] == pytest.approx(0.4)
    assert 0 < got["idle_share.ingest"] < 100
    # nothing of a kind in the trace: its reader says nothing
    bare = harness.Context(bench.cell(CELL), w, [("gemm", 0, 10)],
                           1e-8, 1.0)
    for m in ("patch_embed_roofline", "flash_clip_roofline",
              "h2d_ms.ingest"):
        assert bench.reader(m).read(bare) is None
