#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises
and the script exits non-zero without printing a result:

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel under ``avede_tpu_torch/csrc/`` (one ``nvcc`` per
   source, all at once) into ``build/kernels/``;
3. hold each kernel against its plain PyTorch version at the shapes of
   the main path, with f32 references (TF32 off) and the tolerance
   ``max |kernel - plain| <= 1e-4 * max |plain| + 1e-5``; time kernel,
   plain version and one library call on the device (CUDA events around
   a CUDA-graph replay, host launch cost excluded), and the kernel's
   eager per-call wall (``call_ms``);
4. check the card's bf16 embeddings against the CPU's f32 plain path
   on the same seeded weights, on a few frames (cosine >= 0.99);
5. drive the main path at CLIP ViT-B/32 width (random weights from a
   seed, bf16): a ``Phase1Scan`` over an in-memory source of 600 seeded
   288×512 BGR frames with a moving object, an ``EmbeddingCache`` in a
   temporary directory, one cold ``process_video``, six warm ones
   (three queries, each twice) and one four-query ``process_queries``;
   every kernel's launch count, zeroed just before, must be above 0;
   scores must be finite and sorted, repeated queries identical, and
   the top windows those of a numpy reference on the cached table.

The line before the last is ``nvidia-smi``'s name and power limit; the
last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores — the kernels compute in f32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TOL_REL, TOL_ABS = 1e-4, 1e-5

N_FRAMES, FRAME_H, FRAME_W, FPS = 600, 288, 512, 30.0
QUERIES = ["a red square moving across the street",
           "an empty road at dusk", "a person walking a dog"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Device ms per call: CUDA events around one replay of a CUDA graph
    that holds ``iters`` calls, so host launch cost is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(torch, fn, iters: int = 50) -> float:
    """Wall ms per eager call in a loop (host launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, ref):
    """(max |got - ref|, tolerance) with -inf entries required equal."""
    got, ref = got.float(), ref.float()
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin) \
            or not torch.equal(got[~fin], ref[~fin]):
        fail("kernel and plain version disagree on non-finite entries")
    err = (got[fin] - ref[fin]).abs().max().item()
    return err, TOL_REL * ref[fin].abs().max().item() + TOL_ABS


class SyntheticVideo:
    """An in-memory decoder: 600 seeded BGR frames of 288×512, a
    textured background with a red square crossing it, served with the
    ``VideoReader`` interface ``Phase1Scan`` uses."""

    sample_rate = 1

    def __init__(self, np, seed: int = 0) -> None:
        self.np = np
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W]
        base = np.stack([60 + 40 * np.sin(xx / 23.0),
                         90 + 50 * np.cos(yy / 17.0),
                         120 + 30 * np.sin((xx + yy) / 41.0)], -1)
        self.background = np.clip(base + rng.normal(0, 12, base.shape),
                                  0, 255).astype(np.uint8)
        self.seed = seed

    def expected_sample_count(self, path: str) -> int:
        return N_FRAMES

    def _chunk(self, lo: int, hi: int):
        np = self.np
        rng = np.random.default_rng((self.seed, lo))
        frames = np.repeat(self.background[None], hi - lo, axis=0)
        noise = rng.integers(-6, 7, frames.shape, dtype=np.int16)
        frames = np.clip(frames + noise, 0, 255).astype(np.uint8)
        for i in range(lo, hi):
            x = int(i / (N_FRAMES - 1) * (FRAME_W - 64))
            frames[i - lo, 100:164, x:x + 64] = (30, 30, 220)   # BGR red
        return frames

    def stream_frames(self, path: str, chunk: int = 256, finish=None,
                      **_):
        for lo in range(0, N_FRAMES, chunk):
            hi = min(lo + chunk, N_FRAMES)
            frames = self._chunk(lo, hi)
            ts = [i / FPS for i in range(lo, hi)]
            yield (finish(frames, ts) if finish is not None else frames), ts


def check_kernels(torch, np, video):
    """Phase 3: each kernel against its plain version at main-path
    shapes, with times of kernel, plain version and library call."""
    import torch.nn.functional as F

    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.ops.preprocess import (clip_preprocess_i420,
                                                pack_frames_i420)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    # 1. fused patch embed: the 128-frame bucket of the sparse cold scan,
    # f32 0..255 frames from the I420 unpack of real packed frames
    n, s, p, d = 128, 224, 32, 768
    packed = pack_frames_i420(video._chunk(0, n), s, src="bgr")
    frames = (clip_preprocess_i420(torch.from_numpy(packed).to(dev),
                                   normalize=False) * 255.0).contiguous()
    kernel = torch.randn(p, p, 3, d, device=dev, generator=gen) \
        * (3 * p * p) ** -0.5
    w2, b2 = kernels.fold_for_uint8(kernel)
    w2, b2 = w2.contiguous(), b2.contiguous()
    got = kernels.fused_patch_embed(frames, w2, b2, p)
    ref = kernels.fused_patch_embed_plain(frames, w2, b2, p)
    err, tol = max_err(torch, got, ref)
    u8 = frames.round().clamp(0, 255).to(torch.uint8)
    err_u8, tol_u8 = max_err(torch, kernels.fused_patch_embed(u8, w2, b2, p),
                             kernels.fused_patch_embed_plain(u8, w2, b2, p))
    w_oihw = w2.reshape(p, p, 3, d).permute(3, 2, 0, 1).contiguous()
    x_nchw = frames.permute(0, 3, 1, 2)
    gg, k = (s // p) ** 2, p * p * 3
    b, f = bound_ms(4 * (frames.numel() + w2.numel() + b2.numel()
                         + n * gg * d), 2.0 * n * gg * k * d)
    rows.append(dict(
        name="fused_patch_embed", route="cuda",
        source="avede_tpu_torch/csrc/patch_embed.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:95",
        shape=f"frames f32 [{n},{s},{s},3] x W' [{k},{d}]",
        max_abs_err=err, tol=tol, u8_max_abs_err=err_u8,
        ms=time_ms(torch, lambda: kernels.fused_patch_embed(
            frames, w2, b2, p)),
        call_ms=call_ms(torch, lambda: kernels.fused_patch_embed(
            frames, w2, b2, p)),
        plain_ms=time_ms(torch, lambda: kernels.fused_patch_embed_plain(
            frames, w2, b2, p)),
        bound_ms=b, bound_by=f,
        library_ms=time_ms(torch, lambda: F.conv2d(
            x_nchw, w_oihw, b2, stride=p)),
        library="torch.nn.functional.conv2d (cuDNN, TF32 off)"))
    if err > tol or err_u8 > tol_u8:
        fail(f"fused_patch_embed: max err {err} (u8 {err_u8}) > {tol}")

    # 2. flash attention: one vision layer of the 128-frame bucket
    bsz, h, length, hd = 128, 12, 50, 64
    q, kk, v = (torch.randn(bsz, h, length, hd, device=dev, generator=gen)
                for _ in range(3))
    got = attention.flash_attention(q, kk, v)
    ref = attention.attention_reference(q, kk, v)
    err, tol = max_err(torch, got, ref)
    b, f = bound_ms(4 * 4 * q.numel(), 4.0 * bsz * h * length * length * hd)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="avede_tpu_torch/csrc/flash_attention.cu",
        replaces="avede_tpu/ops/attention.py:85",
        shape=f"q,k,v f32 [{bsz},{h},{length},{hd}]",
        max_abs_err=err, tol=tol,
        ms=time_ms(torch, lambda: attention.flash_attention(q, kk, v)),
        call_ms=call_ms(torch, lambda: attention.flash_attention(q, kk, v)),
        plain_ms=time_ms(torch, lambda: attention.attention_reference(
            q, kk, v)),
        bound_ms=b, bound_by=f,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kk, v)),
        library="torch.nn.functional.scaled_dot_product_attention"))
    if err > tol:
        fail(f"flash_attention: max err {err} > {tol}")

    # 3. cosine scores: the 1024-row bucket of a 600-frame table
    nb, dim, n_valid = 1024, 512, N_FRAMES
    emb = F.normalize(torch.randn(nb, dim, device=dev, generator=gen), dim=1)
    qv = F.normalize(torch.randn(dim, device=dev, generator=gen), dim=0)
    valid = torch.arange(nb, device=dev) < n_valid
    got = kernels.cosine_scores(emb, qv, valid)
    ref = kernels.cosine_scores_plain(emb, qv[None], valid)[:, 0]
    err, tol = max_err(torch, got, ref)
    b, f = bound_ms(4 * (emb.numel() + dim + nb) + nb, 2.0 * nb * dim)
    rows.append(dict(
        name="cosine_scores", route="cuda",
        source="avede_tpu_torch/csrc/cosine_scores.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:139",
        shape=f"table f32 [{nb},{dim}] x query [{dim}], valid mask",
        max_abs_err=err, tol=tol,
        ms=time_ms(torch, lambda: kernels.cosine_scores(emb, qv, valid),
                   iters=200),
        call_ms=call_ms(torch, lambda: kernels.cosine_scores(
            emb, qv, valid), iters=200),
        plain_ms=time_ms(torch, lambda: kernels.cosine_scores_plain(
            emb, qv[None], valid), iters=200),
        bound_ms=b, bound_by=f,
        library_ms=time_ms(torch, lambda: torch.mv(emb, qv), iters=200),
        library="torch.mv (no mask)"))
    if err > tol:
        fail(f"cosine_scores: max err {err} > {tol}")
    return rows


def check_against_cpu(torch, np, engine, video):
    """Phase 4: bf16 card embeddings vs the CPU f32 plain path on the
    same seeded weights."""
    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.parallel.embed import ClipEngine

    cpu = ClipEngine(cfg=vit_b32(), device="cpu", seed=0)
    frames = video._chunk(0, 300)[::75]                   # 4 frames
    a = engine.embed_frames(frames)
    b = cpu.embed_frames(frames)
    ta, tb = engine.embed_texts(QUERIES), cpu.embed_texts(QUERIES)

    def cos(x, y):
        return (x * y).sum(1) / (np.linalg.norm(x, axis=1)
                                 * np.linalg.norm(y, axis=1))

    img_cos, txt_cos = float(cos(a, b).min()), float(cos(ta, tb).min())
    if not (img_cos >= 0.99 and txt_cos >= 0.99):
        fail(f"card vs CPU cosine: image {img_cos}, text {txt_cos}")
    return {"image_min_cosine": img_cos, "text_min_cosine": txt_cos,
            "frames": len(frames)}


def drive_main_path(torch, np, engine, video, cache_dir):
    """Phase 5: cold scan, warm queries and a multi-query through
    ``Phase1Scan`` at ViT-B/32 width."""
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.ops.windows import window_middle_indices
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.utils.config import settings

    counted = (kernels.fused_patch_embed, attention.flash_attention,
               kernels.cosine_scores)
    scan = Phase1Scan(engine, reader=video,
                      cache=EmbeddingCache(str(cache_dir)))
    path, vid, top_k = "memory://synthetic-street", "synthetic-street", 10

    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    cold = scan.process_video(path, QUERIES[0], top_k=top_k,
                              threshold=-1.0, video_id=vid)
    cold_s = time.perf_counter() - t0
    warm, warm_ms = [], []
    for q in QUERIES + QUERIES:
        t0 = time.perf_counter()
        warm.append(scan.process_video(path, q, top_k=top_k,
                                       threshold=-1.0, video_id=vid))
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    multi = scan.process_queries(path, QUERIES + ["a bright light"],
                                 top_k=5, threshold=-1.0, video_id=vid)
    multi_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches for fn in counted}

    if any(v <= 0 for v in launches.values()):
        fail(f"a kernel of the main path never launched: {launches}")
    for res in [cold] + warm + list(multi.values()):
        conf = [r["confidence"] for r in res]
        if not res or not np.all(np.isfinite(conf)) \
                or conf != sorted(conf, reverse=True):
            fail(f"scores not finite and sorted: {conf}")
    nq = len(QUERIES)
    for i in range(nq):
        if warm[i] != warm[i + nq]:
            fail(f"repeated query {QUERIES[i]!r} gave different results")
    if warm[0] != cold:
        fail("warm result differs from the cold one for the same query")
    # the top windows against a numpy reference on the cached table
    emb, _ = scan.frame_embeddings(path, vid, rows="scan")
    mids = window_middle_indices(len(emb), settings.WINDOW_SIZE,
                                 settings.WINDOW_STRIDE)
    qemb = engine.embed_texts(QUERIES)
    for i in range(nq):
        ref = emb[mids] @ qemb[i]
        order = np.argsort(-ref, kind="stable")[:top_k]
        got = [r["window_index"] for r in warm[i]]
        gap = np.min(np.abs(np.diff(np.sort(ref[order]))))
        if gap > 1e-4 and got != order.tolist():
            fail(f"top windows {got} != numpy reference {order.tolist()}")
        worst = max(abs(r["confidence"] - float(ref[r["window_index"]]))
                    for r in warm[i])
        if worst > 1e-4:
            fail(f"confidence off the numpy reference by {worst}")
    return {
        "cold_scan_s": cold_s,
        "warm_p50_ms": statistics.median(warm_ms),
        "warm_ms": warm_ms,
        "multi_query_ms": multi_ms,
        "windows": int(len(mids)),
        "launches": launches,
        "top_window": cold[0]["window_index"],
    }


def main() -> None:
    if not (ROOT / "avede_tpu_torch" / "__init__.py").exists():
        fail("avede_tpu_torch/ not found beside chip_smoke.py; run from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import numpy as np

    card = card_line()
    print(card, flush=True)

    from avede_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "kernels": sorted(built)}), flush=True)

    video = SyntheticVideo(np, seed=0)
    rows = check_kernels(torch, np, video)

    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.utils.config import settings

    with tempfile.TemporaryDirectory() as tmp:
        for attr in ("DATA_DIR", "VIDEO_DIR", "CLIP_DIR", "FRAME_DIR",
                     "EMBEDDING_DIR", "IMAGE_DIR", "LOG_DIR"):
            setattr(settings, attr, str(Path(tmp) / attr.lower()))
        engine = ClipEngine(device="cuda", seed=0)   # ViT-B/32, bf16
        reference = check_against_cpu(torch, np, engine, video)
        main_path = drive_main_path(torch, np, engine, video,
                                    Path(tmp) / "embeddings")

    for row in rows:
        row["launches"] = main_path["launches"][row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"card": card, "reference": reference,
                      "main_path": main_path}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
