#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's ``mvp`` main path and its library
search on one NVIDIA GPU.

    python3 tools/profile_torch_mvp.py [--out DIR] [--root DIR]
                                       [--windows NAME,...]

Same configuration as ``chip_smoke.py``'s main path and library phase
(CLIP ViT-B/32, random weights from seed 0, bf16; its in-memory
sources of 600 seeded 288×512 frames; default settings, so the
library index is in its default bfloat16 tier). Profiles these windows
with ``torch.profiler`` (CPU + CUDA activities):

- ``cold``: one cold ``Phase1Scan.process_video``;
- ``warm``: six warm ``process_video`` queries (three texts, twice);
- ``library_cold``: the first ``LibrarySearch.search`` over
  ``chip_smoke.py``'s three library videos, one of them scanned sparse
  before (so ingest backfills it) and two taking the dense scan;
- ``library_warm``: three further searches (three texts);
- ``rerank_cold``: one cold ``VideoProcessor.process_query(mode=
  "reranked")`` (fresh caches: the cold scan, then BLIP-base, random
  weights from seed 0, bf16, on 2 × top_k candidates), as in
  ``chip_smoke.py`` phase 8;
- ``rerank_warm``: three warm ``reranked`` calls (captions cached: no
  BLIP);
- ``advanced_warm``: three warm ``advanced`` calls (phase 2 warm plus the
  grounding head over the whole table), after one unprofiled
  ``advanced`` call that captions its extra candidates and backfills
  the table;
- ``detection_hybrid``: one warm ``hybrid``
  ``VideoProcessor.process_unlimited_detection`` call (OWL-ViT B/32 +
  the CLIP grid, 200 frames of ``chip_smoke.py``'s source, as its phase
  9), after one unprofiled call; the row adds the host seconds of its
  stages (frame statistics, the two detectors, crop embeddings, crop
  scores, temporal dedup), timed by wrappers around them;
- ``small_object``: one warm default
  ``VideoProcessor.process_small_object_detection`` call (``clip``
  mode, RPN, adaptive thresholds and background independence, top 20)
  on ``chip_smoke.py``'s phase-10 source (60 frames of 1920×1080, 8
  tiles a frame), after one unprofiled call; the row adds the host
  seconds of its stages (detect, proposals and their saliency, motion,
  edge, suppression and temporal parts, frame statistics, thresholds
  and merge, GrabCut and features) and its ``enhancement_stats``;
- ``image_query``: two rows on ``chip_smoke.py``'s phase-11 source (a
  real 1280×720 mp4 it writes, decoded by the port's reader): a cold
  ``traditional`` ``VideoProcessor.process_image_matching`` call with
  reference A (the embed of every frame, clips cut) and a warm
  ``smart_match`` call with A (after one unprofiled ``smart_match``
  call with C that warms YOLO and the crop path); each row adds the
  host seconds of its stages (decode, pack + embed, pHash, SSIM /
  histograms / ORB, cross-domain features, YOLO, crop embeddings, clip
  cuts);
- ``vision_bucket``: the vision tower alone on one 128-frame bucket of
  packed I420 frames (``ClipEngine._embed_device``), over five buckets,
  reported per bucket as well;
- ``index_search`` (outside the profiler): ``chip_smoke.py``'s phase 7,
  the ``DeviceLibraryIndex`` at serving size (1,000,000 rows) in the
  bfloat16 and int8 tiers, with its search p50 at k = 64 and whatever
  device times that checkout's phase 7 reports.

For each window it prints one JSON line: host wall ms, device busy ms
(union of device kernel and copy intervals) and their count, device
idle share (1 − busy / wall), the wall of the ``phase1.*``,
``phase2.*``, ``phase3.*``, ``owlvit.*`` and ``yolo.*`` spans, and
the top device kernels by total time. It writes a Chrome trace per window
under ``--out``. A last line times the host stages of one dense scan
outside the profiler: frame synthesis, the I420 pack, the dedup
signatures and the embedding of the 600 frames (window
``dense_scan_stages``). ``--windows`` picks some of these windows;
``--root`` profiles the package (and ``chip_smoke.py``) of another
checkout, such as the parent commit unpacked by ``git archive``, so
that two versions are compared in one call. Needs a card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WINDOWS = ("vision_bucket", "cold", "warm", "rerank_cold", "rerank_warm",
           "advanced_warm", "detection_hybrid", "small_object",
           "image_query", "library_cold",
           "library_warm", "dense_scan_stages", "index_search")
SPANS = ("phase1.", "phase2.", "phase3.", "owlvit.", "yolo.")


def _device_work(events, cuda_type) -> list:
    """Kernel and copy events on the device, without the device-side
    ranges that ``record_function`` annotations also leave there."""
    return [e for e in events if e.device_type == cuda_type
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(SPANS)]


def _busy_us(work) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in work)
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy


def _summary(torch, prof, wall_ms: float, name: str) -> dict:
    events = prof.events()
    cuda_type = torch.autograd.DeviceType.CUDA
    work = _device_work(events, cuda_type)
    busy_ms = _busy_us(work) / 1e3
    spans = {}
    for e in events:
        if e.name.startswith(SPANS) and e.device_type != cuda_type:
            spans[e.name] = spans.get(e.name, 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e3
    kernels = {}
    for e in work:
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return {
        "window": name,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_events": len(work),
        "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
        "spans_ms": spans,
        "top_device_ms": [{"name": n[:90], "ms": v[0], "count": v[1]}
                          for n, v in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    ap.add_argument("--root", default=str(ROOT),
                    help="checkout whose package is profiled")
    ap.add_argument("--windows", default=",".join(WINDOWS),
                    help="comma-separated subset of " + ",".join(WINDOWS))
    args = ap.parse_args()
    windows = set(args.windows.split(","))
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("profile_torch_mvp: no CUDA device")
    import chip_smoke
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.ops import _build
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.services.library_search import LibrarySearch
    from avede_tpu_torch.utils.config import settings

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card = chip_smoke.card_line()
    _build.build_all()
    if "index_search" in windows:
        print(json.dumps({"window": "index_search", "card": card, **{
            dtype: chip_smoke.drive_index(torch, np, dtype)
            for dtype in ("bfloat16", "int8")}}), flush=True)
    video = chip_smoke.SyntheticVideo(np, seed=0)
    queries = chip_smoke.QUERIES
    with tempfile.TemporaryDirectory() as tmp:
        for attr in ("DATA_DIR", "VIDEO_DIR", "CLIP_DIR", "FRAME_DIR",
                     "EMBEDDING_DIR", "IMAGE_DIR", "LOG_DIR"):
            setattr(settings, attr, str(Path(tmp) / attr.lower()))
        engine = ClipEngine(device="cuda", seed=0)
        # warm the CUDA libraries and kernels on another video id
        warm_scan = Phase1Scan(engine, reader=video,
                               cache=EmbeddingCache(str(Path(tmp) / "w")))
        warm_scan.process_video("memory://warmup", queries[0],
                                threshold=-1.0, video_id="warmup")
        scan = Phase1Scan(engine, reader=video,
                          cache=EmbeddingCache(str(Path(tmp) / "e")))
        path, vid = "memory://synthetic-street", "synthetic-street"
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if "vision_bucket" in windows:
            _vision_bucket(torch, np, engine, video, acts, card, out)
        for name, calls in (("cold", [queries[0]]),
                            ("warm", queries + queries)):
            if name not in windows:
                continue
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for q in calls:
                    scan.process_video(path, q, threshold=-1.0,
                                       video_id=vid)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            _report(torch, prof, wall_ms, name, card, len(calls), out)
        if windows & {"rerank_cold", "rerank_warm", "advanced_warm"}:
            _rerank_windows(torch, np, engine, video, acts, card, out,
                            Path(tmp) / "rerank", windows)
        if "detection_hybrid" in windows:
            _detection_window(torch, engine, video, acts, card, out)
        if "small_object" in windows:
            _small_object_window(torch, np, engine, acts, card, out)
        if "image_query" in windows:
            _image_query_windows(torch, np, engine, acts, card, out,
                                 Path(tmp))

        # library search, default (bfloat16) tier
        if not windows & {"library_cold", "library_warm",
                          "dense_scan_stages"}:
            return
        videos = Path(tmp) / "library"
        videos.mkdir()
        for v in chip_smoke.LIBRARY_VIDEOS:
            (videos / f"{v}.mp4").touch()
        settings.VIDEO_DIR = str(videos)
        reader = chip_smoke.LibraryReader(np)
        lib_scan = Phase1Scan(engine, reader=reader,
                              cache=EmbeddingCache(str(Path(tmp) / "lib")))
        first = chip_smoke.LIBRARY_VIDEOS[0]
        lib_scan.process_video(str(videos / f"{first}.mp4"), queries[0],
                               threshold=-1.0, video_id=first)
        search = LibrarySearch(lib_scan)
        for name, calls in (("library_cold", queries[:1]),
                            ("library_warm", queries)):
            if name not in windows:
                continue
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                for q in calls:
                    search.search(q, threshold=-1.0)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            _report(torch, prof, wall_ms, name, card, len(calls), out)
        if "dense_scan_stages" in windows:
            print(json.dumps(_dense_stages(torch, np, engine, reader,
                                           card)), flush=True)


def _report(torch, prof, wall_ms, name, card, calls, out, **extra) -> None:
    prof.export_chrome_trace(str(out / f"{name}.json"))
    row = _summary(torch, prof, wall_ms, name)
    row["card"] = card
    row["calls"] = calls
    row.update(extra)
    print(json.dumps(row), flush=True)


def _rerank_windows(torch, np, engine, video, acts, card, out, cache_dir,
                    windows) -> None:
    """The ``reranked`` and ``advanced`` modes through
    ``VideoProcessor.process_query`` on a fresh cache: ``rerank_cold``,
    ``rerank_warm`` and ``advanced_warm`` (after one unprofiled
    ``advanced`` call). Each row adds BLIP's decode steps of the window's
    last caption batch, if any ran."""
    from torch.profiler import profile

    import chip_smoke
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.services import video_processor

    # no cv2 on the card's machine: the in-memory source stands in for
    # the container that validate_video would probe
    video_processor.validate_video = lambda path: None
    proc = video_processor.VideoProcessor(engine=engine)
    proc.phase1 = Phase1Scan(engine, reader=video,
                             cache=EmbeddingCache(str(cache_dir)))
    cap = proc.phase2.captioner
    proc.phase3                                     # build the head

    def run(mode, calls):
        cap.model.decode_steps = 0
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                res = proc.process_query(
                    "memory://rerank-street", chip_smoke.QUERIES[0],
                    mode=mode, threshold=-1.0, extract_clips=False,
                    video_id="rerank-street")
                if res["status"] != "completed":
                    sys.exit(f"profile_torch_mvp: {mode}: {res}")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    for name, mode, calls in (("rerank_cold", "reranked", 1),
                              ("rerank_warm", "reranked", 3),
                              ("advanced_warm", "advanced", 3)):
        if name == "advanced_warm":
            run(mode, 1)                 # captions + backfill, unprofiled
        prof, wall_ms = run(mode, calls)
        if name in windows:
            _report(torch, prof, wall_ms, name, card, calls, out,
                    decode_steps=cap.model.decode_steps)


def _detection_window(torch, engine, video, acts, card, out) -> None:
    """One warm ``hybrid`` detection call under the profiler, with the
    host seconds of its stages."""
    from torch.profiler import profile

    import chip_smoke
    from avede_tpu_torch.services import (adaptive_threshold, detector,
                                          open_vocab_matcher,
                                          universal_detector,
                                          video_processor)

    video_processor.validate_video = lambda path: None
    proc = video_processor.VideoProcessor(engine=engine)
    proc.open_vocab.reader = video
    stages = {}
    undo = [chip_smoke.timed_stage(stages, owner, name, label)
            for owner, name, label in (
                (adaptive_threshold.DetectionContext, "from_frame",
                 "frame_statistics"),
                (universal_detector.UniversalDetector, "_owl_run", "owlvit"),
                (detector.ClipGridDetector, "cell_scores", "clip_grid"),
                (detector.ClipEngine, "embed_images", "crop_embeddings"),
                (open_vocab_matcher.OpenVocabMatcher, "_enhance",
                 "crop_scores"),
                (open_vocab_matcher.hostops, "temporal_dedup",
                 "temporal_dedup"))]

    def call():
        res = proc.process_unlimited_detection(
            "memory://detection-street", chip_smoke.DETECTION_QUERIES,
            matching_precision="comprehensive", top_k=25,
            confidence_threshold=0.1, video_id="detection-street")
        if res["status"] != "completed":
            sys.exit(f"profile_torch_mvp: detection: {res}")

    call()                                       # unprofiled warm-up
    stages.clear()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for u in undo:
        u()
    _report(torch, prof, wall_ms, "detection_hybrid", card, 1, out,
            host_stages_s=stages)


def _small_object_window(torch, np, engine, acts, card, out) -> None:
    """One warm default small-object call under the profiler, with the
    host seconds of its stages."""
    import cv2
    from torch.profiler import profile

    import chip_smoke
    from avede_tpu_torch.services import (adaptive_threshold,
                                          background_independent,
                                          small_object, video_processor)

    video_processor.validate_video = lambda path: None
    proc = video_processor.VideoProcessor(engine=engine)
    so = proc.small_object
    so.reader = chip_smoke.SmallObjectVideo(np)
    stages = {}
    undo = [chip_smoke.timed_stage(stages, owner, name, label)
            for owner, name, label in (
                (so.detector, "detect_unlimited_objects", "detect"),
                (so.proposals, "generate_proposals", "proposals"),
                (so.proposals, "saliency_proposals", "proposals.saliency"),
                (so.proposals, "motion_proposals", "proposals.motion"),
                (so.proposals, "edge_proposals", "proposals.edge"),
                (so.proposals, "_nms", "proposals.nms"),
                (so.proposals, "_temporal_boost", "proposals.temporal"),
                (adaptive_threshold.DetectionContext, "from_frame",
                 "frame_statistics"),
                (so.thresholds, "apply", "thresholds_and_merge"),
                (small_object, "merge_detections", "thresholds_and_merge"),
                (background_independent.BackgroundIndependentService,
                 "extract_features", "grabcut_and_features"))]

    def call():
        cv2.setRNGSeed(0)
        res = proc.process_small_object_detection(
            "memory://small-objects", chip_smoke.SMALL_QUERIES,
            video_id="small-objects")
        if res["status"] != "completed":
            sys.exit(f"profile_torch_mvp: small objects: {res}")
        return res

    call()                                       # unprofiled warm-up
    stages.clear()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for u in undo:
        u()
    stats = {k: v for k, v in res["enhancement_stats"].items()
             if k != "processing_time"}
    _report(torch, prof, wall_ms, "small_object", card, 1, out,
            host_stages_s=stages, results=len(res["results"]),
            enhancement_stats=stats)


def _image_query_windows(torch, np, engine, acts, card, out, tmp) -> None:
    """A cold ``traditional`` and a warm ``smart_match`` image query
    under the profiler, each with the host seconds of its stages."""
    from torch.profiler import profile

    import chip_smoke
    from avede_tpu_torch.io import video_reader
    from avede_tpu_torch.services import video_processor

    video_processor.validate_video = video_reader.validate_video
    path = tmp / f"{chip_smoke.IMAGE_VIDEO_ID}.mp4"
    chip_smoke.write_image_query_video(np, path)
    frames, _ = video_reader.VideoReader(sample_rate=1).extract_frames(
        str(path))
    refs = chip_smoke.image_query_refs(np, frames)
    proc = video_processor.VideoProcessor(engine=engine)
    stages = {}
    undo = chip_smoke.image_query_stages(stages, proc)

    def call(mode, ref, clips):
        res = proc.process_image_matching(
            str(path), refs[ref], matching_mode=mode,
            top_k=chip_smoke.IMAGE_TOP_K, extract_clips=clips,
            video_id=chip_smoke.IMAGE_VIDEO_ID)
        if res["status"] != "completed":
            sys.exit(f"profile_torch_mvp: image query ({mode}): {res}")
        return res

    for name, mode, ref, clips in (
            ("image_query_traditional_cold", "traditional", "A", True),
            (None, "smart_match", "C", False),
            ("image_query_smart_warm", "smart_match", "A", False)):
        if name is None:
            call(mode, ref, clips)                # unprofiled warm-up
            continue
        stages.clear()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = call(mode, ref, clips)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _report(torch, prof, wall_ms, name, card, 1, out,
                host_stages_s=chip_smoke.host_stage_report(stages),
                results=len(res["results"]))
    for u in undo:
        u()


def _vision_bucket(torch, np, engine, video, acts, card, out,
                   bucket: int = 128, reps: int = 5) -> None:
    """The vision tower alone on one packed I420 bucket, ``reps`` times
    under the profiler; the row adds device ms and events per bucket."""
    from torch.profiler import profile

    from avede_tpu_torch.ops.preprocess import pack_frames_i420

    size = engine.cfg.image_size
    packed = torch.from_numpy(pack_frames_i420(
        video._chunk(0, bucket), size, src="bgr")).to(engine.device)
    for _ in range(2):
        engine._embed_device(packed)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._embed_device(packed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out / "vision_bucket.json"))
    row = _summary(torch, prof, wall_ms, "vision_bucket")
    row.update(card=card, calls=reps, bucket=bucket,
               device_ms_per_bucket=row["device_busy_ms"] / reps,
               device_events_per_bucket=row["device_events"] / reps)
    print(json.dumps(row), flush=True)


def _dense_stages(torch, np, engine, reader, card) -> dict:
    """Host seconds of each stage of one dense scan of a library video,
    run one after another (the scan overlaps decode with embed)."""
    from avede_tpu_torch.ops.dedup import _signatures
    from avede_tpu_torch.ops.preprocess import pack_frames_i420

    import chip_smoke

    video = reader.videos[chip_smoke.LIBRARY_VIDEOS[1]]
    size, n, chunk = engine.cfg.image_size, chip_smoke.N_FRAMES, 256
    t0 = time.perf_counter()
    frames = video._chunk(0, n)
    t1 = time.perf_counter()
    packed = pack_frames_i420(frames, size, src="bgr")
    t2 = time.perf_counter()
    _signatures(packed[:, :size])
    t3 = time.perf_counter()
    engine.embed_stream(packed[i:i + chunk] for i in range(0, n, chunk))
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    return {"window": "dense_scan_stages", "card": card,
            "frames": n, "synthesize_s": t1 - t0,
            "pack_i420_s": t2 - t1, "dedup_signatures_s": t3 - t2,
            "embed_s": t4 - t3}


if __name__ == "__main__":
    main()
