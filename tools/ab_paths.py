"""Time the port's one-device serving paths of one checkout on the card,
for an A/B of two trees run in turn on one machine.

    python3 tools/ab_paths.py --root PATH [--label NAME]
                              [--what paths|library|launch]

The checkout at ``--root`` comes first on ``sys.path``: its own
``chip_smoke.py`` and ``avede_tpu_torch`` are the ones that run, and its
kernels are built in its own tree. Each tree runs in a process of its
own; run them as parent, change, change, parent so that a drift of the
host shows. The script measures:

- ``host_launch_us``: the host's cost of one kernel wrapper call
  (``kernels.cosine_scores``, a [64, 512] f32 table and one query: a
  kernel of a few µs, so the loop waits on the host), 2000 calls on the
  host clock with one synchronisation after them, the median of 5 loops;
- phase 5 of ``chip_smoke.py`` (``drive_main_path``, ViT-B/32 in bf16):
  cold scan s, warm p50 ms, multi-query ms;
- phase 6 (``drive_library``): search cold s and warm p50 ms, each tier;
- phase 7 (``drive_index``): add p50, growth total, search p50 at k = 64
  and 1024, in bf16 and int8.

``--what launch`` measures ``host_launch_us`` alone. ``--what library``
measures instead the warm whole-library search of
phase 6 at more depth: one ``LibrarySearch`` a tier over the same three
cached videos, all alive at once, ``--repeats`` rounds of phase 6's
three queries with the tiers' order reversed every other round; the
wall of each search, and apart from it the parts a search runs
(``prewarm``, the text embed, ``DeviceLibraryIndex.search`` at k = 64
and at 1024: a search whose per-video cap leaves it short of ``top_k``
widens k by 4× up to the capacity), as medians a tier.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON
object; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path


def host_launch_us(torch, kernels) -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn((64, 512), device="cuda", generator=gen)
    q = torch.randn((512,), device="cuda", generator=gen)
    for _ in range(50):
        kernels.cosine_scores(emb, q)
    torch.cuda.synchronize()
    loops = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(2000):
            kernels.cosine_scores(emb, q)
        torch.cuda.synchronize()
        loops.append((time.perf_counter() - t0) / 2000 * 1e6)
    return statistics.median(loops)


def library_warm(torch, np, smoke, engine, root: Path, repeats: int
                 ) -> dict:
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.services.library_search import LibrarySearch
    from avede_tpu_torch.utils.config import settings

    videos = root / "library"
    videos.mkdir(parents=True)
    for vid in smoke.LIBRARY_VIDEOS:
        (videos / f"{vid}.mp4").touch()
    settings.VIDEO_DIR = str(videos)
    reader = smoke.LibraryReader(np)
    cache = EmbeddingCache(str(root / "library-cache"))
    tiers = ("bfloat16", "int8", "float32")
    searches = {}
    for dtype in tiers:                  # the first tier's search scans
        settings.LIBRARY_INDEX_DTYPE = dtype
        searches[dtype] = LibrarySearch(Phase1Scan(engine, reader=reader,
                                                   cache=cache))
        searches[dtype].search(smoke.QUERIES[0], top_k=10, threshold=-1.0,
                               per_video_k=3)
    qemb = engine.embed_texts(smoke.QUERIES)
    parts = {d: {"wall": [], "prewarm": [], "embed": [], "index": [],
                 "index_k1024": []} for d in tiers}

    def clock(fn, *a, **kw):
        t0 = time.perf_counter()
        fn(*a, **kw)
        return (time.perf_counter() - t0) * 1e3

    for r in range(repeats):
        for dtype in (tiers if r % 2 == 0 else tiers[::-1]):
            search, out = searches[dtype], parts[dtype]
            index = search._index
            for i, q in enumerate(smoke.QUERIES):
                out["wall"].append(clock(search.search, q, top_k=10,
                                         threshold=-1.0, per_video_k=3))
                out["prewarm"].append(clock(search.prewarm))
                out["embed"].append(clock(engine.embed_texts, q))
                out["index"].append(clock(index.search, qemb[i], 64))
                out["index_k1024"].append(clock(index.search, qemb[i],
                                                1024))
    return {d: {f"{k}_p50_ms": statistics.median(v) for k, v in p.items()}
            for d, p in parts.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout to time")
    ap.add_argument("--label", default=None)
    ap.add_argument("--what", choices=("paths", "library", "launch"),
                    default="paths")
    ap.add_argument("--repeats", type=int, default=30,
                    help="rounds of --what library")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    smoke = importlib.import_module("chip_smoke")
    if Path(smoke.__file__).resolve().parent != root:
        raise SystemExit(f"imported {smoke.__file__}, not {root}'s")
    card = smoke.card_line()
    print(card, flush=True)

    from avede_tpu_torch.ops import _build, kernels
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.utils.config import settings

    t0 = time.perf_counter()
    _build.build_all()
    out = {"label": args.label or str(root), "card": card,
           "build_s": time.perf_counter() - t0,
           "host_launch_us": host_launch_us(torch, kernels)}
    if args.what == "launch":
        print(json.dumps({"ab_paths": out}), flush=True)
        return
    video = smoke.SyntheticVideo(np, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        for attr in ("DATA_DIR", "VIDEO_DIR", "CLIP_DIR", "FRAME_DIR",
                     "EMBEDDING_DIR", "IMAGE_DIR", "LOG_DIR"):
            setattr(settings, attr, str(Path(tmp) / attr.lower()))
        engine = ClipEngine(device="cuda", seed=0)
        if args.what == "library":
            out["library_warm"] = library_warm(torch, np, smoke, engine,
                                               Path(tmp), args.repeats)
            print(json.dumps({"ab_paths": out}), flush=True)
            return
        mvp = smoke.drive_main_path(torch, np, engine, video,
                                    Path(tmp) / "embeddings")
        out["mvp"] = {k: mvp[k] for k in ("cold_scan_s", "warm_p50_ms",
                                          "warm_ms", "multi_query_ms")}
        library = smoke.drive_library(torch, np, engine, Path(tmp))
        out["library"] = {d: {k: r[k] for k in ("cold_s", "warm_p50_ms",
                                                "warm_ms")}
                          for d, r in library.items()}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out["index"] = {}
    for dtype in ("bfloat16", "int8"):
        r = smoke.drive_index(torch, np, dtype)
        out["index"][dtype] = {k: r[k] for k in (
            "add_p50_ms", "growth_total_s", "search_p50_ms",
            "search_p50_ms_k1024") if k in r}
    print(json.dumps({"ab_paths": out}), flush=True)


if __name__ == "__main__":
    main()
