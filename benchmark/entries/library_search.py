"""Runner of whole-library search: ``LibrarySearch.search(query,
top_k, threshold, per_video_k)`` over a library indexed on the device
(``POST /api/search-library``).

Traffic parameters (``traffic/<mix>.json``): ``videos`` videos of
``rows_per_video`` frame embeddings each (1 frame/s, so a row's
timestamp is its frame index in seconds), ``scenes_per_video`` scenes a
video: each row its scene's seeded unit centre plus Gaussian noise of
norm about ``scene_noise`` times the centre's, renormalised; a query of
``query_words`` = [least, most] words from the ``vocabulary`` file, the
lengths cycling through every value in a seeded order; ``top_k``,
``threshold``, ``per_video_k`` as the route passes them;
``check_requests`` searches judged after the window. ``settings`` holds
the program's settings for the cell (the index tier).

Set-up: ``VIDEO_DIR`` holds an empty ``<id>.mp4`` for each video;
``LibrarySearch.prewarm`` adds each video's rows to the service's own
device index through ``DeviceLibraryIndex.add``, taking them from this
runner in place of the scan's embedding cache. Every search then lists
``VIDEO_DIR`` and finds every video indexed.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import clip_text, library_topk
from benchmark.reference.tokens import ClipBPE


def rows_of(seed: int, video: int, rows: int, scenes: int, dim: int,
            noise: float, device) -> torch.Tensor:
    """Video ``video``'s unit rows, f32 ``[rows, dim]`` on ``device``."""
    gen = weights.generator(seed, 1000 + video, device)
    c = torch.randn((scenes, dim), generator=gen, device=device)
    c = c / torch.linalg.vector_norm(c, dim=1, keepdim=True)
    x = c.repeat_interleave(rows // scenes, dim=0)
    x = x + (noise / dim ** 0.5) * torch.randn((rows, dim), generator=gen,
                                               device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def video_id(v: int) -> str:
    return f"v{v:04d}"


class _Library:
    """What ``LibrarySearch`` takes as its scan: the CLIP engine, and each
    video's frame embeddings and timestamps."""

    def __init__(self, engine, entry: "Entry") -> None:
        self.engine = engine
        self.entry = entry

    def frame_embeddings(self, path: str, vid: Optional[str] = None):
        v = int(Path(path).stem[1:])
        e = self.entry
        return (e.rows(v).cpu().numpy(),
                np.arange(e.n_rows, dtype=np.float32).tolist())


class Entry:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 bench, program: bool = True) -> None:
        self.cfg, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.n_videos = int(traffic["videos"])
        self.n_rows = int(traffic["rows_per_video"])
        self.tier = traffic["settings"]["LIBRARY_INDEX_DTYPE"]
        self.words = bench.data(traffic["vocabulary"]).read_text().split()
        lo, hi = traffic["query_words"]
        rng = np.random.default_rng([abs(self.seed), 1])
        self.lengths = rng.permutation(np.arange(lo, hi + 1)).tolist()
        self.search = None
        self.setup_phases: Dict[str, float] = {}
        if program:
            from avede_tpu_torch.models.clip import CLIPConfig
            from avede_tpu_torch.parallel.embed import ClipEngine
            from avede_tpu_torch.services.library_search import \
                LibrarySearch
            from avede_tpu_torch.utils.config import settings

            for k, v in traffic.get("settings", {}).items():
                setattr(settings, k, v)
            videos = Path(settings.VIDEO_DIR)
            videos.mkdir(parents=True, exist_ok=True)
            for v in range(self.n_videos):
                (videos / f"{video_id(v)}.mp4").touch()
            names = {f.name for f in dataclasses.fields(CLIPConfig)}
            ccfg = CLIPConfig(**{k: v for k, v in config.items()
                                 if k in names})
            t = time.perf_counter()
            sd = weights.make(clip_text.param_spec(config), self.seed,
                              self.device, self.dtype)
            engine = ClipEngine(cfg=ccfg, state_dict=sd, device=self.device)
            del sd
            self.search = LibrarySearch(_Library(engine, self))
            t1 = time.perf_counter()
            n = self.search.prewarm()
            self.setup_phases = {"engine": t1 - t,
                                 "prewarm": time.perf_counter() - t1}
            if n != self.n_videos:
                raise RuntimeError(f"indexed {n} of {self.n_videos} videos")

    def rows(self, v: int) -> torch.Tensor:
        t = self.traffic
        return rows_of(self.seed, v, self.n_rows, int(t["scenes_per_video"]),
                       int(self.cfg["projection_dim"]),
                       float(t["scene_noise"]), self.device)

    # -- traffic ---------------------------------------------------------
    def request(self, i: int) -> Dict:
        rng = np.random.default_rng([abs(self.seed), 2, i])
        n = self.lengths[i % len(self.lengths)]
        return {"query": " ".join(self.words[j] for j in
                                  rng.integers(len(self.words), size=n)),
                "words": n}

    def units(self, req: Dict) -> int:
        return 1

    def size(self, req: Dict) -> int:
        return req["words"]

    def serve(self, req: Dict, spans: List[tuple]) -> List[tuple]:
        t = self.traffic
        t0 = time.perf_counter()
        res = self.search.search(req["query"], top_k=int(t["top_k"]),
                                 threshold=float(t["threshold"]),
                                 per_video_k=int(t["per_video_k"]))
        spans.append(("search", t0, time.perf_counter()))
        return [(r["video_id"], int(r["frame_index"]), float(r["timestamp"]),
                 float(r["confidence"])) for r in res["results"]]

    def warmup(self) -> None:
        """The text tower and one search (the harness's warm-up pass
        sends more)."""
        self.serve(self.request(1 << 41), [])

    def free(self) -> None:
        self.search = None
        gc.collect()

    # -- the check -------------------------------------------------------
    def _row(self, vid: str, frame: int) -> Optional[int]:
        if len(vid) != 5 or vid[0] != "v" or not vid[1:].isdigit():
            return None
        v = int(vid[1:])
        if v >= self.n_videos or not 0 <= frame < self.n_rows:
            return None
        return v * self.n_rows + frame

    def _queries(self, reqs: List[Dict], lowp=None) -> torch.Tensor:
        """The reference's unit query embeddings, f32 [D, Q]."""
        sd = weights.make(clip_text.param_spec(self.cfg), self.seed,
                          self.device, self.dtype)
        model = clip_text.ClipText(sd, self.cfg, lowp)
        ids = ClipBPE()([r["query"] for r in reqs],
                        int(self.cfg["max_text_len"]))
        with torch.no_grad():
            q = model.encode(torch.from_numpy(ids).to(self.device))
        return q.T.contiguous()

    def _scores(self, q: torch.Tensor, lowp=None) -> torch.Tensor:
        """Every row's score for each query, f32 [rows, Q]."""
        out = torch.empty((self.n_videos * self.n_rows, q.shape[1]),
                          device=self.device)
        for v in range(self.n_videos):
            vals = library_topk.tier_rows(self.rows(v), self.tier, lowp)
            out[v * self.n_rows:(v + 1) * self.n_rows] = vals @ q
        return out

    def _served(self, scores: torch.Tensor, reqs: List[Dict]
                ) -> List[List[tuple]]:
        t = self.traffic
        out = []
        for j in range(len(reqs)):
            rows = library_topk.capped_search(
                scores[:, j], lambda r: r // self.n_rows, int(t["top_k"]),
                float(t["threshold"]), int(t["per_video_k"]))
            out.append([(video_id(r // self.n_rows), r % self.n_rows,
                         float(r % self.n_rows), float(scores[r, j]))
                        for r in rows])
        return out

    def control_outputs(self, reqs: List[Dict]) -> List[List[tuple]]:
        """What the control serves for ``reqs``: the reference with its
        text tower and rows one step below the configuration (fp8 for
        bfloat16; the int8 tier's rows int4)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        lowp_rows = "int4" if self.tier == "int8" else "fp8"
        q = self._queries(reqs, "fp8")
        return self._served(self._scores(q, lowp_rows), reqs)

    def check(self, records) -> Dict[str, float]:
        """Each judged search against the reference's result for its
        query: ``rank_gap`` (the widest gap by which a served result's
        reference score lies below the reference's result of the same
        rank), ``score_err`` (the widest gap between a served confidence
        and its row's reference score) and ``bad_results`` (searches
        whose results break the request: a wrong count, an unknown row, a
        timestamp not its frame's, more than ``per_video_k`` a video, or
        not best first)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        t = self.traffic
        reqs = [r.request for r in records]
        scores = self._scores(self._queries(reqs))
        want = self._served(scores, reqs)
        gap = err = 0.0
        bad = 0
        for j, rec in enumerate(records):
            served = [(self._row(vid, f), conf)
                      for vid, f, _, conf in rec.output]
            counts: Dict[str, int] = {}
            for vid, _, _, _ in rec.output:
                counts[vid] = counts.get(vid, 0) + 1
            confs = [c for _, _, _, c in rec.output]
            if (len(rec.output) != len(want[j])
                    or any(r is None for r, _ in served)
                    or any(ts != float(f) for _, f, ts, _ in rec.output)
                    or max(counts.values(), default=0) > t["per_video_k"]
                    or confs != sorted(confs, reverse=True)):
                bad += 1
                continue
            g, e = library_topk.judge(scores[:, j],
                                      [self._row(v, f) for v, f, _, _
                                       in want[j]], served)
            gap, err = max(gap, g), max(err, e)
        del scores
        return {"rank_gap": gap, "score_err": err, "bad_results": float(bad)}
