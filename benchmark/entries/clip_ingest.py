"""Runner of frame ingest: ``ClipEngine.embed_stream`` over one video's
decoded frames, handed in chunks as its callers hand them (the cold
scan's rebatched chunks; ``embed_frames``' chunks of
``EMBED_BATCH_PER_DEVICE``): the staging thread's I420 pack, the pinned
copy on a side stream, the fused patch embedding, the vision tower, the
embeddings back on the host.

Traffic parameters (``traffic/<mix>.json``): ``chunks`` chunks of
``chunk_frames`` uint8 RGB frames of ``frame_height`` × ``frame_width``
a request, each a view of consecutive frames at a seeded start in a pool
of ``frame_pool`` frames made at set-up (no chunk wraps, none is
copied); ``check_requests`` requests judged after the window, each at
``check_frames_per_chunk`` frames of every chunk (its first and last
among them). ``settings`` holds the program's settings for the cell
(the transfer codec, the frame buckets).

Weights: random from the seed on the device, in the configuration's
dtype, handed to the engine as its ``state_dict``. Frames: seeded smooth
colour fields with fine noise, made on the device in blocks and copied
to the host once.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.reference import clip_text, clip_vision

BLOCK = 32                 # frames a device block (set-up, the reference)


def make_pool(seed: int, n: int, h: int, w: int, device) -> np.ndarray:
    """uint8 [n, h, w, 3]: seeded colour fields (a coarse random grid,
    bilinear) with fine noise."""
    gen = weights.generator(seed, 1, device)
    out = np.empty((n, h, w, 3), np.uint8)
    for lo in range(0, n, BLOCK):
        m = min(BLOCK, n - lo)
        coarse = torch.rand((m, 3, max(1, h // 40), max(1, w // 40)),
                            generator=gen, device=device)
        x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                          align_corners=False)
        x = x + 0.08 * torch.randn((m, 3, h, w), generator=gen,
                                   device=device)
        x = (x.clamp(0, 1) * 255).round().to(torch.uint8)
        out[lo:lo + m] = x.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    return out


class Entry:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 bench, program: bool = True) -> None:
        self.cfg, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.n_chunks = int(traffic["chunks"])
        self.chunk = int(traffic["chunk_frames"])
        self.pool_n = int(traffic["frame_pool"])
        if self.pool_n < self.chunk:
            raise ValueError("frame_pool is smaller than a chunk")
        self.engine = None
        self.setup_phases: Dict[str, float] = {}
        t = time.perf_counter()
        if program:
            from avede_tpu_torch.models.clip import CLIPConfig
            from avede_tpu_torch.parallel.embed import ClipEngine
            from avede_tpu_torch.utils.config import settings

            for k, v in traffic.get("settings", {}).items():
                setattr(settings, k, v)
            names = {f.name for f in dataclasses.fields(CLIPConfig)}
            ccfg = CLIPConfig(**{k: v for k, v in config.items()
                                 if k in names})
            sd = weights.make(clip_text.param_spec(config), self.seed,
                              self.device, self.dtype)
            t = self._phase("weights", t)
            self.engine = ClipEngine(cfg=ccfg, state_dict=sd,
                                     device=self.device)
            del sd
            t = self._phase("engine", t)
        self.pool = make_pool(self.seed, self.pool_n,
                              int(traffic["frame_height"]),
                              int(traffic["frame_width"]), self.device)
        self._phase("frames", t)

    def _phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.setup_phases[name] = now - since
        return now

    # -- traffic ---------------------------------------------------------
    def request(self, i: int) -> Dict:
        rng = np.random.default_rng([abs(self.seed), 2, i])
        return {"starts": rng.integers(0, self.pool_n - self.chunk + 1,
                                       size=self.n_chunks).tolist()}

    def chunks(self, req: Dict) -> Iterator[np.ndarray]:
        return (self.pool[s:s + self.chunk] for s in req["starts"])

    def units(self, req: Dict) -> int:
        return self.n_chunks * self.chunk

    def size(self, req: Dict) -> int:
        return self.units(req)

    def serve(self, req: Dict, spans: List[tuple]) -> np.ndarray:
        t0 = time.perf_counter()
        emb = self.engine.embed_stream(self.chunks(req))
        spans.append(("embed_stream", t0, time.perf_counter()))
        return emb

    def warmup(self) -> None:
        """A request's chunks, at the pool's start, through the stream:
        the one bucket they fill, the staging thread, its pinned
        buffers."""
        self.engine.embed_stream(self.chunks({"starts": [0] * self.n_chunks}))

    def free(self) -> None:
        self.engine = None
        gc.collect()

    # -- the check -------------------------------------------------------
    def _judged(self, req: Dict, index: int) -> np.ndarray:
        """Positions judged in a request's output: of each chunk, its
        first and last frame and seeded others between them."""
        rng = np.random.default_rng([abs(self.seed), 3, index])
        k = min(int(self.traffic["check_frames_per_chunk"]), self.chunk)
        pos: List[int] = []
        for c in range(self.n_chunks):
            n = min(max(0, k - 2), max(0, self.chunk - 2))
            inner = rng.choice(np.arange(1, self.chunk - 1), size=n,
                               replace=False)
            pos += [c * self.chunk + p
                    for p in sorted({0, self.chunk - 1, *inner.tolist()})]
        return np.asarray(pos, np.int64)

    def _pool_index(self, req: Dict, pos: np.ndarray) -> np.ndarray:
        starts = np.asarray(req["starts"], np.int64)
        return starts[pos // self.chunk] + pos % self.chunk

    def _reference(self, lowp=None) -> clip_vision.ClipVision:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sd = weights.make(clip_text.param_spec(self.cfg), self.seed,
                          self.device, self.dtype)
        w = {k: v.float() for k, v in sd.items()
             if k.startswith("vision.")}
        del sd
        return clip_vision.ClipVision(w, self.cfg, lowp)

    def _embed(self, model, frames: np.ndarray) -> np.ndarray:
        """The reference's unit embeddings of uint8 frames, f32 [N, D]."""
        out = []
        with torch.no_grad():
            for lo in range(0, len(frames), BLOCK):
                x = torch.from_numpy(frames[lo:lo + BLOCK]).to(self.device)
                out.append(model.embed_frames(x).cpu().numpy())
        return np.concatenate(out) if out else np.zeros(
            (0, self.cfg["projection_dim"]), np.float32)

    def control_outputs(self, reqs: List[Dict]) -> List[np.ndarray]:
        """What the control serves for ``reqs``: the reference one step
        below bfloat16 (fp8), every frame of each request."""
        model = self._reference("fp8")
        try:
            return [np.concatenate([self._embed(model, c)
                                    for c in self.chunks(r)]) for r in reqs]
        finally:
            del model
            gc.collect()

    def check(self, records) -> Dict[str, float]:
        """``emb_err``: the widest distance between a served embedding and
        the reference's for the same frame, over the judged frames of the
        judged requests that have one finite row a frame;
        ``bad_outputs``: judged requests whose output is not one finite
        row a frame, or whose judged rows are not, each, nearest to its
        own frame's reference among the request's judged frames (frames
        left out, swapped or in the wrong order)."""
        model = self._reference()
        err, bad, judged = 0.0, 0, 0
        d = int(self.cfg["projection_dim"])
        for rec in records:
            got = np.asarray(rec.output, np.float32)
            if got.shape != (self.units(rec.request), d) \
                    or not np.all(np.isfinite(got)):
                bad += 1
                continue
            pos = self._judged(rec.request, rec.index)
            idx = self._pool_index(rec.request, pos)
            want = self._embed(model, self.pool[idx])
            served = got[pos]
            judged += 1
            err = max(err, float(np.linalg.norm(served - want,
                                                axis=1).max()))
            nearest = np.argmax(served @ want.T, axis=1)
            if np.any(idx[nearest] != idx):
                bad += 1
        del model
        gc.collect()
        return {"emb_err": err if judged else float("inf"),
                "bad_outputs": float(bad)}
