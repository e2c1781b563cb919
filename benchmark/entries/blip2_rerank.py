"""Runner of the BLIP-2 rerank entry: ``Blip2RerankService.frame_repr``
on a request's candidate frames, then ``.scores_from_repr`` against its
query (together ``rerank_scores``, the call ``Phase2Rerank`` makes for
candidates that miss its cache).

Traffic parameters (``traffic/<mix>.json``): ``candidates`` frames of
``frame_height`` × ``frame_width`` uint8 RGB a request, a window of
consecutive frames at a seeded start in a pool of ``frame_pool`` frames
made at set-up; a query of ``query_words`` = [least, most] words from
the ``vocabulary`` file, the lengths cycling through every value in a
seeded order; ``check_requests`` requests judged after the window.

Weights: random from the seed on the device, in the configuration's
dtype, handed to the service as its ``state_dict``. Frames: seeded
smooth colour fields with fine noise, made on the device and copied to
the host once.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import weights
from benchmark.reference import blip2_itc
from benchmark.reference.tokens import WordPiece


def _settings(overrides: Dict) -> None:
    from avede_tpu_torch.utils.config import settings

    for k, v in overrides.items():
        setattr(settings, k, v)


def make_frames(seed: int, n: int, h: int, w: int, wrap: int,
                device) -> np.ndarray:
    """uint8 [n + wrap, h, w, 3]: ``n`` seeded frames, then the first
    ``wrap`` again, so that any ``wrap + 1`` consecutive frames from a
    start below ``n`` are one contiguous slice."""
    gen = weights.generator(seed, 1, device)
    out = np.empty((n + wrap, h, w, 3), np.uint8)
    for lo in range(0, n, 16):
        m = min(16, n - lo)
        coarse = torch.rand((m, 3, max(1, h // 40), max(1, w // 40)),
                            generator=gen, device=device)
        x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                          align_corners=False)
        x = x + 0.08 * torch.randn((m, 3, h, w), generator=gen,
                                   device=device)
        x = (x.clamp(0, 1) * 255).round().to(torch.uint8)
        out[lo:lo + m] = x.permute(0, 2, 3, 1).cpu().numpy()
    out[n:] = out[:wrap]
    return out


class Entry:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 bench, program: bool = True) -> None:
        self.cfg, self.traffic = config, traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.cand = int(traffic["candidates"])
        self.words = bench.data(traffic["vocabulary"]).read_text().split()
        lo, hi = traffic["query_words"]
        rng = np.random.default_rng([abs(self.seed), 1])
        self.lengths = rng.permutation(np.arange(lo, hi + 1)).tolist()
        self.svc = None
        self.setup_phases: Dict[str, float] = {}
        t = time.perf_counter()
        if program:
            from avede_tpu_torch.models.qformer import QFormerConfig
            from avede_tpu_torch.services.captioner import \
                Blip2RerankService

            _settings(traffic.get("settings", {}))
            names = {f.name for f in dataclasses.fields(QFormerConfig)}
            qcfg = QFormerConfig(**{k: v for k, v in config.items()
                                    if k in names})
            sd = weights.make(blip2_itc.param_spec(config), self.seed,
                              self.device, self.dtype)
            t = self._phase("weights", t)
            self.svc = Blip2RerankService(cfg=qcfg, state_dict=sd,
                                          device=self.device)
            del sd
            t = self._phase("service", t)
        self.pool_n = int(traffic["frame_pool"])
        self.pool = make_frames(self.seed, self.pool_n,
                                int(traffic["frame_height"]),
                                int(traffic["frame_width"]), self.cand - 1,
                                self.device)
        self._phase("frames", t)

    def _phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.setup_phases[name] = now - since
        return now

    # -- traffic ---------------------------------------------------------
    def request(self, i: int) -> Dict:
        rng = np.random.default_rng([abs(self.seed), 2, i])
        n = self.lengths[i % len(self.lengths)]
        words = [self.words[j] for j in rng.integers(len(self.words),
                                                     size=n)]
        return {"start": int(rng.integers(self.pool_n)),
                "query": " ".join(words), "tokens": n + 2}

    def frames(self, req: Dict) -> np.ndarray:
        return self.pool[req["start"]:req["start"] + self.cand]

    def units(self, req: Dict) -> int:
        return self.cand

    def size(self, req: Dict) -> int:
        return req["tokens"]

    def serve(self, req: Dict, spans: List[tuple]) -> np.ndarray:
        t0 = time.perf_counter()
        reprs = self.svc.frame_repr(self.frames(req))
        t1 = time.perf_counter()
        scores, _ = self.svc.scores_from_repr(reprs, req["query"])
        t2 = time.perf_counter()
        spans += [("frame_repr", t0, t1), ("scores_from_repr", t1, t2)]
        return np.asarray(scores, np.float32)

    def warmup(self) -> None:
        """Every query length's text side (the harness's warm-up pass
        then sends whole requests)."""
        reprs = self.svc.frame_repr(self.pool[:self.cand])
        for n in sorted(set(self.lengths)):
            self.svc.scores_from_repr(reprs, " ".join(self.words[:n]))

    def free(self) -> None:
        self.svc = None
        gc.collect()

    # -- the check -------------------------------------------------------
    def _reference(self, lowp=None) -> blip2_itc.Blip2ITC:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sd = weights.make(blip2_itc.param_spec(self.cfg), self.seed,
                          self.device, self.dtype)
        w = {k: v.float() for k, v in sd.items()}
        del sd
        return blip2_itc.Blip2ITC(w, self.cfg, lowp)

    def _ref_scores(self, model, reqs: List[Dict]) -> List[np.ndarray]:
        wp = WordPiece()
        out = []
        with torch.no_grad():
            for req in reqs:
                frames = torch.from_numpy(self.frames(req)).to(self.device)
                ids = torch.from_numpy(wp(req["query"])).to(self.device)
                out.append(model.scores(frames, ids).cpu().numpy())
        return out

    def control_outputs(self, reqs: List[Dict]) -> List[np.ndarray]:
        """What the control serves for ``reqs``: the reference one step
        below bfloat16 (fp8)."""
        model = self._reference("fp8")
        try:
            return self._ref_scores(model, reqs)
        finally:
            del model
            gc.collect()

    def check(self, records) -> Dict[str, float]:
        """``score_gap``: the widest gap between a served score and the
        reference's score of the same frame and query, over the judged
        requests; ``bad_outputs``: judged requests whose scores are not
        one finite number a candidate."""
        model = self._reference()
        ref = self._ref_scores(model, [r.request for r in records])
        del model
        gc.collect()
        gap, bad = 0.0, 0
        for rec, want in zip(records, ref):
            got = np.asarray(rec.output, np.float32)
            if got.shape != want.shape or not np.all(np.isfinite(got)):
                bad += 1
                continue
            gap = max(gap, float(np.max(np.abs(got - want))))
        return {"score_gap": gap if bad == 0 else float("inf"),
                "bad_outputs": float(bad)}
