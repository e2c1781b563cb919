"""Runner of the VLM caption rerank entry: a vision-language model's
``frame_repr`` captions a request's candidate frames (``return_details``
gives the chosen ids, their logits, the MoE layers' routes and some of
each frame's image tokens), then
``scores_from_repr`` scores the captions against its query through the
CLIP text tower (together ``rerank_scores``, the call ``Phase2Rerank``
makes for candidates that miss its cache).

Traffic parameters (``traffic/<mix>.json``): as ``blip2_rerank``'s
(``candidates`` frames of ``frame_height`` × ``frame_width`` from a
seeded pool, a 4-12 word query), plus ``check_frames``: frames judged of
each judged request (its first and last among them).

Weights: random from the seed on the device, one stream a tensor
(``weights_by_tensor``), in the configuration's dtype, handed to the
service as its ``state_dict``; the CLIP scorer's (the configuration's
``scorer`` group) from ``weights.py``. The constructor imports the
service first, so a program without it fails at once.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import weights, weights_by_tensor
from benchmark.entries.blip2_rerank import make_frames
from benchmark.reference import clip_text, kimi_vl
from benchmark.reference.tokens import ClipBPE


def _settings(overrides: Dict) -> None:
    from avede_tpu_torch.utils.config import settings

    for k, v in overrides.items():
        setattr(settings, k, v)


class Entry:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device,
                 bench, program: bool = True) -> None:
        self.cfg, self.traffic = config, traffic
        self.m = kimi_vl.Dims(config)
        self.seed, self.device = int(seed), torch.device(device)
        self.dtype = getattr(torch, config["dtype"])
        self.scorer = dict(config["scorer"], dtype=config["dtype"])
        self.cand = int(traffic["candidates"])
        self.words = bench.data(traffic["vocabulary"]).read_text().split()
        lo, hi = traffic["query_words"]
        rng = np.random.default_rng([abs(self.seed), 1])
        self.lengths = rng.permutation(np.arange(lo, hi + 1)).tolist()
        before, after = kimi_vl.prompt(config)
        self.at = len(before)
        self.prompt = (before + [self.m.special["media_pad_id"]]
                       * self.m.image_tokens + after)
        self.svc = None
        self.setup_phases: Dict[str, float] = {}
        t = time.perf_counter()
        if program:
            from avede_tpu_torch.services.captioner import \
                KimiVLCaptionService
            from avede_tpu_torch.models.clip import CLIPConfig
            from avede_tpu_torch.models.kimi_vl import KimiVLConfig
            from avede_tpu_torch.parallel.embed import ClipEngine

            _settings(traffic.get("settings", {}))
            sd = weights_by_tensor.make(kimi_vl.param_spec(config), self.seed,
                                        self.device, self.dtype)
            t = self._phase("weights", t)
            names = {f.name for f in dataclasses.fields(CLIPConfig)}
            engine = ClipEngine(
                cfg=CLIPConfig(**{k: v for k, v in self.scorer.items()
                                  if k in names}),
                state_dict=self._clip_weights(), device=self.device)
            self.svc = KimiVLCaptionService(
                engine, cfg=KimiVLConfig.from_dict(config), state_dict=sd,
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

    def _clip_weights(self) -> Dict[str, torch.Tensor]:
        return weights.make(clip_text.param_spec(self.scorer), self.seed,
                            self.device, self.dtype)

    # -- traffic ---------------------------------------------------------
    def request(self, i: int) -> Dict:
        rng = np.random.default_rng([abs(self.seed), 2, i])
        n = self.lengths[i % len(self.lengths)]
        words = [self.words[j] for j in rng.integers(len(self.words),
                                                     size=n)]
        return {"index": int(i), "start": int(rng.integers(self.pool_n)),
                "query": " ".join(words), "tokens": n + 2}

    def frames(self, req: Dict) -> np.ndarray:
        return self.pool[req["start"]:req["start"] + self.cand]

    def units(self, req: Dict) -> int:
        return self.cand

    def size(self, req: Dict) -> int:
        return req["tokens"]

    def serve(self, req: Dict, spans: List[tuple]) -> Dict:
        t0 = time.perf_counter()
        caps, details = self.svc.frame_repr(self.frames(req),
                                            return_details=True)
        t1 = time.perf_counter()
        scores, _ = self.svc.scores_from_repr(caps, req["query"])
        t2 = time.perf_counter()
        spans += [("frame_repr", t0, t1), ("scores_from_repr", t1, t2)]
        return dict(details, captions=[str(c) for c in caps],
                    scores=np.asarray(scores, np.float32))

    def warmup(self) -> None:
        """Every query length's text side (the harness's warm-up pass
        then sends whole requests)."""
        caps = self.svc.frame_repr(self.pool[:self.cand])
        for n in sorted(set(self.lengths)):
            self.svc.scores_from_repr(caps, " ".join(self.words[:n]))

    def free(self) -> None:
        self.svc = None
        gc.collect()

    # -- the reference ---------------------------------------------------
    def _model(self, lowp=None) -> kimi_vl.KimiRef:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return kimi_vl.KimiRef(
            self.cfg, kimi_vl.Weights(self.cfg, self.seed, self.device,
                                      self.dtype, lowp), lowp)

    def _pixels(self, frames: np.ndarray) -> torch.Tensor:
        return kimi_vl.preprocess(torch.from_numpy(np.ascontiguousarray(
            frames)).to(self.device), self.m.height, self.m.width)

    def _clip(self, lowp=None) -> clip_text.ClipText:
        return clip_text.ClipText({k: v.float() for k, v in
                                   self._clip_weights().items()},
                                  self.scorer, lowp)

    def _clip_scores(self, model, captions: List[str], query: str
                     ) -> np.ndarray:
        bpe = ClipBPE()
        ctx = int(self.scorer["max_text_len"])
        ids = np.concatenate([kimi_vl.clip_ids(bpe, captions, ctx),
                              bpe([query], ctx)])
        with torch.no_grad():
            e = model.encode(torch.from_numpy(ids).to(self.device))
        return (e[:-1] @ e[-1]).cpu().numpy()

    def control_outputs(self, reqs: List[Dict]) -> List[Dict]:
        """What the control serves for ``reqs``: the reference one step
        below bfloat16 (fp8) generating its own captions and routes."""
        model, scorer = self._model("fp8"), self._clip("fp8")
        m, out = self.m, []
        with torch.no_grad():
            for req in reqs:
                frames = self.frames(req)
                img = model.image_embeds(self._pixels(frames))
                ids = torch.tensor(self.prompt, device=self.device).expand(
                    len(frames), -1)
                g = model.generate(ids, img, self.at, m.max_new, m.eos)
                g["image"] = img[:, self._image_rows()]
                gen = g["ids"].cpu().numpy()
                caps = [kimi_vl.caption(row, m.eos) for row in gen]
                out.append({"ids": gen, "logits": g["logits"].cpu().numpy(),
                            "routes": g["routes"], "image": g["image"],
                            "captions": caps,
                            "scores": self._clip_scores(scorer, caps,
                                                        req["query"])})
        return out

    # -- the check -------------------------------------------------------
    def _image_rows(self) -> torch.Tensor:
        """The image tokens a frame the service's details keep: 16 (or
        all, if fewer) evenly spaced."""
        t = self.m.image_tokens
        n = min(16, t)
        return torch.arange(n, device=self.device) * t // n

    def judged_frames(self, req: Dict) -> List[int]:
        """The frames judged of a request: its first and last, and others
        drawn from the seed."""
        n = min(int(self.traffic["check_frames"]), self.cand)
        rng = np.random.default_rng([abs(self.seed), 3, req["index"]])
        rest = rng.choice(np.arange(1, self.cand - 1), size=max(0, n - 2),
                          replace=False)
        return sorted({0, self.cand - 1, *rest.tolist()})[:n]

    def _bad(self, out) -> bool:
        """A request's output not of the contract: a finite score and a
        caption a candidate, each caption the decoding of its frame's
        ids, ids in the vocabulary, the full number of steps (fewer only
        when every frame has ended), routes and kept image tokens of the
        layers' shapes."""
        m = self.m
        try:
            ids, logits = np.asarray(out["ids"]), np.asarray(out["logits"])
            routes, scores = out["routes"], np.asarray(out["scores"])
            n = ids.shape[1]
            ok = (ids.shape == (self.cand, n) == logits.shape
                  and 1 <= n <= m.max_new
                  and (n == m.max_new or all(m.eos in r for r in ids))
                  and ids.min() >= 0 and ids.max() < m.vocab
                  and np.isfinite(logits).all()
                  and scores.shape == (self.cand,)
                  and np.isfinite(scores).all()
                  and len(out["captions"]) == self.cand
                  and all(c == kimi_vl.caption(r, m.eos)
                          for c, r in zip(out["captions"], ids))
                  and tuple(routes.shape) == (m.layers - m.n_dense, self.cand,
                                              len(self.prompt) + n - 1, m.k)
                  and tuple(out["image"].shape) == (
                      self.cand, len(self._image_rows()), m.d)
                  and bool(torch.isfinite(out["image"]).all())
                  and int(routes.max()) < m.n_routed)
        except (KeyError, TypeError, ValueError, AttributeError, IndexError):
            return True
        return not ok

    def check(self, records) -> Dict[str, float]:
        """Against the plain f32 reference: ``image_gap`` (the judged
        frames' kept image tokens, MoonViT and the projector: the largest
        distance over the reference's norm, a frame),
        ``route_gap``, ``logit_gap``, ``greedy_gap`` (over every step of
        the judged frames, up to each one's first eos) and ``score_gap``
        (every caption of the judged requests); ``bad_outputs``: judged
        requests not of the contract (``_bad``)."""
        good = [r for r in records if not self._bad(r.output)]
        bad = len(records) - len(good)
        checks = {"image_gap": 0.0, "route_gap": 0.0, "logit_gap": 0.0,
                  "greedy_gap": 0.0, "score_gap": 0.0}
        if good:
            self._judge(good, checks)
        if bad:
            checks = {k: float("inf") for k in checks}
        checks["bad_outputs"] = float(bad)
        return checks

    def _judge(self, recs, checks: Dict[str, float]) -> None:
        m = self.m
        picks = [self.judged_frames(r.request) for r in recs]
        frames = np.concatenate([self.frames(r.request)[p]
                                 for r, p in zip(recs, picks)])
        n = min(np.asarray(r.output["ids"]).shape[1] for r in recs)
        ids = np.concatenate([np.asarray(r.output["ids"])[p, :n]
                              for r, p in zip(recs, picks)])
        served = np.concatenate([np.asarray(r.output["logits"])[p, :n]
                                 for r, p in zip(recs, picks)])
        routes = torch.cat([r.output["routes"][:, p, :len(self.prompt) + n - 1]
                            .to(self.device) for r, p in zip(recs, picks)], 1)
        model = self._model()
        seq = torch.cat([torch.tensor(self.prompt, device=self.device).expand(
            len(ids), -1), torch.from_numpy(ids[:, :n - 1]).to(self.device)],
            1)
        image = torch.cat([r.output["image"][p].to(self.device).float()
                           for r, p in zip(recs, picks)])
        with torch.no_grad():
            img = model.image_embeds(self._pixels(frames))
            want = img[:, self._image_rows()]
            checks["image_gap"] = float(
                ((want - image).flatten(1).norm(dim=1)
                 / want.flatten(1).norm(dim=1)).max())
            logits, gap = model.teacher_forced(seq, img, self.at, routes,
                                               len(self.prompt) - 1)
            idx = torch.from_numpy(ids).to(self.device)
            at_id = logits.gather(2, idx[..., None])[..., 0].cpu().numpy()
            best = logits.max(-1).values.cpu().numpy()
        del model, logits, img
        gc.collect()
        live = np.ones_like(ids, bool)          # up to each first eos
        for i, row in enumerate(ids):
            hit = np.nonzero(row == m.eos)[0]
            if hit.size:
                live[i, hit[0] + 1:] = False
        checks["route_gap"] = gap
        checks["logit_gap"] = float(np.abs(served - at_id)[live].max())
        checks["greedy_gap"] = float((best - at_id)[live].max())
        scorer = self._clip()
        checks["score_gap"] = max(
            float(np.abs(np.asarray(r.output["scores"]) - self._clip_scores(
                scorer, list(r.output["captions"]), r.request["query"])).max())
            for r in recs)
