"""Caption service: batched BLIP captioning + caption↔query similarity
(counterpart of ``avede_tpu/services/captioner.py``).

Whole candidate batches caption together (one vision forward, one
decode loop); caption↔query similarity is real, both texts going through
the shared CLIP text tower. The phase-2 reranker interface splits the
work into a query-independent half (``frame_repr``: the caption, cached
per frame by ``io.embedding_cache.FrameReprCache``) and a cheap
query-dependent half (``scores_from_repr``).

``BLIP_MODEL`` values containing "kimi-vl" select
``KimiVLCaptionService``: Kimi-VL-A3B-Instruct captions the frames (its
MoonViT, latent attention and sparse experts on the card), and the
captions are scored against the query as BLIP's are.
``BLIP_MODEL`` values containing "blip2" select ``Blip2RerankService``,
the BLIP-2 Q-Former reranker: it scores candidate frames against the
query directly by image-text contrastive similarity (ITC), no caption
round trip; its query-independent half is the Q-Former's per-query image
embeddings.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.blip import BlipConfig, blip_base, init_blip
from ..models.convert import load_params
from ..models.kimi_vl import (KimiVLConfig, generate, init_kimi_vl,
                              state_dict_on)
from ..models.qformer import QFormerConfig, init_blip2
from ..models.tokenizer import (HashCaptionDecoder, HashTokenizer,
                                WordPieceTokenizer)
from ..ops.preprocess import blip_preprocess, siglip_preprocess
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.platform import resolve_device, with_compute_dtype
from ..utils.trace import span

logger = get_logger(__name__)


def _params_identity(state_dict: Dict[str, torch.Tensor]) -> str:
    """Stable identity for explicitly-passed weights: different weights
    must never share repr-cache entries. Digests every tensor's shape
    plus its first and last KB as f32 (its first and last 256 values),
    so checkpoints sharing one frozen tensor still get distinct tags.
    The values are sliced on the tensor's own device before they come to
    the host: never a whole tensor."""
    names = sorted(state_dict)
    ends = []
    for name in names:
        flat = state_dict[name].detach().reshape(-1)
        ends += [flat[:256].float().cpu().numpy(),
                 flat[-256:].float().cpu().numpy()]
    h = hashlib.md5()
    for k, name in enumerate(names):
        shape = tuple(state_dict[name].shape) or (1,)   # 0-d: as numpy's
        h.update(str(shape).encode())
        h.update(ends[2 * k].tobytes())
        h.update(ends[2 * k + 1].tobytes())
    return "explicit:" + h.hexdigest()[:8]


def _load_model(model: torch.nn.Module,
                state_dict: Optional[Dict[str, torch.Tensor]],
                weights_path: Optional[str], device: torch.device,
                dtype: torch.dtype, what: str):
    """(``model`` with its weights from ``state_dict``, else
    ``weights_path`` / ``settings.BLIP_WEIGHTS``, else as initialised
    (random from seed 0), on ``device`` in ``dtype``, eval mode; its
    weights' identity for repr-cache tags)."""
    weights_path = weights_path or settings.BLIP_WEIGHTS
    if state_dict is not None:
        src = _params_identity(state_dict)
    elif weights_path and Path(weights_path).exists():
        state_dict = load_params(weights_path)
        src = f"ckpt:{weights_path}"
        logger.info("%s weights loaded from %s", what, weights_path)
    else:
        src = "rand0"
        logger.info("%s randomly initialised (no checkpoint)", what)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(device, dtype).eval(), src


def _wordpiece_for(vocab_path: Optional[str], model_vocab_size: int,
                   mode: str = "decode") -> Optional[WordPieceTokenizer]:
    """The bundled (or explicit) WordPiece vocab, ONLY when its id space
    fits the model (the JAX package's two rules). ``decode`` wants the
    exact width: the bundled 30524 entries fit BLIP-base; against a tiny
    100-id test decoder they would map every generated id to [PAD] or
    [unused]. ``encode`` wants every reachable id (real pieces, not the
    bracketed specials a lowercased query never hits) inside the model's
    embedding table: BLIP-2's Q-Former is 30523 wide."""
    path = vocab_path or settings.BLIP_VOCAB
    if not (path and Path(path).exists()):
        return None
    tok = WordPieceTokenizer(path)
    if mode == "decode":
        ok = len(tok.inv) == model_vocab_size
    else:
        reachable = max((i for w, i in tok.vocab.items()
                         if not (w.startswith("[") and w.endswith("]"))),
                        default=0)
        ok = max(reachable, tok.unk) < model_vocab_size
    if not ok:
        logger.info("WordPiece vocab %d doesn't fit model vocab %d (%s) "
                    "— using hash fallback", len(tok.inv),
                    model_vocab_size, mode)
        return None
    return tok


class CaptionService:
    """BLIP captioner on the engine's device.

    Weights: ``state_dict`` (e.g. ``models.convert.params_from_jax``),
    else ``weights_path`` / ``settings.BLIP_WEIGHTS`` (the JAX package's
    flat ``.npz``), else random from seed 0. A default config is
    BLIP-base in the device's compute dtype (bf16 on the card)."""

    repr_kind = "blipcap"

    def __init__(self, engine: ClipEngine,
                 cfg: Optional[BlipConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 weights_path: Optional[str] = None,
                 vocab_path: Optional[str] = None) -> None:
        self.engine = engine
        self.device = engine.device
        self.cfg = cfg or with_compute_dtype(blip_base(), self.device)
        self.model, self._param_src = _load_model(
            init_blip(self.cfg, seed=0), state_dict, weights_path,
            self.device, self.cfg.torch_dtype, "BLIP")
        self.decoder = (_wordpiece_for(vocab_path, self.cfg.vocab_size)
                        or HashCaptionDecoder())

    def caption_ids(self, frames: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W, 3] → caption ids [N, max_caption_len]: the
        whole batch through one vision forward and one decode
        (``CAPTION_NUM_BEAMS`` > 1: beam search)."""
        beams = max(1, int(settings.CAPTION_NUM_BEAMS))
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        with torch.inference_mode():
            px = blip_preprocess(x, size=self.cfg.image_size)
            if beams == 1:
                ids = self.model.generate(px)
            else:
                ids = self.model.generate_beam(
                    px, beams,
                    length_penalty=float(settings.CAPTION_LENGTH_PENALTY))
        return ids.cpu().numpy()

    def caption_frames(self, frames: np.ndarray) -> List[str]:
        """uint8 [N, H, W, 3] → N caption strings."""
        if len(frames) == 0:
            return []
        caps = []
        for row in self.caption_ids(frames):
            toks = []
            for t in row.tolist()[1:]:
                if t == self.cfg.eos_token_id or t == self.cfg.pad_token_id:
                    break
                toks.append(t)
            caps.append(self.decoder.decode(toks) or "image content")
        return caps

    def caption_query_similarity(self, captions: List[str],
                                 query: str) -> np.ndarray:
        """Cosine between caption and query in CLIP text space → [N]."""
        if not captions:
            return np.zeros((0,), np.float32)
        embs = self.engine.embed_texts(captions + [query])
        return (embs[:-1] @ embs[-1]).astype(np.float32)

    # Phase-2 reranker interface ------------------------------------------
    @property
    def repr_tag(self) -> str:
        c = self.cfg
        beams = max(1, int(settings.CAPTION_NUM_BEAMS))
        dec = (f"wp:{self.decoder.vocab_path}"
               if isinstance(self.decoder, WordPieceTokenizer)
               else type(self.decoder).__name__)
        return (f"capv1|{c.image_size}px|{c.vision_depth}x{c.vision_dim}"
                f"|{c.text_depth}x{c.text_dim}|b{beams}"
                f"|p{float(settings.CAPTION_LENGTH_PENALTY):g}"
                f"|{dec}|{self._param_src}|torch")

    def frame_repr(self, frames: np.ndarray) -> List[np.ndarray]:
        return [np.str_(c) for c in self.caption_frames(frames)]

    def scores_from_repr(self, reprs: List[np.ndarray], query: str
                         ) -> Tuple[np.ndarray, List[dict]]:
        caps = [str(r) for r in reprs]
        sims = self.caption_query_similarity(caps, query)
        return sims, [{"caption": c} for c in caps]

    def rerank_scores(self, frames: np.ndarray, query: str
                      ) -> Tuple[np.ndarray, List[dict]]:
        """Caption ``frames`` and score the captions against ``query``
        (both halves of the reranker interface in one call)."""
        return self.scores_from_repr(self.frame_repr(frames), query)


class Blip2RerankService:
    """BLIP-2 Q-Former ITC reranker on ``device`` (``cuda`` unless the
    caller asks for the CPU): candidate frames scored against the query
    by the max over query tokens of ``img · txt``.

    Weights: ``state_dict`` (e.g. ``models.convert.params_from_jax``),
    else ``weights_path`` / ``settings.BLIP_WEIGHTS`` (the JAX package's
    flat ``.npz``), else random from seed 0. A default config is the
    full BLIP-2 (ViT-g, 32 queries) in the device's compute dtype."""

    repr_kind = "blip2img"

    def __init__(self, cfg: Optional[QFormerConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 weights_path: Optional[str] = None,
                 tokenizer=None, device=None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg or with_compute_dtype(QFormerConfig(), self.device)
        self.model, self._param_src = _load_model(
            init_blip2(self.cfg, seed=0), state_dict, weights_path,
            self.device, self.cfg.torch_dtype, "BLIP-2")
        self.tokenizer = (tokenizer
                          or _wordpiece_for(None, self.cfg.vocab_size,
                                            mode="encode")
                          or HashTokenizer(self.cfg.vocab_size))

    @property
    def repr_tag(self) -> str:
        c = self.cfg
        return (f"itcv1|{c.image_size}px|{c.vision_depth}x{c.vision_dim}"
                f"|{c.num_query_tokens}q|{c.projection_dim}d"
                f"|{c.hidden}h|{c.depth}L|{self._param_src}|torch")

    def query_ids(self, query: str) -> np.ndarray:
        """[CLS] + the first 30 pieces + [SEP] → int64 [1, K]. Raises for
        an id past the embedding table (a table under 103 rows cannot
        hold [SEP]), which JAX's gather turns into NaN scores."""
        ids = [101] + self.tokenizer.encode(query)[:30] + [102]
        if max(ids) >= self.cfg.vocab_size:
            raise ValueError(f"token id {max(ids)} outside the Q-Former's "
                             f"{self.cfg.vocab_size}-row embedding table")
        return np.asarray([ids], np.int64)

    def frame_repr(self, frames: np.ndarray) -> List[np.ndarray]:
        """uint8 [N, H, W, 3] → per-frame unit Q-Former image
        embeddings, f32 [Q, D] each."""
        with span("blip2.frame_repr"):
            if len(frames) == 0:
                return []
            with span("blip2.upload"):
                x = torch.from_numpy(np.ascontiguousarray(frames)).to(
                    self.device)
            with torch.inference_mode():
                with span("blip2.vision"):     # the host's enqueue
                    px = blip_preprocess(x, size=self.cfg.image_size)
                    img = self.model.image_embeds(px)
                img = img.cpu().numpy()
            return [row for row in img]

    def scores_from_repr(self, reprs: List[np.ndarray], query: str
                         ) -> Tuple[np.ndarray, List[dict]]:
        with span("blip2.scores_from_repr"):
            if not reprs:
                return np.zeros((0,), np.float32), []
            ids = torch.from_numpy(self.query_ids(query)).to(self.device)
            with torch.inference_mode():
                txt = self.model.text_embeds(
                    ids, torch.ones_like(ids, dtype=torch.bool))
            txt = txt.cpu().numpy()[0]                             # [D]
            img = np.stack([np.asarray(r, np.float32) for r in reprs])
            scores = (img @ txt).max(axis=1).astype(np.float32)  # max over Q
            return scores, [{"itc_score": float(v)} for v in scores]

    def rerank_scores(self, frames: np.ndarray, query: str
                      ) -> Tuple[np.ndarray, List[dict]]:
        return self.scores_from_repr(self.frame_repr(frames), query)


def kimi_prompt(cfg: KimiVLConfig) -> Tuple[List[int], List[int]]:
    """The ids before and after a frame's image tokens: Kimi-VL's chat
    turns (system, then the user's image and request, then the
    assistant's turn opened), 12 ids each, words through the hash
    tokenizer until Kimi's tiktoken vocabulary is in the repository."""
    tok = HashTokenizer(cfg.vocab_size)
    before = ([cfg.im_system_id] + tok.encode("system") + [cfg.im_middle_id]
              + tok.encode("You are a helpful assistant")
              + [cfg.im_end_id, cfg.im_user_id] + tok.encode("user")
              + [cfg.im_middle_id])
    after = (tok.encode("Describe this video frame in one sentence.")
             + [cfg.im_end_id, cfg.im_assistant_id]
             + tok.encode("assistant") + [cfg.im_middle_id])
    return before, after


IMAGE_ROWS = 16     # image tokens a frame that frame_repr's details keep


class KimiVLCaptionService:
    """Kimi-VL-A3B-Instruct captioner on ``device`` (the engine's unless
    given): each candidate frame resized to the configuration's
    896×504, MoonViT and the projector, a prompt of 12 + 576 + 12 ids,
    greedy decoding of ``max_new_tokens`` ids through the latent cache;
    the captions scored against the query in CLIP text space, as
    ``CaptionService`` scores BLIP's.

    Weights: ``state_dict`` (tensors on ``device`` in the config's dtype,
    used as they are: the model is built on the meta device and takes
    them), else random from seed 0 drawn on the device. A default
    config is the published model in the device's compute dtype. Ids
    decode through ``HashCaptionDecoder`` until Kimi's vocabulary is in
    the repository."""

    repr_kind = "kimicap"

    def __init__(self, engine: ClipEngine,
                 cfg: Optional[KimiVLConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 device=None) -> None:
        self.engine = engine
        self.device = (engine.device if device is None
                       else resolve_device(device))
        self.cfg = cfg or with_compute_dtype(KimiVLConfig(), self.device)
        if state_dict is not None:
            self._param_src = _params_identity(state_dict)
            self.model = state_dict_on(self.cfg, state_dict, self.device)
        else:
            self._param_src = "rand0"
            self.model = init_kimi_vl(self.cfg, 0, self.device)
        self.decoder = HashCaptionDecoder()
        before, after = kimi_prompt(self.cfg)
        self.image_at = len(before)
        t = self.cfg.image_tokens
        n = min(IMAGE_ROWS, t)
        self.image_rows = torch.arange(n, device=self.device) * t // n
        self.prompt = torch.tensor(
            before + [self.cfg.media_pad_id] * self.cfg.image_tokens + after,
            device=self.device)

    @property
    def repr_tag(self) -> str:
        c = self.cfg
        return (f"kimicap|{c.image_width}x{c.image_height}"
                f"|{c.vision_layers}x{c.vision_hidden_size}"
                f"|{c.num_hidden_layers}x{c.hidden_size}"
                f"|e{c.n_routed_experts}k{c.num_experts_per_tok}"
                f"|n{c.max_new_tokens}|{type(self.decoder).__name__}"
                f"|{self._param_src}|torch")

    def caption(self, ids: np.ndarray) -> str:
        """One frame's generated ids → its caption (up to its first eos)."""
        toks = []
        for t in ids.tolist():
            if t == self.cfg.im_end_id:
                break
            toks.append(t)
        return self.decoder.decode(toks) or "image content"

    def frame_repr(self, frames: np.ndarray, return_details: bool = False):
        """uint8 [N, H, W, 3] → one caption a frame (``np.str_``). With
        ``return_details``: ``(captions, details)``, details holding the
        chosen ``ids`` (int64 [N, n]) and each one's ``logits`` (f32
        [N, n]) on the host; kept on the device, ``routes``, every MoE
        layer's routed choices for the request (uint8 [n_moe, N, P + n -
        1, k]), and ``image``, each frame's image tokens at
        ``image_rows`` (``IMAGE_ROWS`` evenly spaced of the 576)."""
        with span("kimi.frame_repr"):
            if len(frames) == 0:
                return ([], {}) if return_details else []
            c = self.cfg
            with span("kimi.upload"):
                x = torch.from_numpy(np.ascontiguousarray(frames)).to(
                    self.device)
            with torch.inference_mode():
                with span("kimi.vision"):
                    px = siglip_preprocess(x, c.image_height, c.image_width)
                    img = self.model.image_embeds(px)
                out = generate(self.model,
                               self.prompt.expand(len(frames), -1), img,
                               self.image_at, c.max_new_tokens, c.im_end_id,
                               keep_routes=return_details)
            ids = out["ids"].cpu().numpy()
            reprs = [np.str_(self.caption(row)) for row in ids]
            if not return_details:
                return reprs
            return reprs, {"ids": ids, "logits": out["logits"].cpu().numpy(),
                           "routes": out["routes"],
                           "image": img[:, self.image_rows]}

    def scores_from_repr(self, reprs: List[np.ndarray], query: str
                         ) -> Tuple[np.ndarray, List[dict]]:
        with span("kimi.scores_from_repr"):
            caps = [str(r) for r in reprs]
            if not caps:
                return np.zeros((0,), np.float32), []
            embs = self.engine.embed_texts(caps + [query])
            sims = (embs[:-1] @ embs[-1]).astype(np.float32)
            return sims, [{"caption": cap} for cap in caps]

    def rerank_scores(self, frames: np.ndarray, query: str
                      ) -> Tuple[np.ndarray, List[dict]]:
        return self.scores_from_repr(self.frame_repr(frames), query)


def make_reranker(engine: ClipEngine):
    """The phase-2 reranker by ``settings.BLIP_MODEL``: Kimi-VL captions
    (a value containing "kimi-vl") or BLIP-2's ITC (one containing
    "blip2") on the engine's device, else BLIP captions."""
    if "kimi-vl" in settings.BLIP_MODEL.lower():
        return KimiVLCaptionService(engine)
    if "blip2" in settings.BLIP_MODEL.lower():
        return Blip2RerankService(device=engine.device)
    return CaptionService(engine)
