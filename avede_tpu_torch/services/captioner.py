"""Caption service: batched BLIP captioning + caption↔query similarity
(counterpart of ``avede_tpu/services/captioner.py``).

Whole candidate batches caption together (one vision forward, one
decode loop); caption↔query similarity is real, both texts going through
the shared CLIP text tower. The phase-2 reranker interface splits the
work into a query-independent half (``frame_repr``: the caption, cached
per frame by ``io.embedding_cache.FrameReprCache``) and a cheap
query-dependent half (``scores_from_repr``).

``BLIP_MODEL`` values containing "blip2" select the JAX package's BLIP-2
Q-Former reranker, which is not ported yet: ``make_reranker`` raises for
them (an error envelope at the API), never switching to BLIP quietly.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.blip import BlipConfig, blip_base, init_blip
from ..models.convert import load_params
from ..models.tokenizer import HashCaptionDecoder, WordPieceTokenizer
from ..ops.preprocess import blip_preprocess
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.errors import AvedeError
from ..utils.logging import get_logger
from ..utils.platform import with_compute_dtype

logger = get_logger(__name__)


def _params_identity(state_dict: Dict[str, torch.Tensor]) -> str:
    """Stable identity for explicitly-passed weights: different weights
    must never share repr-cache entries. Digests every tensor's shape
    plus its first and last KB, so checkpoints sharing one frozen tensor
    still get distinct tags."""
    h = hashlib.md5()
    for name in sorted(state_dict):
        a = np.ascontiguousarray(
            state_dict[name].detach().float().cpu().numpy())
        h.update(str(a.shape).encode())
        b = a.tobytes()
        h.update(b[:1024])
        h.update(b[-1024:])
    return "explicit:" + h.hexdigest()[:8]


def _wordpiece_for(vocab_path: Optional[str], model_vocab_size: int
                   ) -> Optional[WordPieceTokenizer]:
    """The bundled (or explicit) WordPiece vocab, ONLY when its id space
    is exactly the model's (the JAX package's ``decode`` rule): the
    bundled 30524 entries fit BLIP-base; against a tiny 100-id test
    decoder they would map every generated id to [PAD] or [unused]."""
    path = vocab_path or settings.BLIP_VOCAB
    if not (path and Path(path).exists()):
        return None
    tok = WordPieceTokenizer(path)
    if len(tok.inv) != model_vocab_size:
        logger.info("WordPiece vocab %d doesn't fit model vocab %d — "
                    "using hash fallback", len(tok.inv), model_vocab_size)
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
        weights_path = weights_path or settings.BLIP_WEIGHTS
        model = init_blip(self.cfg, seed=0)
        if state_dict is not None:
            self._param_src = _params_identity(state_dict)
        elif weights_path and Path(weights_path).exists():
            state_dict = load_params(weights_path)
            self._param_src = f"ckpt:{weights_path}"
            logger.info("BLIP weights loaded from %s", weights_path)
        else:
            self._param_src = "rand0"
            logger.info("BLIP randomly initialised (no checkpoint)")
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device, self.cfg.torch_dtype).eval()
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


def make_reranker(engine: ClipEngine) -> CaptionService:
    """The phase-2 reranker by ``settings.BLIP_MODEL``: BLIP captions;
    BLIP-2 (a value containing "blip2") raises until it is ported."""
    if "blip2" in settings.BLIP_MODEL.lower():
        raise AvedeError(
            f"BLIP_MODEL={settings.BLIP_MODEL!r} selects the BLIP-2 "
            f"Q-Former reranker, which is not ported yet")
    return CaptionService(engine)
