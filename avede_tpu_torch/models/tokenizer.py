"""Text tokenization (copy of ``avede_tpu/models/tokenizer.py``).

BLIP's caption side: ``WordPieceTokenizer`` (BERT WordPiece, given a
``vocab.txt``, ``settings.BLIP_VOCAB``) and ``HashCaptionDecoder`` (its
fallback when the vocab does not fit the model). CLIP's, two tiers:

- ``CLIPBPETokenizer`` — a full byte-pair-encoding implementation of the
  CLIP tokenizer (the one behind ``open_clip.tokenize``).
  It requires the learned merges file (``bpe_simple_vocab_16e6.txt.gz``
  format), supplied via ``settings.TOKENIZER_VOCAB``.
- ``HashTokenizer`` — a deterministic, dependency-free fallback used when
  no merges file is configured (the repository ships no pretrained
  weights, so no tokenizer is linguistically meaningful here).
  Word-level, stable across processes, preserves the SOT/EOT framing and
  max-length-77 contract so every downstream component is exercisable.

Both produce int32 ``[N, context_len]`` with SOT at 0, EOT after the
last token, zero padding — and EOT is the maximum id so HF-style
``argmax(ids)`` pooling (models/clip.py) finds it.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.config import settings
from ..utils.logging import get_logger

logger = get_logger(__name__)

CONTEXT_LEN = 77


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte↔unicode map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


try:  # exact CLIP pattern needs \p{L}/\p{N} (the ``regex`` module,
    # shipped as a transformers dependency); stdlib fallback is
    # ASCII-only but keeps the framework dependency-free.
    import regex as _regex

    _WORD_PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex ships with transformers
    _WORD_PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )


class CLIPBPETokenizer:
    """Exact CLIP BPE given the learned merges file."""

    def __init__(self, bpe_path: str) -> None:
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = Path(bpe_path)
        data = (gzip.open(raw, "rt", encoding="utf-8").read()
                if raw.suffix == ".gz" else raw.read_text("utf-8"))
        merges = [tuple(line.split()) for line
                  in data.split("\n")[1: 49152 - 256 - 2 + 1] if line]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in _WORD_PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids


@lru_cache(maxsize=4)
def _load_bpe(bpe_path: str) -> CLIPBPETokenizer:
    """Memoized merges load — every engine builds a Tokenizer, and the
    merges parse + vocab build is the expensive part."""
    return CLIPBPETokenizer(bpe_path)


class HashTokenizer:
    """Deterministic fallback: word → stable hashed id.

    Ids occupy [4, vocab-3]; SOT = vocab-2, EOT = vocab-1 (maximum id,
    preserving argmax pooling). Not linguistically meaningful — but with
    randomly-initialised weights no tokenizer is; it keeps the whole
    stack deterministic & testable.
    """

    def __init__(self, vocab_size: int = 49408) -> None:
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        ids = []
        for tok in _WORD_PAT.findall(text):
            h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "big")
            ids.append(4 + h % (self.vocab_size - 8))
        return ids


class WordPieceTokenizer:
    """BERT WordPiece (BLIP text side) — greedy longest-match given a
    ``vocab.txt``; decode merges ``##`` continuations."""

    def __init__(self, vocab_path: str) -> None:
        self.vocab_path = str(vocab_path)  # cache-tag identity
        raw = Path(vocab_path)
        data = (gzip.open(raw, "rt", encoding="utf-8").read()
                if raw.suffix == ".gz" else raw.read_text("utf-8"))
        words = data.splitlines()
        self.vocab = {w: i for i, w in enumerate(words)}
        self.inv = words
        self.unk = self.vocab.get("[UNK]", 100)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in whitespace_clean(basic_clean(text)).lower().split(" "):
            start = 0
            while start < len(word):
                end = len(word)
                cur = None
                while start < end:
                    piece = word[start:end]
                    if start > 0:
                        piece = "##" + piece
                    if piece in self.vocab:
                        cur = self.vocab[piece]
                        break
                    end -= 1
                if cur is None:
                    ids.append(self.unk)
                    break
                ids.append(cur)
                start = end
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        for i in ids:
            if i >= len(self.inv):
                continue
            tok = self.inv[i]
            if tok.startswith("[") and tok.endswith("]"):
                continue
            if tok.startswith("##") and out:
                out[-1] = out[-1] + tok[2:]
            else:
                out.append(tok)
        return " ".join(out)


class HashCaptionDecoder:
    """Deterministic fallback decode for generated caption ids when no
    WordPiece vocab fits the model: each id becomes a stable pseudo-word,
    so the caption→CLIP-text similarity path stays exercisable."""

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"tok{int(i)}" for i in ids if int(i) > 3)


class Tokenizer:
    """Front-end used by the framework: pads/frames to [N, context_len]."""

    def __init__(self, bpe_path: Optional[str] = None,
                 vocab_size: int = 49408,
                 context_len: int = CONTEXT_LEN) -> None:
        bpe_path = bpe_path or settings.TOKENIZER_VOCAB
        self.impl: object
        if bpe_path and Path(bpe_path).exists():
            impl = _load_bpe(bpe_path)
            if impl.vocab_size <= vocab_size:
                self.impl = impl
                logger.info("CLIP BPE tokenizer loaded from %s "
                            "(vocab %d)", bpe_path, impl.vocab_size)
            else:
                # tiny test configs (vocab_size 256) can't index the
                # full BPE id range — their embedding table is smaller
                # than the tokenizer's vocab, so ids would silently
                # clamp in the gather
                self.impl = HashTokenizer(vocab_size)
                logger.debug(
                    "model vocab %d < BPE vocab %d (tiny/test "
                    "geometry) — ids via hash tokenizer",
                    vocab_size, impl.vocab_size)
        else:
            self.impl = HashTokenizer(vocab_size)
            logger.info("Using deterministic hash tokenizer (no BPE merges "
                        "file configured)")
        self.context_len = context_len
        self.sot = self.impl.sot
        self.eot = self.impl.eot

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_len), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.impl.encode(t)[: self.context_len - 2] \
                + [self.eot]
            out[i, : len(ids)] = ids
        return out


_DEFAULT: Optional[Tokenizer] = None


def get_tokenizer() -> Tokenizer:
    """The process-wide default ``Tokenizer()``, built at first use."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = Tokenizer()
    return _DEFAULT
