"""Plain tokenizers for the references: CLIP's byte-pair encoding and
BERT's WordPiece, written from their published rules.

Both read the raw vocabulary files that ship beside the program
(``avede_tpu_torch/assets``); nothing of the program is imported. The
traffic's words are lowercase ASCII, so the text clean-up the full
tokenizers do (ftfy, HTML unescaping, Unicode classes) has nothing to
change and is left out; :func:`ascii_words` refuses anything else.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

ASSETS = Path(__file__).resolve().parents[2] / "avede_tpu_torch" / "assets"
CLIP_MERGES = ASSETS / "clip_bpe_merges.txt.gz"
BLIP_VOCAB = ASSETS / "blip_wordpiece_vocab.txt.gz"

CLS, SEP = 101, 102          # BERT's [CLS] and [SEP] ids


def _read(path: Path) -> str:
    if path.suffix == ".gz":
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return f.read()
    return path.read_text("utf-8")


def ascii_words(text: str) -> List[str]:
    words = text.split()
    for w in words:
        if not (w.isascii() and w.isalpha() and w.islower()):
            raise ValueError(f"reference tokenizers take lowercase ASCII "
                             f"words, not {w!r}")
    return words


def _byte_units() -> List[str]:
    """The 256 printable stand-ins of GPT-2/CLIP's byte alphabet, in
    vocabulary order."""
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
    return [chr(c) for c in cs]


class ClipBPE:
    """CLIP's BPE: the vocabulary is the 256 byte units, the same with
    ``</w>``, one entry a merge, then ``<|startoftext|>`` and
    ``<|endoftext|>``; a word merges its lowest-ranked adjacent pair until
    no pair is a merge."""

    def __init__(self, path: Path = CLIP_MERGES) -> None:
        lines = _read(path).split("\n")[1: 49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines if line]
        units = _byte_units()
        vocab = units + [u + "</w>" for u in units]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.ids: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.sot = self.ids["<|startoftext|>"]
        self.eot = self.ids["<|endoftext|>"]

    def word(self, w: str) -> List[int]:
        parts = list(w[:-1]) + [w[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self.ranks[p], p) for p in zip(parts, parts[1:])
                      if p in self.ranks]
            if not ranked:
                break
            a, b = min(ranked)[1]
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == a \
                        and parts[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        return [self.ids[p] for p in parts]

    def __call__(self, texts: Sequence[str], context: int) -> np.ndarray:
        """int64 ``[N, context]``: start, the words' pieces, end, zeros."""
        out = np.zeros((len(texts), context), np.int64)
        for n, text in enumerate(texts):
            ids = [i for w in ascii_words(text) for i in self.word(w)]
            ids = [self.sot] + ids[: context - 2] + [self.eot]
            out[n, : len(ids)] = ids
        return out


class WordPiece:
    """BERT's WordPiece: each word split greedily into the longest
    vocabulary pieces, pieces after the first marked ``##``."""

    def __init__(self, path: Path = BLIP_VOCAB) -> None:
        self.ids = {w: i for i, w in enumerate(_read(path).splitlines())}
        self.unk = self.ids["[UNK]"]

    def word(self, w: str) -> List[int]:
        out, start = [], 0
        while start < len(w):
            for end in range(len(w), start, -1):
                piece = w[start:end] if start == 0 else "##" + w[start:end]
                if piece in self.ids:
                    out.append(self.ids[piece])
                    start = end
                    break
            else:
                return out + [self.unk]
        return out

    def __call__(self, text: str, max_pieces: int = 30) -> np.ndarray:
        """int64 ``[1, K]``: [CLS], the first ``max_pieces`` pieces,
        [SEP]."""
        ids = [i for w in ascii_words(text) for i in self.word(w)]
        return np.asarray([[CLS] + ids[:max_pieces] + [SEP]], np.int64)
