"""Duplicate-frame gating for the scan path (counterpart of
``avede_tpu/ops/dedup.py``).

Runs of near-identical consecutive frames are detected with a cheap
host signature (16×16 gray thumbnail, mean absolute difference) and
only run representatives go through the ViT; ``FrameDeduper.scatter``
repeats each representative's embedding for every frame it stands for,
so the per-frame table keeps its full length. The thumbnail uses the
port's numpy INTER_AREA resize (``ops/preprocess.area_resize``) instead
of cv2.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from .preprocess import area_resize

SIG_SIZE = 16


def frame_signature(frame: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] → float32 [16, 16] gray thumbnail."""
    return _signatures(frame[None])[0]


def _signatures(frames: np.ndarray) -> np.ndarray:
    """uint8 [N, H, W, 3] (color) or [N, H, W] (gray/luma) → float32
    [N, 16, 16]: strided subsample to ≤2×SIG grid + channel mean, then
    one area resize of the batch."""
    h, w = frames.shape[1:3]
    sh = max(1, h // (2 * SIG_SIZE))
    sw = max(1, w // (2 * SIG_SIZE))
    small = frames[:, ::sh, ::sw]
    if frames.ndim == 4:
        small = small.mean(axis=3, dtype=np.float32)
    else:
        small = small.astype(np.float32)
    return area_resize(small, SIG_SIZE, SIG_SIZE)


class FrameDeduper:
    """Streaming near-duplicate gate.

    ``filter(chunk)`` returns the chunk's unique frames (possibly
    empty) and extends ``self.mapping`` with one representative index
    per input frame. After the stream, ``emb_unique[self.mapping]`` is
    the full-length embedding table.
    """

    def __init__(self, eps: float, signature_fn=None) -> None:
        self.eps = float(eps)
        self.mapping: List[int] = []
        self._prev_sig: Optional[np.ndarray] = None
        self._n_unique = 0
        # the fused-pack scan feeds PACKED i420 chunks [N, S*3/2, S];
        # its gate signatures come from the luma plane
        self._signature_fn = signature_fn or _signatures

    def filter(self, frames: np.ndarray) -> np.ndarray:
        if len(frames) == 0:
            return frames
        sigs = self._signature_fn(frames)
        keep = []
        for i in range(len(frames)):
            is_dup = (self._prev_sig is not None
                      and float(np.abs(sigs[i] - self._prev_sig).mean())
                      <= self.eps)
            if is_dup:
                self.mapping.append(self._n_unique - 1)
            else:
                keep.append(i)
                self.mapping.append(self._n_unique)
                self._n_unique += 1
                self._prev_sig = sigs[i]
        return frames[keep] if keep else frames[:0]

    @property
    def n_total(self) -> int:
        return len(self.mapping)

    @property
    def n_unique(self) -> int:
        return self._n_unique

    def scatter(self, emb_unique: np.ndarray) -> np.ndarray:
        """[n_unique, D] → [n_total, D] full per-frame table."""
        if emb_unique.shape[0] != self._n_unique:
            raise ValueError(
                f"expected {self._n_unique} unique embeddings, got "
                f"{emb_unique.shape[0]}")
        return emb_unique[np.asarray(self.mapping, np.int64)]


def rebatch(chunks, size: int) -> Iterator[np.ndarray]:
    """Coalesce an iterator of ``[c_i, ...]`` arrays into full
    ``[size, ...]`` chunks (last may be smaller), preserving order —
    the dedup gate and the sparse scan leave chunks of arbitrary size,
    and full chunks keep the embed on one bucket shape."""
    if size <= 0:
        raise ValueError(f"rebatch size must be positive, got {size}")
    buf: List[np.ndarray] = []
    count = 0
    for c in chunks:
        if len(c) == 0:
            continue
        buf.append(c)
        count += len(c)
        while count >= size:
            cat = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield cat[:size]
            rest = cat[size:]
            buf, count = ([rest], len(rest)) if len(rest) else ([], 0)
    if count:
        yield np.concatenate(buf) if len(buf) > 1 else buf[0]
