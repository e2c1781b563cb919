"""Video decode + frame sampling, host side (copy of
``avede_tpu/io/video_reader.py``; cv2 is imported inside the functions
that decode, so importing this module needs no cv2).

- sample every ``FRAME_SAMPLE_RATE``-th frame;
- hard cap ``MAX_FRAMES`` (1000) with even redistribution across the
  video;
- frames resized so max(H, W) ≤ ``FRAME_MAX_SIZE`` (512), aspect kept;
- timestamps = frame_index / fps; fps falls back to 30 when the
  container reports garbage;
- RGB uint8 output (decoder-native BGR through a ``finish`` hook);
- ``stream_batches`` coalesces the stream into exact ``batch``-sized
  (frames, timestamps) pairs for the detection path, and
  ``extract_frames`` gives the whole stream at once (small-object
  detection);
- seeks to single frames by timestamp (``read_frames_at``) for the
  phase-2 candidates that scan retention does not hold.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..utils.config import settings
from ..utils.errors import VideoDecodeError, VideoValidationError
from ..utils.logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class VideoMeta:
    path: str
    fps: float
    total_frames: int
    duration: float
    width: int
    height: int


def probe_video(path: str) -> VideoMeta:
    import cv2

    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise VideoDecodeError(f"cannot open video: {path}")
    try:
        fps = cap.get(cv2.CAP_PROP_FPS)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    finally:
        cap.release()
    if not fps or fps <= 0 or fps > 1000 or not np.isfinite(fps):
        logger.warning("Suspicious FPS %s for %s; falling back to 30", fps, path)
        fps = 30.0
    duration = total / fps if total > 0 else 0.0
    return VideoMeta(str(path), float(fps), total, duration, w, h)


def validate_video(path: str) -> VideoMeta:
    """Format whitelist + size cap."""
    p = Path(path)
    if not p.exists():
        raise VideoValidationError(f"video not found: {path}")
    ext = p.suffix.lstrip(".").lower()
    if ext not in settings.SUPPORTED_FORMATS:
        raise VideoValidationError(
            f"unsupported format '{ext}' (supported: {settings.SUPPORTED_FORMATS})")
    size_gb = p.stat().st_size / (1024 ** 3)
    if size_gb > settings.MAX_VIDEO_SIZE_GB:
        raise VideoValidationError(
            f"video too large: {size_gb:.2f} GB > {settings.MAX_VIDEO_SIZE_GB} GB")
    return probe_video(path)


def _fit_size(w: int, h: int, max_side: int) -> Tuple[int, int]:
    if max(w, h) <= max_side:
        return w, h
    scale = max_side / max(w, h)
    return max(int(round(w * scale)), 1), max(int(round(h * scale)), 1)


def sample_indices(total_frames: int, sample_rate: int,
                   max_frames: int) -> List[int]:
    """Every Nth frame, then a true even spread across the whole video
    under the cap."""
    idxs = list(range(0, max(total_frames, 0), max(sample_rate, 1)))
    if len(idxs) > max_frames:
        pick = np.linspace(0, len(idxs) - 1, max_frames).round().astype(int)
        idxs = [idxs[i] for i in pick]
    return [i for i in idxs if i < total_frames]


class VideoReader:
    """cv2-backed decoder with the JAX package's sampling semantics."""

    def __init__(self, sample_rate: Optional[int] = None,
                 max_frames: Optional[int] = None,
                 max_side: Optional[int] = None) -> None:
        self.sample_rate = sample_rate or settings.FRAME_SAMPLE_RATE
        self.max_frames = max_frames or settings.MAX_FRAMES
        self.max_side = max_side or settings.FRAME_MAX_SIZE

    def extract_frames(self, path: str,
                       sample_rate: Optional[int] = None,
                       max_frames: Optional[int] = None
                       ) -> Tuple[np.ndarray, List[float]]:
        """→ (uint8 [N, H, W, 3] RGB, timestamps seconds): the whole
        sampled stream at once."""
        chunks = list(self.stream_frames(path, sample_rate=sample_rate,
                                         max_frames=max_frames,
                                         chunk=1 << 30))
        frames = np.concatenate([c for c, _ in chunks], axis=0)
        timestamps = [t for _, ts in chunks for t in ts]
        return frames, timestamps

    def stream_frames(self, path: str, chunk: int = 256,
                      sample_rate: Optional[int] = None,
                      max_frames: Optional[int] = None,
                      workers: Optional[int] = None,
                      finish=None):
        """Generator of (uint8 [c, H, W, 3] RGB, timestamps) chunks,
        yielded AS the video decodes — the host side of the
        decode↔embed overlap (``ClipEngine.embed_stream`` consumes this
        through its staging thread, so the device computes chunk *i*
        while the host decodes chunk *i+1*).

        With ``workers > 1`` (``settings.DECODE_WORKERS``) the sampled
        index list splits into contiguous spans, each decoded by its
        own capture on its own thread (cv2 releases the GIL during
        decode — real host parallelism). Chunks arrive in order; span
        queues are bounded so memory stays ≈ workers × queue × chunk.

        Abandoning the generator (``break`` / ``close()``) cancels the
        decode threads promptly: producers re-check a cancel flag while
        blocked on their bounded queues, so abandoning costs ~0.1 s, not
        the remaining decode wall.

        ``finish(bgr_chunk, timestamps) -> array`` is an optional
        per-chunk hook that runs ON the decode threads, receiving
        decoder-native BGR frames (the per-frame BGR→RGB pass is
        skipped) and returning the array to yield. The scan path uses
        it to run the compact-transfer i420 pack N-way parallel on the
        decode threads instead of serialized on the single prefetch
        thread (and to retain the BGR chunk for the reranker) — see
        ``Phase1Scan.frame_embeddings``. The hook must be thread-safe.
        """
        import queue as _queue
        import threading

        import cv2

        from ..utils.memory import decode_budget

        meta = probe_video(path)
        rate = sample_rate or self.sample_rate
        fcap = max_frames or self.max_frames
        tw, th = _fit_size(meta.width, meta.height, self.max_side)
        fcap, rate = decode_budget(fcap, (th, tw), rate)
        idxs = sample_indices(meta.total_frames, rate, fcap)
        if not idxs:
            raise VideoDecodeError(
                f"no sampleable frames in {path} (total={meta.total_frames})")
        # sequential scan beats per-frame seeking for dense sampling;
        # seek only when gaps are large.
        dense = (len(idxs) > meta.total_frames / 20
                 if meta.total_frames else True)
        if workers is None or workers <= 0:
            workers = settings.DECODE_WORKERS
        if workers <= 0:
            # auto: 8 spans minimum (cv2 decode releases the GIL, so
            # spans pipeline even where the container under-reports
            # cores; more spans = smaller first chunk = earlier first
            # batch for the decode∥embed overlap), scaling with the
            # visible cores, capped.
            import os as _os

            workers = max(8, min(32, (_os.cpu_count() or 1) // 4))
        # keep ≥32 frames per span: spans below that fragment the
        # embed batches for no decode win (device cost of partial
        # buckets is ~noise; thread startup isn't)
        workers = max(1, min(workers, len(idxs) // 32 or 1))

        cancel = threading.Event()
        # with a finish hook the chunk stays decoder-native BGR (the
        # hook's pack matrix absorbs the channel swap for free)
        convert_into = (self._resize_into if finish is not None
                        else self._convert_into)

        def safe_put(out_q, item) -> bool:
            """Bounded put that never wedges a producer: re-checks the
            cancel flag while the queue is full so an abandoned
            consumer releases every decode thread within ~0.1 s."""
            while not cancel.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except _queue.Full:
                    continue
            return False

        def decode_span(span: List[int], out_q):
            """Decode one contiguous span of sampled indices into
            chunk-sized (frames, timestamps) tuples on ``out_q``.

            Frames convert DIRECTLY into a preallocated chunk buffer
            (``cv2``'s ``dst=`` writes in place): the list-of-frames +
            ``np.stack`` formulation copied every chunk twice and paid
            first-touch page faults on a fresh ~100 MB array per chunk
            — measured ~2 s of a 600-frame cold scan on this host."""
            cap = cv2.VideoCapture(str(path))
            if not cap.isOpened():
                safe_put(out_q, VideoDecodeError(
                    f"cannot open video: {path}"))
                return
            cap_chunk = min(chunk, len(span))
            buf = np.empty((cap_chunk, th, tw, 3), np.uint8)
            fill = 0
            buf_ts: List[float] = []

            def flush() -> bool:
                nonlocal buf, fill, buf_ts
                ts_list = list(buf_ts)
                part = buf[:fill]
                if finish is not None:
                    # hook runs HERE, on the decode thread: pack /
                    # retain work parallelizes across spans instead of
                    # serializing on the consumer or prefetch thread
                    part = finish(part, ts_list)
                ok = safe_put(out_q, (part, ts_list))
                buf = np.empty((cap_chunk, th, tw, 3), np.uint8)
                fill, buf_ts = 0, []
                return ok

            try:
                if dense:
                    pos = span[0]
                    if pos:
                        cap.set(cv2.CAP_PROP_POS_FRAMES, pos)
                    want = set(span)
                    last = span[-1]
                    while pos <= last and not cancel.is_set():
                        if pos in want:
                            ok, frame = cap.read()
                            if not ok:
                                break
                            convert_into(frame, buf[fill])
                            buf_ts.append(float(pos) / meta.fps)
                            fill += 1
                            if fill >= cap_chunk and not flush():
                                break
                        elif not cap.grab():
                            # grab() advances the decoder without the
                            # BGR retrieve/copy — skipped frames cost
                            # only the (unavoidable) codec work
                            break
                        pos += 1
                else:
                    for idx in span:
                        if cancel.is_set():
                            break
                        cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                        ok, frame = cap.read()
                        if not ok:
                            break
                        convert_into(frame, buf[fill])
                        buf_ts.append(float(idx) / meta.fps)
                        fill += 1
                        if fill >= cap_chunk and not flush():
                            break
                if fill:
                    flush()
            except Exception as exc:  # noqa: BLE001 — surface on consumer
                safe_put(out_q, exc)
            finally:
                cap.release()
                safe_put(out_q, None)

        spans = [list(s) for s in np.array_split(np.asarray(idxs), workers)
                 if len(s)]
        queues = [_queue.Queue(maxsize=4) for _ in spans]
        threads = [threading.Thread(target=decode_span, args=(s, q),
                                    daemon=True, name=f"avede-decode-{i}")
                   for i, (s, q) in enumerate(zip(spans, queues))]
        for t in threads:
            t.start()
        total = 0
        try:
            for q in queues:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    total += len(item[0])
                    yield item
        finally:
            # normal exhaustion OR abandonment (break / close()): flag
            # producers and drain their bounded queues so every decode
            # thread unblocks and exits promptly
            cancel.set()
            for q in queues:
                while True:
                    try:
                        q.get_nowait()
                    except _queue.Empty:
                        break

        if total == 0:
            raise VideoDecodeError(f"decoded zero frames from {path}")
        logger.info("Extracted %d frames from %s (%dx%d, fps=%.2f, "
                    "%d decode workers)", total, path, tw, th, meta.fps,
                    len(spans))

    def stream_batches(self, path: str, batch: int,
                       sample_rate: Optional[int] = None,
                       max_frames: Optional[int] = None):
        """(uint8 [batch, H, W, 3], timestamps) generator with exact
        ``batch``-sized yields (the last may be short): ``stream_frames``
        flushes per decode span, so raw chunks end in odd sizes, and the
        detectors run one batch shape."""
        buf_f: List[np.ndarray] = []
        buf_t: List[float] = []
        have = 0
        for frames, ts in self.stream_frames(path, chunk=batch,
                                             sample_rate=sample_rate,
                                             max_frames=max_frames):
            buf_f.append(frames)
            buf_t.extend(ts)
            have += len(frames)
            while have >= batch:
                whole = (np.concatenate(buf_f, axis=0)
                         if len(buf_f) > 1 else buf_f[0])
                yield whole[:batch], buf_t[:batch]
                buf_f, buf_t = [whole[batch:]], buf_t[batch:]
                have = len(buf_f[0])
        if have:
            yield (np.concatenate(buf_f, axis=0)
                   if len(buf_f) > 1 else buf_f[0]), buf_t

    def expected_sample_count(self, path: str,
                              sample_rate: Optional[int] = None,
                              max_frames: Optional[int] = None) -> int:
        """How many frames a stream over ``path`` will yield (progress
        denominators for streaming consumers) — same sampling math as
        ``stream_frames``."""
        from ..utils.memory import decode_budget

        meta = probe_video(path)
        rate = sample_rate or self.sample_rate
        fcap = max_frames or self.max_frames
        tw, th = _fit_size(meta.width, meta.height, self.max_side)
        fcap, rate = decode_budget(fcap, (th, tw), rate)
        return len(sample_indices(meta.total_frames, rate, fcap))

    def read_frames_at(self, path: str, timestamps: List[float],
                       return_ok: bool = False):
        """Frames at ``timestamps`` (RGB uint8, resized): one capture, a
        seek per timestamp (phase 2 reads its candidate frames this way
        when scan retention does not hold them). Failed reads stay
        zero-filled; ``return_ok=True`` also returns the [N] success mask,
        so callers that cache derived values can leave failures out."""
        import cv2

        meta = probe_video(path)
        tw, th = _fit_size(meta.width, meta.height, self.max_side)
        out = np.zeros((len(timestamps), th, tw, 3), np.uint8)
        ok_mask = np.zeros((len(timestamps),), bool)
        cap = cv2.VideoCapture(str(path))
        if not cap.isOpened():
            raise VideoDecodeError(f"cannot open video: {path}")
        try:
            for n, t in enumerate(timestamps):
                idx = min(max(int(round(t * meta.fps)), 0),
                          max(meta.total_frames - 1, 0))
                cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
                ok, frame = cap.read()
                if ok:
                    self._convert_into(frame, out[n])
                    ok_mask[n] = True
        finally:
            cap.release()
        return (out, ok_mask) if return_ok else out

    def read_frame_at(self, path: str, timestamp: float) -> np.ndarray:
        """Single frame at a timestamp (RGB uint8, resized)."""
        out, ok = self.read_frames_at(path, [timestamp], return_ok=True)
        if not ok[0]:
            raise VideoDecodeError(
                f"cannot read frame at {timestamp}s from {path}")
        return out[0]

    @staticmethod
    def _convert_into(frame_bgr: np.ndarray, out: np.ndarray) -> None:
        """Resize + BGR→RGB straight into ``out`` [th, tw, 3] — no
        intermediate allocation on the per-frame hot path."""
        import cv2

        th, tw = out.shape[:2]
        if frame_bgr.shape[1] != tw or frame_bgr.shape[0] != th:
            frame_bgr = cv2.resize(frame_bgr, (tw, th),
                                   interpolation=cv2.INTER_AREA)
        cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2RGB, dst=out)

    @staticmethod
    def _resize_into(frame_bgr: np.ndarray, out: np.ndarray) -> None:
        """Resize straight into ``out`` keeping decoder-native BGR —
        the per-frame color pass is deleted when a ``finish`` hook
        absorbs the channel order downstream (i420 pack matrix /
        retention's lookup-time conversion)."""
        import cv2

        th, tw = out.shape[:2]
        if frame_bgr.shape[1] != tw or frame_bgr.shape[0] != th:
            cv2.resize(frame_bgr, (tw, th), dst=out,
                       interpolation=cv2.INTER_AREA)
        else:
            np.copyto(out, frame_bgr)
