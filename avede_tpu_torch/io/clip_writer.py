"""Clip extraction: cut [start, end] of a video into its own MP4 (copy
of ``avede_tpu/io/clip_writer.py``).

Output under ``data/clips/clip_<uuid>.mp4``; times clamped to the
probed duration; ``extract_clip_with_padding(ts, duration)`` centers a
window on the hit; non-empty output verified. With ffmpeg on PATH it
stream-copies (re-encode fallback, keeping audio); otherwise cv2
re-encodes video only. cv2 is imported inside the function that cuts.
"""

from __future__ import annotations

import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Dict, Optional

from ..utils.config import settings
from ..utils.errors import ClipExtractionError
from ..utils.logging import get_logger
from .video_reader import probe_video

logger = get_logger(__name__)


class ClipWriter:
    def __init__(self, clip_dir: Optional[str] = None) -> None:
        self.clip_dir = Path(clip_dir or settings.CLIP_DIR)
        self.clip_dir.mkdir(parents=True, exist_ok=True)
        self.ffmpeg = shutil.which("ffmpeg")

    def extract_clip(self, video_path: str, start_time: float,
                     end_time: float,
                     output_name: Optional[str] = None) -> Dict[str, object]:
        meta = probe_video(video_path)
        duration = meta.duration if meta.duration > 0 else end_time
        start = max(0.0, min(float(start_time), duration))
        end = max(start, min(float(end_time), duration))
        if end - start < 1e-3:
            end = min(start + 1.0, duration) if duration > start else start + 1.0

        name = output_name or f"clip_{uuid.uuid4().hex}.mp4"
        if not name.endswith(".mp4"):
            name += ".mp4"
        out = self.clip_dir / name

        if self.ffmpeg:
            self._cut_ffmpeg(video_path, start, end, out)
        else:
            self._cut_cv2(video_path, start, end, out, meta.fps)

        if not out.exists() or out.stat().st_size == 0:
            raise ClipExtractionError(f"clip output empty: {out}")
        return {
            "clip_path": str(out),
            "clip_filename": out.name,
            "start_time": start,
            "end_time": end,
            "duration": end - start,
        }

    def extract_clip_with_padding(self, video_path: str, timestamp: float,
                                  duration: Optional[float] = None
                                  ) -> Dict[str, object]:
        """Center a ``duration``-second window on the hit timestamp."""
        dur = duration if duration is not None else settings.CLIP_DURATION
        half = dur / 2.0
        return self.extract_clip(video_path, timestamp - half,
                                 timestamp + half)

    # ------------------------------------------------------------------
    def _cut_ffmpeg(self, src: str, start: float, end: float,
                    out: Path) -> None:
        base = [self.ffmpeg, "-y", "-ss", f"{start:.3f}", "-to", f"{end:.3f}",
                "-i", str(src)]
        # stream copy first (cheaper); re-encode fallback
        for args in ([*base, "-c", "copy", str(out)],
                     [*base, "-c:v", "libx264", "-preset", "fast", "-crf",
                      "23", "-c:a", "aac", "-movflags", "+faststart",
                      str(out)]):
            try:
                subprocess.run(args, check=True, capture_output=True,
                               timeout=300)
                if out.exists() and out.stat().st_size > 0:
                    return
            except (subprocess.CalledProcessError,
                    subprocess.TimeoutExpired) as exc:
                logger.warning("ffmpeg attempt failed: %s", exc)
        raise ClipExtractionError(f"ffmpeg failed cutting {src}")

    @staticmethod
    def _cut_cv2(src: str, start: float, end: float, out: Path,
                 fps: float) -> None:
        import cv2

        cap = cv2.VideoCapture(str(src))
        if not cap.isOpened():
            raise ClipExtractionError(f"cannot open {src}")
        try:
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            writer = cv2.VideoWriter(str(out),
                                     cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps, (w, h))
            if not writer.isOpened():
                raise ClipExtractionError("cv2 VideoWriter failed to open")
            first = int(start * fps)
            last = int(end * fps)
            cap.set(cv2.CAP_PROP_POS_FRAMES, first)
            for _ in range(max(last - first, 1)):
                ok, frame = cap.read()
                if not ok:
                    break
                writer.write(frame)
            writer.release()
        finally:
            cap.release()

    def list_clips(self) -> list:
        """Names of the ``.mp4`` clips in the clip directory, sorted."""
        return sorted(p.name for p in self.clip_dir.glob("*.mp4"))
