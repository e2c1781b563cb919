"""The REST application (counterpart of ``avede_tpu/api/app.py``): the
routes of the ported ``mvp`` slice, answering as the JAX routes do.

- ``GET  /api/health``  — liveness + error count;
- ``GET  /api/metrics`` — per-operation timings (``utils/metrics.py``);
- ``POST /api/upload``  — multipart ``file`` → ``data/videos/<id>.<ext>``;
- ``POST /api/query``   — ``{video_id, query, mode, top_k, threshold}``;
- ``POST /api/search-library`` — ``{query, top_k, threshold,
  per_video_k, video_ids}`` over every uploaded video;
- ``GET  /api/videos``  — uploaded videos.

aiohttp is imported inside ``create_app`` and the handlers, so importing
this module needs no aiohttp. Model work runs in a thread executor so
the event loop stays responsive; the processor and the library search
are built on first use, on ``cuda`` unless ``device="cpu"`` is passed.
With ``settings.LIBRARY_PREWARM`` a daemon thread indexes the library
at startup.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import threading
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

from ..utils.config import settings
from ..utils.errors import error_log
from ..utils.logging import get_logger
from ..utils.metrics import get_monitor

logger = get_logger(__name__)


class ApiState:
    """Lazily-built processor and library search shared by handlers
    (double-checked under a lock: building them takes seconds, and the
    prewarm thread and the first requests must not build two)."""

    def __init__(self, processor=None, device: Optional[str] = None
                 ) -> None:
        self._processor = processor
        self._library = None
        self._device = device
        self._lock = threading.Lock()

    @property
    def processor(self):
        if self._processor is None:
            with self._lock:
                if self._processor is None:
                    from ..services.video_processor import VideoProcessor

                    self._processor = VideoProcessor(device=self._device)
        return self._processor

    @property
    def library(self):
        """One ``LibrarySearch`` per server: its device index is state
        that must outlive requests (a per-request instance would rebuild
        the whole table on every search)."""
        if self._library is None:
            processor = self.processor   # takes the lock itself
            with self._lock:
                if self._library is None:
                    from ..services.library_search import LibrarySearch

                    self._library = LibrarySearch(processor.phase1)
        return self._library


def _json(data: Dict[str, Any], status: int = 200):
    from aiohttp import web

    return web.json_response(data, status=status)


async def _run_blocking(fn, *args, **kwargs):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        None, functools.partial(fn, *args, **kwargs))


def _parse_query(body: Any) -> Optional[Dict[str, Any]]:
    """Validate a ``/api/query`` body (the fields and defaults of the
    JAX package's ``QueryRequest``); None when invalid."""
    if not isinstance(body, dict):
        return None
    vid, q = body.get("video_id"), body.get("query")
    if not isinstance(vid, str) or not isinstance(q, str):
        return None
    mode = body.get("mode", "mvp")
    top_k, thr = body.get("top_k"), body.get("threshold")
    if not isinstance(mode, str) \
            or (top_k is not None and (isinstance(top_k, bool)
                                       or not isinstance(top_k, int))) \
            or (thr is not None and (isinstance(thr, bool)
                                     or not isinstance(thr, (int, float)))):
        return None
    return {"video_id": vid, "query": q, "mode": mode, "top_k": top_k,
            "threshold": None if thr is None else float(thr)}


async def health(request):
    return _json({"status": "healthy", "service": "video-event-detection",
                  "errors": error_log.health()["total"]})


async def metrics(request):
    return _json(get_monitor().summary())


def _parse_library(body: Any) -> Optional[Dict[str, Any]]:
    """Validate a ``/api/search-library`` body; None when invalid."""
    if not isinstance(body, dict):
        return None
    q = body.get("query")
    if not q or not isinstance(q, str):
        return None
    out: Dict[str, Any] = {"query": q}
    for name, default in (("top_k", 10), ("per_video_k", 3)):
        v = body.get(name, default)
        if isinstance(v, bool) or not isinstance(v, int):
            return None
        out[name] = v
    thr, ids = body.get("threshold"), body.get("video_ids")
    if thr is not None and (isinstance(thr, bool)
                            or not isinstance(thr, (int, float))):
        return None
    if ids is not None and (not isinstance(ids, list) or not all(
            isinstance(v, str) for v in ids)):
        return None
    out["threshold"] = None if thr is None else float(thr)
    out["video_ids"] = ids
    return out


async def search_library(request):
    """Cross-video search over every uploaded video."""
    state: ApiState = request.app["state"]
    try:
        body = await request.json()
    except ValueError:
        return _json({"detail": "invalid JSON body"}, 422)
    req = _parse_library(body)
    if req is None:
        return _json({"detail": "body needs a non-empty string query; "
                                "optional int top_k and per_video_k, "
                                "number threshold, list of string "
                                "video_ids"}, 422)
    searcher = state.library
    with get_monitor().track("library_search"):
        out = await _run_blocking(
            searcher.search, req["query"], top_k=req["top_k"],
            threshold=req["threshold"], per_video_k=req["per_video_k"],
            video_ids=req["video_ids"])
    return _json({"status": "completed", **out})


async def upload_video(request):
    reader = await request.multipart()
    field = None
    async for part in reader:
        if part.name == "file":
            field = part
            break
    if field is None:
        return _json({"detail": "missing 'file' field"}, 422)
    filename = field.filename or "upload.mp4"
    ext = Path(filename).suffix.lstrip(".").lower()
    if ext not in settings.SUPPORTED_FORMATS:
        return _json({"detail": f"unsupported format '{ext}'"}, 400)
    video_id = uuid.uuid4().hex
    dest = Path(settings.VIDEO_DIR)
    dest.mkdir(parents=True, exist_ok=True)
    path = dest / f"{video_id}.{ext}"
    size = 0
    max_bytes = int(settings.MAX_VIDEO_SIZE_GB * (1024 ** 3))
    with path.open("wb") as f:
        while True:
            chunk = await field.read_chunk(1 << 20)
            if not chunk:
                break
            size += len(chunk)
            if size > max_bytes:
                f.close()
                path.unlink(missing_ok=True)
                return _json({"detail": "file too large"}, 400)
            f.write(chunk)
    return _json({"video_id": video_id, "status": "uploaded",
                  "filename": filename, "path": str(path),
                  "format": ext, "size": size})


async def query(request):
    state: ApiState = request.app["state"]
    try:
        body = await request.json()
    except ValueError:
        return _json({"detail": "invalid JSON body"}, 422)
    req = _parse_query(body)
    if req is None:
        return _json({"detail": "body needs string video_id and query; "
                                "optional string mode, int top_k, "
                                "number threshold"}, 422)
    try:
        video = state.processor.resolve_video(req["video_id"])
    except Exception:  # noqa: BLE001 — any lookup failure is a 404
        return _json({"detail": f"video not found: {req['video_id']}"}, 404)
    out = await _run_blocking(
        state.processor.process_query, video, req["query"],
        mode=req["mode"], top_k=req["top_k"], threshold=req["threshold"],
        video_id=req["video_id"])
    return _json(out, 200 if out.get("status") != "error" else 500)


async def list_videos(request):
    base = Path(settings.VIDEO_DIR)
    videos = []
    if base.exists():
        for p in sorted(base.glob("*")):
            ext = p.suffix.lower().lstrip(".")
            if p.is_file() and ext in settings.SUPPORTED_FORMATS:
                st = p.stat()
                videos.append({"video_id": p.stem, "filename": p.name,
                               "format": ext, "size": st.st_size,
                               "created": st.st_ctime})
    return _json({"videos": videos})


def create_app(processor=None, device: Optional[str] = None):
    """The aiohttp application; ``processor`` (a ``VideoProcessor``) is
    built on first use on ``device`` when not given."""
    from aiohttp import web

    settings.ensure_dirs()
    app = web.Application(client_max_size=int(
        settings.MAX_VIDEO_SIZE_GB * (1024 ** 3)))
    app["state"] = ApiState(processor, device)
    if settings.LIBRARY_PREWARM:
        # embed + index the existing library off the serving thread so
        # the FIRST /api/search-library doesn't pay the whole build
        def _prewarm(state=app["state"]):
            try:
                n = state.library.prewarm()
                logger.info("Library prewarm: %d videos indexed", n)
            except Exception as exc:  # noqa: BLE001 — best effort
                logger.warning("Library prewarm failed: %s", exc)

        threading.Thread(target=_prewarm, daemon=True,
                         name="avede-lib-prewarm").start()
    app.add_routes([
        web.get("/api/health", health),
        web.get("/api/metrics", metrics),
        web.post("/api/upload", upload_video),
        web.post("/api/query", query),
        web.post("/api/search-library", search_library),
        web.get("/api/videos", list_videos),
    ])
    return app


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="AVEDE REST API, PyTorch/CUDA port")
    parser.add_argument("--host", default=settings.API_HOST)
    parser.add_argument("--port", type=int, default=settings.API_PORT)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from aiohttp import web

    logger.info("Starting API on %s:%d", args.host, args.port)
    web.run_app(create_app(device=args.device), host=args.host,
                port=args.port, print=lambda *a: None)


if __name__ == "__main__":
    main()
