"""The REST application (counterpart of ``avede_tpu/api/app.py``): the
routes of the ported slices, answering as the JAX routes do.

- ``GET  /api/health``  — liveness + error count;
- ``GET  /api/metrics`` — per-operation timings (``utils/metrics.py``);
- ``POST /api/upload``  — multipart ``file`` → ``data/videos/<id>.<ext>``;
- ``POST /api/query``   — ``{video_id, query, mode, top_k, threshold}``;
- ``POST /api/search-library`` — ``{query, top_k, threshold,
  per_video_k, video_ids}`` over every uploaded video;
- ``POST /api/unlimited-detection`` — ``{video_id, object_queries,
  detection_mode, matching_precision, top_k, confidence_threshold,
  debug_mode}``: open-vocabulary detection over the video;
- ``POST /api/small-object-detection`` — ``{video_id, object_queries,
  enable_background_independence, enable_adaptive_thresholds,
  enable_rpn, min_object_size, max_object_size, confidence_threshold,
  top_k, detection_mode, debug_mode}``: tiled small-object detection;
- ``POST /api/background-independence`` — ``{video_id, object_queries,
  background_removal_strength, contrastive_learning_enabled,
  shape_descriptor_enabled, confidence_threshold, top_k, debug_mode}``:
  background-independent matching;
- ``POST /api/image-matching`` — multipart: a ``reference_image`` file
  and the fields ``video_id, matching_mode, target_class, top_k,
  similarity_threshold, debug_mode``: the reference image's matches in
  the video;
- ``POST /api/image-matching-by-id`` — ``{video_id, matching_mode, ...}``
  with ``image_id`` (an uploaded image) in the body or the query string;
- ``POST /api/enhanced-person-detection`` — ``{video_id, image_id,
  similarity_threshold, frame_skip, temporal_consistency,
  save_annotated_frames}``: the person in an uploaded image found across
  the video;
- ``POST /api/upload-image`` — multipart ``file`` →
  ``data/images/<id>.<ext>``;
- ``GET  /api/download/{clip_filename}`` — a cut clip (no path
  separators or ``..`` in the name);
- ``GET  /api/videos``, ``GET /api/clips``, ``GET /api/images`` —
  uploaded videos, cut clips, uploaded images;
- ``GET  /api/matching-modes`` — image-matching modes and their default
  thresholds;
- ``GET  /api/detection-modes`` — detection modes and precisions;
- ``GET  /api/small-object-capabilities`` — the small-object path's
  settings;
- ``GET  /`` — the service's name, version and endpoint map; ``GET /ui``
  — the built-in single-page UI.

Request bodies are coerced as the JAX package's pydantic 2 models do in
their lax mode (``"5"``, ``5.0`` and ``true`` are the int 5, 5 and 1;
``"0.3"`` is the float 0.3; ``"yes"`` and ``1`` are True, ``2`` is
refused), by hand: the machine with the card has no pydantic; multipart
fields arrive as strings and go through the same coercion. Every answer
carries the ``Access-Control-Allow-*`` headers of
``settings.CORS_ORIGINS``, and OPTIONS is answered for every path.

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
import re
import threading
import uuid
from pathlib import Path
from typing import Any, Dict, Optional

from .. import __version__
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


_INVALID = object()
_INT_TEXT = re.compile(r"[+-]?[0-9]+(?:_[0-9]+)*(?:\.0+)?")
_TRUE = ("1", "on", "t", "true", "y", "yes")
_FALSE = ("0", "off", "f", "false", "n", "no")


def _lax_int(v: Any) -> Any:
    """pydantic 2's lax ``int``: ints, bools, integral finite floats and
    decimal strings (whitespace, sign, ``_`` between digits and a
    ``.0`` tail allowed) → int; anything else → ``_INVALID``."""
    if isinstance(v, int):
        return int(v)
    if isinstance(v, float):
        return int(v) if v == v and abs(v) != float("inf") \
            and v.is_integer() else _INVALID
    if isinstance(v, str):
        t = v.strip()
        if _INT_TEXT.fullmatch(t):
            return int(t.split(".")[0].replace("_", ""))
    return _INVALID


def _lax_float(v: Any) -> Any:
    """pydantic 2's lax ``float``: numbers, bools and ASCII numeric
    strings (``inf`` and ``nan`` included) → float; else ``_INVALID``."""
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str) and v.isascii():
        try:
            return float(v)
        except ValueError:
            pass
    return _INVALID


def _lax_bool(v: Any) -> Any:
    """pydantic 2's lax ``bool``: bools, 0/1 as int or float, and the
    words it knows in any case → bool; else ``_INVALID``."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str):
        t = v.strip().lower()
        if t in _TRUE or t in _FALSE:
            return t in _TRUE
    return _INVALID


def _lax_fields(body: Any, fields) -> Optional[Dict[str, Any]]:
    """Validate a JSON body against ``(name, kind, default)`` fields as a
    pydantic 2 model in lax mode would (``default`` ``_INVALID`` marks a
    required field; an explicit null is kept for ``str?``, ``int?`` and
    ``float?``);
    None when invalid. Unknown keys are ignored."""
    if not isinstance(body, dict):
        return None
    out: Dict[str, Any] = {}
    for name, kind, default in fields:
        if name not in body:
            if default is _INVALID:
                return None
            out[name] = default
            continue
        v = body[name]
        if kind in ("str?", "int?", "float?") and v is None:
            out[name] = None
            continue
        if kind in ("str", "str?"):
            v = v if isinstance(v, str) else _INVALID
        elif kind == "str|list[str]":
            v = v if isinstance(v, str) or (isinstance(v, list) and all(
                isinstance(x, str) for x in v)) else _INVALID
        elif kind == "int?":
            v = _lax_int(v)
        elif kind in ("float", "float?"):
            v = _lax_float(v)
        elif kind == "bool":
            v = _lax_bool(v)
        if v is _INVALID:
            return None
        out[name] = v
    return out


# the fields of the JAX package's QueryRequest, UnlimitedDetectionRequest,
# SmallObjectDetectionRequest, BackgroundIndependenceRequest,
# ImageMatchingRequest and PersonSearchRequest
_QUERY_FIELDS = (("video_id", "str", _INVALID), ("query", "str", _INVALID),
                 ("mode", "str", "mvp"), ("top_k", "int?", None),
                 ("threshold", "float?", None))
_DETECTION_FIELDS = (("video_id", "str", _INVALID),
                     ("object_queries", "str|list[str]", _INVALID),
                     ("detection_mode", "str", "hybrid"),
                     ("matching_precision", "str", "balanced"),
                     ("top_k", "int?", 10),
                     ("confidence_threshold", "float?", 0.3),
                     ("debug_mode", "bool", False))
_SMALL_OBJECT_FIELDS = (("video_id", "str", _INVALID),
                        ("object_queries", "str|list[str]", _INVALID),
                        ("enable_background_independence", "bool", True),
                        ("enable_adaptive_thresholds", "bool", True),
                        ("enable_rpn", "bool", True),
                        ("min_object_size", "int?", 16),
                        ("max_object_size", "int?", 128),
                        ("confidence_threshold", "float?", 0.2),
                        ("top_k", "int?", 20),
                        ("detection_mode", "str", "clip"),
                        ("debug_mode", "bool", False))
_BACKGROUND_FIELDS = (("video_id", "str", _INVALID),
                      ("object_queries", "str|list[str]", _INVALID),
                      ("background_removal_strength", "float", 0.8),
                      ("contrastive_learning_enabled", "bool", True),
                      ("shape_descriptor_enabled", "bool", True),
                      ("confidence_threshold", "float?", 0.3),
                      ("top_k", "int?", 15),
                      ("debug_mode", "bool", False))
_IMAGE_MATCHING_FIELDS = (("video_id", "str", _INVALID),
                          ("matching_mode", "str", "traditional"),
                          ("target_class", "str?", None),
                          ("top_k", "int?", None),
                          ("similarity_threshold", "float?", None),
                          ("debug_mode", "bool", False))
_PERSON_FIELDS = (("video_id", "str", _INVALID),
                  ("image_id", "str", _INVALID),
                  ("similarity_threshold", "float?", None),
                  ("frame_skip", "int?", None),
                  ("temporal_consistency", "bool", True),
                  ("save_annotated_frames", "bool", False))
_IMAGE_MATCHING_DETAIL = ("fields need string video_id; optional strings "
                          "matching_mode and target_class, integer top_k, "
                          "number similarity_threshold, boolean debug_mode")
_QUERIES_DETAIL = ("body needs string video_id and object_queries (a "
                   "string or a list of strings)")


async def _parse(request, fields, detail: str):
    """(the body's fields, None), or (None, a 422 answer) where the body
    is not JSON or not valid for ``fields``."""
    try:
        body = await request.json()
    except ValueError:
        return None, _json({"detail": "invalid JSON body"}, 422)
    req = _lax_fields(body, fields)
    if req is None:
        return None, _json({"detail": detail}, 422)
    return req, None


async def builtin_ui(request):
    from aiohttp import web

    from ..web.builtin import INDEX_HTML

    return web.Response(text=INDEX_HTML, content_type="text/html")


async def root(request):
    return _json({
        "message": "Video Event Detection API (TPU-native)",
        "version": __version__,
        "endpoints": {
            "/api/upload": "POST - Upload video file",
            "/api/query": "POST - Process event detection query",
            "/api/unlimited-detection": "POST - Unlimited object detection",
            "/api/small-object-detection": "POST - Small-object detection",
            "/api/background-independence":
                "POST - Background-independent detection",
            "/api/image-matching": "POST - Image matching (multipart)",
            "/api/image-matching-by-id": "POST - Image matching by image_id",
            "/api/enhanced-person-detection":
                "POST - Person re-identification",
            "/api/upload-image": "POST - Upload reference image",
            "/api/download/{clip_filename}": "GET - Download extracted clip",
            "/api/health": "GET - Health check",
            "/api/videos": "GET - List videos",
            "/api/clips": "GET - List clips",
            "/api/images": "GET - List reference images",
            "/api/matching-modes": "GET - Matching modes",
            "/api/detection-modes": "GET - Detection modes",
            "/api/small-object-capabilities":
                "GET - Small-object capabilities",
            "/api/metrics": "GET - Runtime metrics",
        },
    })


async def health(request):
    return _json({"status": "healthy", "service": "video-event-detection",
                  "errors": error_log.health()["total"]})


async def metrics(request):
    return _json(get_monitor().summary())


def _python_int(v: Any) -> Any:
    """``int(v)`` as the JAX route applies it (``"5"``, ``5.7`` and
    ``true`` are 5, 5 and 1); ``_INVALID`` where it raises."""
    try:
        return int(v)
    except (TypeError, ValueError, OverflowError):
        return _INVALID


def _parse_library(body: Any) -> Optional[Dict[str, Any]]:
    """Validate a ``/api/search-library`` body: a non-empty string query,
    ``top_k`` and ``per_video_k`` through ``int()`` as the JAX route
    does, a number threshold and a list of string video ids; None when
    invalid (where the JAX route's ``int()`` raises it answers 500)."""
    if not isinstance(body, dict):
        return None
    q = body.get("query")
    if not q or not isinstance(q, str):
        return None
    out: Dict[str, Any] = {"query": q}
    for name, default in (("top_k", 10), ("per_video_k", 3)):
        v = _python_int(body.get(name, default))
        if v is _INVALID:
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
                                "optional integer top_k and per_video_k, "
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


def _resolve_or_none(state: ApiState, video_id: str) -> Optional[str]:
    try:
        return state.processor.resolve_video(video_id)
    except Exception:  # noqa: BLE001 — any lookup failure is a 404
        return None


async def query(request):
    state: ApiState = request.app["state"]
    req, refused = await _parse(
        request, _QUERY_FIELDS, "body needs string video_id and query; "
        "optional string mode, integer top_k, number threshold")
    if refused is not None:
        return refused
    video = _resolve_or_none(state, req["video_id"])
    if video is None:
        return _json({"detail": f"video not found: {req['video_id']}"}, 404)
    with get_monitor().track("query", mode=req["mode"]):
        out = await _run_blocking(
            state.processor.process_query, video, req["query"],
            mode=req["mode"], top_k=req["top_k"],
            threshold=req["threshold"], video_id=req["video_id"])
    return _json(out, 200 if out.get("status") != "error" else 500)


async def unlimited_detection(request):
    """Open-vocabulary detection of ``object_queries`` over a video."""
    state: ApiState = request.app["state"]
    req, refused = await _parse(
        request, _DETECTION_FIELDS, _QUERIES_DETAIL + "; optional string "
        "detection_mode and matching_precision, integer top_k, number "
        "confidence_threshold, boolean debug_mode")
    if refused is not None:
        return refused
    video = _resolve_or_none(state, req["video_id"])
    if video is None:
        return _json({"detail": f"video not found: {req['video_id']}"}, 404)
    with get_monitor().track("unlimited_detection",
                             mode=req["detection_mode"]):
        out = await _run_blocking(
            state.processor.process_unlimited_detection, video,
            req["object_queries"], detection_mode=req["detection_mode"],
            matching_precision=req["matching_precision"],
            top_k=req["top_k"],
            confidence_threshold=req["confidence_threshold"],
            video_id=req["video_id"])
    return _json(out, 200 if out.get("status") != "error" else 500)


async def small_object_detection(request):
    """Tiled small-object detection of ``object_queries`` over a video."""
    state: ApiState = request.app["state"]
    req, refused = await _parse(
        request, _SMALL_OBJECT_FIELDS, _QUERIES_DETAIL + "; optional "
        "booleans enable_background_independence, "
        "enable_adaptive_thresholds, enable_rpn and debug_mode, integers "
        "min_object_size, max_object_size and top_k, number "
        "confidence_threshold, string detection_mode")
    if refused is not None:
        return refused
    video = _resolve_or_none(state, req["video_id"])
    if video is None:
        return _json({"detail": f"video not found: {req['video_id']}"}, 404)
    with get_monitor().track("small_object_detection"):
        out = await _run_blocking(
            state.processor.process_small_object_detection, video,
            req["object_queries"], video_id=req["video_id"],
            min_object_size=req["min_object_size"],
            max_object_size=req["max_object_size"],
            confidence_threshold=req["confidence_threshold"],
            top_k=req["top_k"],
            enable_background_independence=req[
                "enable_background_independence"],
            enable_adaptive_thresholds=req["enable_adaptive_thresholds"],
            enable_rpn=req["enable_rpn"],
            detection_mode=req["detection_mode"])
    return _json(out, 200 if out.get("status") != "error" else 500)


async def background_independence(request):
    """Background-independent matching of ``object_queries`` over a
    video."""
    state: ApiState = request.app["state"]
    req, refused = await _parse(
        request, _BACKGROUND_FIELDS, _QUERIES_DETAIL + "; optional numbers "
        "background_removal_strength and confidence_threshold, integer "
        "top_k, booleans contrastive_learning_enabled, "
        "shape_descriptor_enabled and debug_mode")
    if refused is not None:
        return refused
    video = _resolve_or_none(state, req["video_id"])
    if video is None:
        return _json({"detail": f"video not found: {req['video_id']}"}, 404)
    with get_monitor().track("background_independence"):
        out = await _run_blocking(
            state.processor.process_background_independence, video,
            req["object_queries"], video_id=req["video_id"],
            background_removal_strength=req["background_removal_strength"],
            confidence_threshold=req["confidence_threshold"],
            top_k=req["top_k"])
    return _json(out, 200 if out.get("status") != "error" else 500)


def _decode_image(data: bytes):
    """Encoded image bytes → uint8 RGB, or None where cv2 cannot decode
    them."""
    import cv2
    import numpy as np

    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _load_image(path: str):
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _find_image(image_id: str) -> Optional[str]:
    for p in Path(settings.IMAGE_DIR).glob(f"{image_id}.*"):
        return str(p)
    return None


async def _match_image(state: ApiState, req: Dict[str, Any], image):
    """Run image matching for validated fields → the answer (404 for an
    unknown video, 500 for an error envelope)."""
    video = _resolve_or_none(state, req["video_id"])
    if video is None:
        return _json({"detail": f"video not found: {req['video_id']}"}, 404)
    with get_monitor().track("image_matching", mode=req["matching_mode"]):
        out = await _run_blocking(
            state.processor.process_image_matching, video, image,
            matching_mode=req["matching_mode"],
            target_class=req["target_class"], top_k=req["top_k"],
            similarity_threshold=req["similarity_threshold"],
            video_id=req["video_id"])
    return _json(out, 200 if out.get("status") != "error" else 500)


async def image_matching(request):
    """Multipart: the fields and a ``reference_image`` file."""
    state: ApiState = request.app["state"]
    reader = await request.multipart()
    fields: Dict[str, Any] = {}
    image = None
    async for part in reader:
        if part.name == "reference_image":
            data = bytearray()
            while True:
                chunk = await part.read_chunk(1 << 20)
                if not chunk:
                    break
                data.extend(chunk)
            image = _decode_image(bytes(data))
        else:
            fields[part.name] = (await part.read()).decode()
    if image is None:
        return _json({"detail": "missing or undecodable reference_image"}, 422)
    req = _lax_fields(fields, _IMAGE_MATCHING_FIELDS)
    if req is None:
        return _json({"detail": _IMAGE_MATCHING_DETAIL}, 422)
    return await _match_image(state, req, image)


async def image_matching_by_id(request):
    """JSON fields; ``image_id`` of an uploaded image in the body or the
    query string."""
    state: ApiState = request.app["state"]
    try:
        body = await request.json()
    except ValueError:
        return _json({"detail": "invalid JSON body"}, 422)
    image_id = (body.pop("image_id", None) if isinstance(body, dict)
                else None) or request.query.get("image_id")
    if not image_id:
        return _json({"detail": "missing image_id"}, 422)
    req = _lax_fields(body, _IMAGE_MATCHING_FIELDS)
    if req is None:
        return _json({"detail": _IMAGE_MATCHING_DETAIL}, 422)
    img_path = _find_image(image_id)
    if img_path is None:
        return _json({"detail": f"image not found: {image_id}"}, 404)
    image = _load_image(img_path)
    if image is None:
        return _json({"detail": f"cannot decode image: {image_id}"}, 400)
    return await _match_image(state, req, image)


async def enhanced_person_detection(request):
    """JSON fields; the person of the uploaded image ``image_id`` searched
    for across the video (404 for an unknown video or image, 400 for an
    image that does not decode)."""
    state: ApiState = request.app["state"]
    req, bad = await _parse(
        request, _PERSON_FIELDS, "body needs string video_id and image_id; "
        "optional number similarity_threshold, integer frame_skip, "
        "booleans temporal_consistency and save_annotated_frames")
    if bad is not None:
        return bad
    video = _resolve_or_none(state, req["video_id"])
    if video is None:
        return _json({"detail": f"video not found: {req['video_id']}"}, 404)
    img_path = _find_image(req["image_id"])
    if img_path is None:
        return _json({"detail": f"image not found: {req['image_id']}"}, 404)
    image = _load_image(img_path)
    if image is None:
        return _json({"detail": f"cannot decode image: {req['image_id']}"},
                     400)
    with get_monitor().track("person_detection"):
        out = await _run_blocking(
            state.processor.process_person_search, video, image,
            similarity_threshold=req["similarity_threshold"],
            frame_skip=req["frame_skip"],
            temporal_consistency=req["temporal_consistency"],
            save_annotated_frames=req["save_annotated_frames"])
    return _json(out, 200 if out.get("status") != "error" else 500)


async def upload_image(request):
    reader = await request.multipart()
    field = None
    async for part in reader:
        if part.name == "file":
            field = part
            break
    if field is None:
        return _json({"detail": "missing 'file' field"}, 422)
    filename = field.filename or "image.jpg"
    ext = Path(filename).suffix.lstrip(".").lower()
    if ext not in ("jpg", "jpeg", "png", "bmp", "webp"):
        return _json({"detail": f"unsupported image format '{ext}'"}, 400)
    image_id = uuid.uuid4().hex
    dest = Path(settings.IMAGE_DIR)
    dest.mkdir(parents=True, exist_ok=True)
    path = dest / f"{image_id}.{ext}"
    data = bytearray()
    while True:
        chunk = await field.read_chunk(1 << 20)
        if not chunk:
            break
        data.extend(chunk)
    path.write_bytes(data)
    return _json({"image_id": image_id, "status": "uploaded",
                  "filename": filename, "path": str(path), "size": len(data)})


async def download_clip(request):
    from aiohttp import web

    name = request.match_info["clip_filename"]
    path = Path(settings.CLIP_DIR) / name
    # no path traversal: a bare file name inside CLIP_DIR only
    if "/" in name or ".." in name or not path.exists():
        return _json({"detail": "Clip not found"}, 404)
    return web.FileResponse(path, headers={
        "Content-Type": "video/mp4",
        "Content-Disposition": f'attachment; filename="{name}"'})


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


async def list_clips(request):
    base = Path(settings.CLIP_DIR)
    clips = []
    if base.exists():
        for p in sorted(base.glob("*.mp4")):
            st = p.stat()
            clips.append({"clip_id": p.stem, "filename": p.name,
                          "size": st.st_size, "created": st.st_ctime})
    return _json({"clips": clips})


async def list_images(request):
    base = Path(settings.IMAGE_DIR)
    images = []
    if base.exists():
        for p in sorted(base.glob("*")):
            if p.is_file():
                st = p.stat()
                images.append({"image_id": p.stem, "filename": p.name,
                               "size": st.st_size, "created": st.st_ctime})
    return _json({"images": images})


async def matching_modes(request):
    descriptions = {
        "traditional": "Multi-stage pHash → CLIP → SSIM → features pipeline",
        "object_focused": "Detector-guided: match objects, ignore background",
        "cross_domain": "Color↔grayscale / lighting-invariant features",
        "hybrid": "Object + cross-domain + traditional ensemble",
        "smart_match": "Image-analysis-driven adaptive ensemble",
        "fast_match": "Single-stage CLIP-only (fastest)",
    }
    return _json({"matching_modes": [
        {"mode": m, "description": descriptions.get(m, ""),
         "default_threshold": settings.MATCHING_THRESHOLDS.get(m)}
        for m in settings.MATCHING_MODES]})


async def detection_modes(request):
    descriptions = {
        "hybrid": "OWL-ViT ∥ CLIP-grid fusion (best coverage)",
        "owlvit": "Open-vocabulary transformer detection",
        "clip": "CLIP sliding-grid similarity detection",
        "yolo_enhanced": "YOLO detection + CLIP semantic filtering",
    }
    return _json({
        "detection_modes": [
            {"mode": m, "description": descriptions.get(m, "")}
            for m in settings.DETECTION_MODES],
        "matching_precisions": [
            {"precision": k, "confidence_threshold": v}
            for k, v in settings.MATCHING_PRECISIONS.items()],
    })


async def small_object_capabilities(request):
    return _json({
        "capabilities": {
            "tiled_inference": {
                "description": "Fixed-grid tiling of high-resolution frames "
                               "with overlap, batched through the detector "
                               "on-device, merged by padded NMS",
                "tile_size": settings.TILE_SIZE,
                "tile_overlap": settings.TILE_OVERLAP,
            },
            "adaptive_thresholds": {
                "description": "Size-category and context-aware confidence "
                               "thresholds",
                "size_categories": settings.SMALL_OBJECT_SIZES,
                "base_thresholds": settings.SMALL_OBJECT_BASE_THRESHOLDS,
                "confidence_boosts": settings.SMALL_OBJECT_BOOSTS,
            },
            "region_proposals": {
                "description": "Saliency + motion region proposals for "
                               "focused small-object scanning",
                "max_proposals": settings.RPN_MAX_PROPOSALS,
            },
            "background_independence": {
                "description": "Segmentation-based background removal with "
                               "shape descriptors + multi-colorspace "
                               "embeddings",
            },
        },
        "multi_scale_weights": settings.MULTI_SCALE_WEIGHTS,
    })


def _cors_middleware():
    """Answer OPTIONS and add the ``Access-Control-Allow-*`` headers of
    ``settings.CORS_ORIGINS`` to every answer."""
    from aiohttp import web

    @web.middleware
    async def cors_middleware(request, handler):
        if request.method == "OPTIONS":
            resp = web.Response()
        else:
            resp = await handler(request)
        resp.headers["Access-Control-Allow-Origin"] = ",".join(
            settings.CORS_ORIGINS)
        resp.headers["Access-Control-Allow-Methods"] = "GET,POST,OPTIONS"
        resp.headers["Access-Control-Allow-Headers"] = "Content-Type"
        return resp

    return cors_middleware


def create_app(processor=None, device: Optional[str] = None):
    """The aiohttp application; ``processor`` (a ``VideoProcessor``) is
    built on first use on ``device`` when not given."""
    from aiohttp import web

    settings.ensure_dirs()
    app = web.Application(middlewares=[_cors_middleware()],
                          client_max_size=int(
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
        web.get("/", root),
        web.get("/ui", builtin_ui),
        web.get("/api/health", health),
        web.get("/api/metrics", metrics),
        web.post("/api/upload", upload_video),
        web.post("/api/query", query),
        web.post("/api/search-library", search_library),
        web.post("/api/unlimited-detection", unlimited_detection),
        web.post("/api/small-object-detection", small_object_detection),
        web.post("/api/background-independence", background_independence),
        web.post("/api/image-matching", image_matching),
        web.post("/api/image-matching-by-id", image_matching_by_id),
        web.post("/api/enhanced-person-detection",
                 enhanced_person_detection),
        web.post("/api/upload-image", upload_image),
        web.get("/api/download/{clip_filename}", download_clip),
        web.get("/api/videos", list_videos),
        web.get("/api/clips", list_clips),
        web.get("/api/images", list_images),
        web.get("/api/matching-modes", matching_modes),
        web.get("/api/detection-modes", detection_modes),
        web.get("/api/small-object-capabilities", small_object_capabilities),
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

    from ..utils.system import ResourceMonitor, optimized_context

    logger.info("Starting API on %s:%d", args.host, args.port)
    monitor = ResourceMonitor().start()
    try:
        with optimized_context():
            web.run_app(create_app(device=args.device), host=args.host,
                        port=args.port, print=lambda *a: None)
    finally:
        monitor.stop()


if __name__ == "__main__":
    main()
