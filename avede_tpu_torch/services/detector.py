"""Detection engines (counterpart of ``avede_tpu/services/detector.py``):
the YOLO service, the CLIP-grid open-vocabulary detector and the CLIP
crop embeddings.

- ``YoloService`` runs frames through forward, decode and padded
  per-class NMS on the device, ``YOLO_CHUNK`` frames a call (a long video
  goes to the card in chunks, not in one allocation), with a top-400
  pre-selection by score first, so NMS never builds an 8400 × 8400 IoU
  matrix.
- ``ClipGridDetector`` encodes all G × G cells of all frames of a batch
  in one CLIP tower call (flash attention at L = 50 in every layer).
- ``extract_object_embeddings`` embeds box crops with the shared CLIP
  engine (``ClipEngine.embed_images``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.convert import load_params
from ..models.yolo import (COCO_CLASSES, YoloConfig, YoloV8,
                           decode_predictions, init_yolo, resize_bilinear,
                           yolov8n)
from ..ops.kernels import topk_scores
from ..ops.nms import nms_per_class
from ..ops.preprocess import clip_preprocess
from ..parallel.embed import ClipEngine
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.platform import resolve_device, with_compute_dtype
from ..utils.trace import trace

logger = get_logger(__name__)

# frames a YOLO call takes to the card at once (image query's
# ``object_focused`` passes every sampled frame of a video; one batch
# would hold the activations of all of them at 640 px)
YOLO_CHUNK = 64


class YoloService:
    """Batched YOLOv8 detection with decode and NMS on the device.

    ``device`` defaults to ``cuda`` (raises without a card). Weights:
    ``state_dict`` (``models.convert.params_from_jax`` of a Flax
    variables dict), else ``settings.YOLO_WEIGHTS``, else random from
    seed 0."""

    def __init__(self, cfg: Optional[YoloConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 class_names: Optional[Sequence[str]] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg or with_compute_dtype(yolov8n(), self.device)
        model = init_yolo(self.cfg, seed=0)
        if state_dict is None and settings.YOLO_WEIGHTS:
            state_dict = load_params(settings.YOLO_WEIGHTS)
            logger.info("YOLO weights loaded from %s", settings.YOLO_WEIGHTS)
        elif state_dict is None:
            logger.info("YOLOv8%s randomly initialised (no checkpoint)",
                        self.cfg.scale)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model: YoloV8 = model.to(self.device, self.cfg.torch_dtype).eval()
        self.class_names = list(class_names or COCO_CLASSES)[
            : self.cfg.num_classes]

    @torch.inference_mode()
    def raw_outputs(self, frames: np.ndarray):
        """uint8 [B, H, W, 3] → the model's raw head outputs on the input
        resized to ``img_size`` (bilinear, antialiased)."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        x = resize_bilinear(x.float() / 255.0, self.cfg.img_size)
        return self.model(x)

    @torch.inference_mode()
    def _run(self, frames: np.ndarray, conf_thr: float):
        cfg = self.cfg
        max_out = settings.DETECTION_MAX_OBJECTS
        # pre-select K >= max_out candidates by score before NMS
        pre_k = max(4 * max_out, 256)
        h, w = frames.shape[1:3]
        boxes, cls = decode_predictions(self.raw_outputs(frames), cfg)
        score, label = cls.amax(dim=-1), cls.argmax(dim=-1)
        sx, sy = w / cfg.img_size, h / cfg.img_size
        boxes = boxes * torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                                     device=boxes.device)
        masked = torch.where(score >= conf_thr, score,
                             torch.full_like(score, float("-inf")))
        top_s, top_i = topk_scores(masked, pre_k)
        top_b = torch.gather(boxes, 1, top_i[..., None].expand(
            *top_i.shape, 4))
        top_l = torch.gather(label, 1, top_i)
        return nms_per_class(top_b, top_s, top_l.to(torch.int32),
                             settings.DETECTION_IOU_THRESHOLD, max_out,
                             presorted=True)

    def detect(self, frames: np.ndarray,
               conf_threshold: float = 0.25) -> List[List[Dict]]:
        """uint8 [B, H, W, 3] → per-frame detection dicts (bbox xyxy px,
        confidence, class_id, class_name)."""
        if len(frames) == 0:
            return []
        conf = float(np.float32(conf_threshold))
        with trace("yolo.detect"):
            chunks = [[t.cpu().numpy() for t in self._run(
                frames[lo: lo + YOLO_CHUNK], conf)]
                for lo in range(0, len(frames), YOLO_CHUNK)]
        out: List[List[Dict]] = []
        for ob, os_, oc, valid in chunks:
            for b in range(len(valid)):
                dets = []
                for i in np.nonzero(valid[b])[0]:
                    cid = int(oc[b, i])
                    dets.append({
                        "bbox": [float(v) for v in ob[b, i]],
                        "confidence": float(os_[b, i]),
                        "class_id": cid,
                        "class_name": self.class_names[cid]
                        if cid < len(self.class_names) else str(cid),
                        "method": "yolo",
                    })
                out.append(dets)
        return out


class ClipGridDetector:
    """Open-vocabulary detection by scoring a G × G cell grid with CLIP,
    every cell of a frame batch in one tower call."""

    def __init__(self, engine: ClipEngine,
                 grid: Optional[int] = None) -> None:
        self.engine = engine
        self.grid = grid or settings.CLIP_GRID_SIZE

    @torch.inference_mode()
    def cell_embeddings(self, frames: np.ndarray) -> torch.Tensor:
        """uint8 [N, H, W, 3] → unit CLIP embeddings [N · G · G, D] of
        each cell (row-major cells of H // G × W // G px, the remainder
        cropped), on the engine's device, in one tower call."""
        g, eng = self.grid, self.engine
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(eng.device)
        n, h, w, _ = x.shape
        ch, cw = h // g, w // g
        cells = x[:, : ch * g, : cw * g].reshape(n, g, ch, g, cw, 3) \
            .permute(0, 1, 3, 2, 4, 5).reshape(n * g * g, ch, cw, 3)
        px = clip_preprocess(cells, size=eng.cfg.image_size)
        return eng.model.encode_image(px.to(eng.cfg.torch_dtype))

    @torch.inference_mode()
    def cell_scores(self, frames: np.ndarray,
                    text_emb: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W, 3] × unit text rows [Q, D] → cosine scores
        [N, G, G, Q] of each cell."""
        g = self.grid
        emb = self.cell_embeddings(frames)
        text = torch.from_numpy(np.asarray(text_emb, np.float32)).to(
            emb.device)
        return (emb @ text.T).reshape(len(frames), g, g, -1).cpu().numpy()

    def detect(self, frames: np.ndarray, queries: Sequence[str],
               conf_threshold: float = 0.2) -> List[List[Dict]]:
        if len(frames) == 0:
            return []
        text = self.engine.embed_texts(list(queries))
        sims = self.cell_scores(frames, text)
        g = self.grid
        _, h, w, _ = frames.shape
        ch, cw = h // g, w // g
        out: List[List[Dict]] = []
        for b in range(len(frames)):
            dets = []
            ys, xs, qs = np.nonzero(sims[b] >= conf_threshold)
            for y, x, q in zip(ys, xs, qs):
                dets.append({
                    "bbox": [float(x * cw), float(y * ch),
                             float((x + 1) * cw), float((y + 1) * ch)],
                    "confidence": float(sims[b, y, x, q]),
                    "query": queries[q],
                    "method": "clip_grid",
                })
            out.append(dets)
        return out


def extract_object_embeddings(engine: ClipEngine, frame: np.ndarray,
                              bboxes: List[List[float]]) -> np.ndarray:
    """CLIP embeddings of box crops (boxes under 2 px a side embed an
    8 × 8 black crop)."""
    crops = []
    h, w = frame.shape[:2]
    for x0, y0, x1, y1 in bboxes:
        x0, y0 = max(int(x0), 0), max(int(y0), 0)
        x1, y1 = min(int(x1), w), min(int(y1), h)
        if x1 - x0 < 2 or y1 - y0 < 2:
            crops.append(np.zeros((8, 8, 3), np.uint8))
        else:
            crops.append(frame[y0:y1, x0:x1])
    if not crops:
        return np.zeros((0, engine.cfg.projection_dim), np.float32)
    return engine.embed_images(crops)
