"""Framework configuration (counterpart of ``avede_tpu/utils/config.py``).

A plain dataclass with the same names and defaults as the JAX
package's settings that this port reads, and the same environment
overrides: every field can be set by an environment variable of its
name; numbers, booleans, lists and dicts parse as JSON. Only the
settings the ported paths (the ``mvp``, ``reranked`` and ``advanced``
queries, library search, open-vocabulary, small-object and
background-independent detection, image query, person search) read are
here.
"""

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, List, Mapping, Optional


def _bundled_asset(name: str) -> Optional[str]:
    """Absolute path of a packaged asset, or None if not shipped."""
    p = Path(__file__).resolve().parent.parent / "assets" / name
    return str(p) if p.exists() else None


@dataclasses.dataclass
class Settings:
    # --- Paths ---
    DATA_DIR: str = "data"
    VIDEO_DIR: str = "data/videos"
    CLIP_DIR: str = "data/clips"
    FRAME_DIR: str = "data/frames"
    EMBEDDING_DIR: str = "data/embeddings"
    IMAGE_DIR: str = "data/images"
    LOG_DIR: str = "logs"

    # --- Video limits ---
    MAX_VIDEO_SIZE_GB: float = 2.0
    SUPPORTED_FORMATS: List[str] = dataclasses.field(
        default_factory=lambda: ["mp4", "avi", "mov", "mkv", "webm"])
    FRAME_SAMPLE_RATE: int = 1          # sample every Nth frame
    MAX_FRAMES: int = 1000              # hard cap, evenly redistributed
    FRAME_MAX_SIZE: int = 512           # pre-resize long side cap

    # --- Sliding windows ---
    WINDOW_SIZE: int = 16
    WINDOW_STRIDE: int = 8

    # --- Model ---
    CLIP_WEIGHTS: Optional[str] = None  # flat slash-joined .npz
    BLIP_MODEL: str = "blip-base"       # "blip2..." selects the Q-Former
    BLIP_WEIGHTS: Optional[str] = None
    CAPTION_NUM_BEAMS: int = 1          # 1 = greedy; >1 = beam search
    CAPTION_LENGTH_PENALTY: float = 1.0
    UNIVTG_WEIGHTS: Optional[str] = None
    YOLO_WEIGHTS: Optional[str] = None
    OWLVIT_WEIGHTS: Optional[str] = None
    FEATURE_EXTRACTOR_WEIGHTS: Optional[str] = None   # EfficientNet-B0 .npz
    TOKENIZER_VOCAB: Optional[str] = dataclasses.field(
        default_factory=lambda: _bundled_asset("clip_bpe_merges.txt.gz"))
    BLIP_VOCAB: Optional[str] = dataclasses.field(    # BERT WordPiece
        default_factory=lambda: _bundled_asset("blip_wordpiece_vocab.txt.gz"))
    FACE_MODEL_PATH: Optional[str] = None   # cv2 FaceDetectorYN onnx
    APPEARANCE_WEIGHTS: Optional[str] = None     # re-ID encoder .npz
    FACE_DETECTOR_WEIGHTS: Optional[str] = None  # face-region YOLO .npz
    FACE_EMBED_WEIGHTS: Optional[str] = None     # 32 px face encoder .npz

    # --- Scan ---
    STREAM_CHUNK_FRAMES: int = 256      # decode→embed overlap chunk
    SCAN_TRANSFER: str = "i420"         # host→device codec: i420|rgb|full
    SCAN_FUSED_PACK: bool = True        # i420 pack on the decode threads
    SCAN_SPARSE_COLD: bool = True       # cold scan embeds window middles only
    SCAN_DEDUP_EPS: float = 1.5         # near-duplicate gate; 0 disables
    DECODE_WORKERS: int = 0             # 0 = auto
    FRAME_RETAIN_MB: int = 512          # scan frames kept for backfill

    # --- Caches ---
    TEXT_EMBED_CACHE: int = 512         # LRU entries; 0 disables
    EMBEDDING_MEM_CACHE_MB: int = 256   # in-memory table tier; 0 disables
    EMBEDDING_CACHE_INT8: bool = True   # per-row int8 cache entries
    EMBEDDING_CACHE_ENABLED: bool = True

    # --- Library search ---
    LIBRARY_INDEX_DTYPE: str = "bfloat16"   # device table: float32|bfloat16|int8
    LIBRARY_INDEX_DEDUP: bool = True    # collapse identical consecutive rows
    LIBRARY_PREWARM: bool = False       # index the library at server start
    LIBRARY_INDEX_ENABLED: bool = True  # off = host per-table scoring

    # --- Results ---
    TOP_K_RESULTS: int = 15
    CONFIDENCE_THRESHOLD: float = 0.25
    CLIP_DURATION: float = 30.0         # seconds per extracted clip

    # --- Image matching ---
    MATCHING_MODES: List[str] = dataclasses.field(
        default_factory=lambda: [
            "traditional", "object_focused", "cross_domain", "hybrid",
            "smart_match", "fast_match",
        ])
    MATCHING_THRESHOLDS: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            "traditional": 0.70,
            "object_focused": 0.60,
            "cross_domain": 0.50,
            "hybrid": 0.60,
            "smart_match": 0.55,
            "fast_match": 0.75,
        })

    # --- Open-vocabulary detection ---
    DETECTION_MODES: List[str] = dataclasses.field(
        default_factory=lambda: ["hybrid", "owlvit", "clip", "yolo_enhanced"])
    MATCHING_PRECISIONS: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"precise": 0.45, "balanced": 0.30,
                                 "comprehensive": 0.18, "semantic": 0.25,
                                 "visual": 0.25})
    DETECTION_MAX_OBJECTS: int = 100
    DETECTION_IOU_THRESHOLD: float = 0.45
    CLIP_GRID_SIZE: int = 8             # CLIP grid detector cells per side

    # --- Adaptive thresholds (size categories in px² at native size) ---
    SMALL_OBJECT_SIZES: Dict[str, List[int]] = dataclasses.field(
        default_factory=lambda: {"tiny": [0, 16 * 16],
                                 "small": [16 * 16, 32 * 32],
                                 "medium": [32 * 32, 96 * 96],
                                 "large": [96 * 96, 10 ** 9]})
    SMALL_OBJECT_BASE_THRESHOLDS: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"tiny": 0.05, "small": 0.10,
                                 "medium": 0.25, "large": 0.40})
    SMALL_OBJECT_BOOSTS: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"tiny": 2.0, "small": 1.5, "medium": 1.0,
                                 "large": 1.0})
    MULTI_SCALE_WEIGHTS: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"256": 1.2, "512": 1.0, "1024": 0.8})

    # --- Small-object detection ---
    TILE_SIZE: int = 640                # tiled inference on large frames
    TILE_OVERLAP: int = 128
    RPN_MAX_PROPOSALS: int = 128

    # --- Person re-identification ---
    PERSON_SIMILARITY_THRESHOLD: float = 0.60
    PERSON_FRAME_SKIP: int = 5
    PERSON_BATCH_SIZE: int = 50
    PERSON_TEMPORAL_WINDOW: int = 5
    PERSON_TEMPORAL_KEEP_RATIO: float = 0.8
    PERSON_FEATURE_WEIGHTS: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"face": 0.6, "body": 0.3, "visual": 0.1})

    # --- Device execution ---
    MESH_SHAPE: Optional[List[int]] = None   # None: every device on "data"
    MESH_AXES: List[str] = dataclasses.field(
        default_factory=lambda: ["data", "model"])
    COMPUTE_DTYPE: str = "bfloat16"     # on CUDA; the CPU computes in f32
    FRAME_BUCKETS: List[int] = dataclasses.field(
        default_factory=lambda: [32, 64, 128, 256, 512, 1024])
    EMBED_BATCH_PER_DEVICE: int = 128
    BATCHING_EXECUTOR_ENABLED: bool = True  # coalesce concurrent crop embeds
    BATCHING_MAX_WAIT_MS: float = 4.0

    # --- API ---
    API_HOST: str = "0.0.0.0"
    API_PORT: int = 8000
    CORS_ORIGINS: List[str] = dataclasses.field(default_factory=lambda: ["*"])

    # --- Observability ---
    ALARM_PROC_SECONDS: float = 10.0    # slower operations raise an alarm

    def ensure_dirs(self) -> None:
        for d in (self.DATA_DIR, self.VIDEO_DIR, self.CLIP_DIR,
                  self.FRAME_DIR, self.EMBEDDING_DIR, self.IMAGE_DIR,
                  self.LOG_DIR):
            Path(d).mkdir(parents=True, exist_ok=True)

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None
                 ) -> "Settings":
        env = dict(os.environ if env is None else env)
        base = cls()
        overrides: Dict[str, object] = {}
        for f in dataclasses.fields(cls):
            if f.name not in env:
                continue
            raw = env[f.name]
            if isinstance(getattr(base, f.name), str) or \
                    getattr(base, f.name) is None:
                overrides[f.name] = raw
                continue
            try:
                overrides[f.name] = json.loads(
                    raw.lower() if raw in ("True", "False") else raw)
            except ValueError:
                overrides[f.name] = raw
        return dataclasses.replace(base, **overrides)


settings = Settings.from_env()
