"""The frame-embedding engine (counterpart of
``avede_tpu/parallel/embed.py``'s ``ClipEngine``), on one device or
split over a mesh's data devices.

Frames go through the fused image path only: host pack
(``SCAN_TRANSFER``) → bucket padding (``pick_bucket``) →
``fused_patch_embed_i420`` (hand-written kernel that unpacks the I420
bytes while it builds its GEMM tile and returns tokens in the tower's
dtype; ``fused_patch_embed`` takes uint8 frames for ``rgb``; the patch
weights are folded and split for the kernel once, at load time) →
``encode_image_from_patches`` (flash attention in every vision layer)
→ unit-norm f32 embeddings.
Warm queries run ``query_window_topk``: text tower → one launch of the
fused ``cosine_window_topk`` kernel (score the window middles, mask,
top-k).

``embed_texts`` runs the text tower on its text-LRU misses. On a card,
up to 8 misses replay one captured CUDA graph of the whole tower (a
graph for each bucket of ``TEXT_GRAPH_BUCKETS`` at the tokenizer's
length, captured at the first such miss, the buckets sharing one memory
pool): the misses' ids are padded with all-zero rows (each row is
independent in the tower; the padded rows are dropped), copied into the
graph's static input, replayed, and the real rows read back, under one
lock from copy-in to read-back. More misses, and the CPU, run the tower
eagerly. ``text_graph_replays`` and ``text_eager_runs`` count the two.

On a mesh (``parallel/mesh.py``) of ``n_data`` data devices, the weights,
the folded patch weights and their split bf16 operands are copied once
to each distinct data device, each frame bucket is padded to a multiple
of ``n_data`` and split into ``n_data`` equal slices, each slice embedded
on its device (the kernels launch once a slice), and the slices' results
gathered in order on the first data device; the chunk cap is
``EMBED_BATCH_PER_DEVICE × n_data``, as in the JAX package. Text, the
warm query and the resident tables stay on the first data device. A
1 × 1 mesh is the one-device path, with no extra copy or launch.

``embed_stream`` overlaps decode with embed: a staging thread packs,
pads and copies each chunk into pinned host memory and issues its
host→device copy on a side CUDA stream while the device embeds the
previous chunk (the role of ``avede_tpu/parallel/prefetch.py``).

Crops and reference images of any size go through ``embed_images``: each
is cropped and resized on its own (``clip_preprocess``, bicubic), then
the batch is padded to a bucket of ``[1, 4, 16, 64, 256]`` and runs the
tower from pixels (``embed_pixels``; flash attention in every layer).
With ``BATCHING_EXECUTOR_ENABLED`` the preprocessed pixels go through a
``BatchingExecutor`` (``parallel/scheduler.py``) over ``embed_pixels``,
which coalesces the calls of concurrent requests into one tower call.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import math
import queue
import threading
from collections import OrderedDict
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, \
    Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.clip import CLIPConfig, init_clip, vit_b32
from ..models.convert import load_params
from ..models.tokenizer import Tokenizer
from ..ops.kernels import (fold_for_uint8, fused_patch_embed,
                           fused_patch_embed_i420, split_patch_weights)
from ..ops.preprocess import (central_square_crop, clip_preprocess,
                              pack_frames_i420, pack_frames_rgb,
                              resize_frames)
from ..ops.similarity import make_query_window_topk, pad_table
from ..utils.config import settings
from ..utils.logging import get_logger
from ..utils.platform import with_compute_dtype
from ..utils.trace import span
from .mesh import MeshContext, build_mesh, get_mesh

logger = get_logger(__name__)

BACKEND = "torch"      # model-tag marker: JAX-made tables never serve here
TEXT_GRAPH_BUCKETS = (1, 2, 4, 8)    # text-tower batches replayed as graphs


def pick_bucket(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest configured bucket ≥ n; beyond the largest, its next
    multiple (counterpart of ``avede_tpu/parallel/mesh.py:134``)."""
    buckets = list(buckets if buckets is not None
                   else settings.FRAME_BUCKETS)
    for b in buckets:
        if n <= b:
            return b
    top = buckets[-1]
    return int(math.ceil(n / top) * top)


_END = object()


def _staged(iterator: Iterable, transform: Callable,
            buffer_size: int = 2) -> Iterator:
    """Yield ``transform(item)`` for each item, computed ahead on a
    worker thread (at most ``buffer_size`` staged items in flight).
    Worker errors re-raise on the consumer. Abandoning the generator
    stops the worker at its next put."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    err: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in iterator:
                if not put(transform(item)):
                    return
        except Exception as exc:  # noqa: BLE001 — re-raised on consumer
            err.append(exc)
        finally:
            put(_END)

    t = threading.Thread(target=worker, daemon=True, name="avede-stage")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join(timeout=5.0)


@dataclasses.dataclass
class _Replica:
    """The engine's weights on one data device."""

    model: torch.nn.Module
    w2: torch.Tensor                   # folded patch weights [P·P·3, D]
    b2: torch.Tensor                   # folded bias [D]
    w_split: Optional[Tuple[torch.Tensor, torch.Tensor]]  # kernel operands
    copy_stream: Optional["torch.cuda.Stream"]


class _TextGraph(NamedTuple):
    """The text tower captured at one batch bucket: its graph, static
    int32 ids ``[B, max_text_len]`` and static f32 output ``[B, D]``."""

    graph: "torch.cuda.CUDAGraph"
    ids: torch.Tensor
    out: torch.Tensor


class ClipEngine:
    """Batched CLIP inference with host↔device plumbing, on one device
    or over a mesh's data devices.

    ``mesh`` (a local ``MeshContext``) and ``device`` exclude each other:
    ``device`` is a 1 × 1 mesh (``"cpu"`` runs the plain versions of the
    kernels on the CPU), and with neither the engine takes ``get_mesh()``
    (every visible card; none raises). Weights: ``state_dict`` (e.g.
    ``models.convert.params_from_jax``), else ``weights_path`` /
    ``settings.CLIP_WEIGHTS`` (the JAX package's flat ``.npz``), else
    random from ``seed``.
    """

    def __init__(self, cfg: Optional[CLIPConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 weights_path: Optional[str] = None,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, mesh: Optional[MeshContext] = None) -> None:
        if mesh is not None and device is not None:
            raise ValueError("pass mesh or device, not both")
        if mesh is None:
            mesh = get_mesh() if device is None \
                else build_mesh([device], shape=(1, 1))
        if mesh.is_distributed:
            raise ValueError("serving takes a local mesh (build_mesh with "
                             "devices), not a process group's")
        self.mesh = mesh
        self.device = mesh.data_devices[0]
        if cfg is None:
            cfg = with_compute_dtype(vit_b32(), self.device)
        # the port's serving configuration: flash attention in every
        # vision layer (the JAX package's opt-in use_flash)
        self.cfg = dataclasses.replace(cfg, use_flash=True)
        weights_path = weights_path or settings.CLIP_WEIGHTS
        model = init_clip(self.cfg, seed=seed)
        if state_dict is None and weights_path:
            state_dict = load_params(weights_path)
            self._tag = f"clip:{weights_path}"
            logger.info("CLIP weights loaded from %s", weights_path)
        elif state_dict is not None:
            # fingerprint external weights: two engines with different
            # weights must not share embedding-cache entries
            first = state_dict[sorted(state_dict)[0]]
            leaf = first.detach().float().reshape(-1)[:64].cpu().numpy()
            self._tag = ("external:"
                         + hashlib.md5(leaf.tobytes()).hexdigest()[:8])
        else:
            self._tag = f"clip:random-init-{seed}"
            logger.info("CLIP randomly initialised from seed %d (no "
                        "checkpoint configured)", seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        # fold /255 + CLIP normalisation into the patch weights once
        w2, bias_delta = fold_for_uint8(
            model.vision.patch_embedding.kernel().detach())
        # one replica a distinct data device (virtual shards share one);
        # the first device's takes the host model itself, last
        devices = list(dict.fromkeys(mesh.data_devices))
        self._replicas = {
            dev: self._replica(copy.deepcopy(model), w2, bias_delta, dev)
            for dev in devices[1:]}
        self._replicas[self.device] = self._replica(model, w2, bias_delta,
                                                    self.device)
        first = self._replicas[self.device]
        self.model = first.model
        self.tokenizer = Tokenizer(vocab_size=self.cfg.vocab_size,
                                   context_len=self.cfg.max_text_len)
        self._lock = threading.Lock()
        self._text_cache: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._table_lru: "OrderedDict[int, tuple]" = OrderedDict()
        self._table_seq = 0
        self._query_topk_fn = make_query_window_topk(self.model)
        self._batcher = None
        self._text_graphs: Optional[Dict[int, _TextGraph]] = None
        self._text_graph_lock = threading.Lock()
        self.text_graph_replays = 0
        self.text_eager_runs = 0

    def _replica(self, model: torch.nn.Module, w2: torch.Tensor,
                 bias_delta: torch.Tensor, dev: torch.device) -> _Replica:
        w2 = w2.contiguous().to(dev)
        cuda = dev.type == "cuda"
        return _Replica(
            model=model.to(dev, self.cfg.torch_dtype).eval(), w2=w2,
            b2=bias_delta.contiguous().to(dev),
            # the kernel's bf16 hi/lo operands (the CPU runs the plain path)
            w_split=(split_patch_weights(w2, self.cfg.patch_size)
                     if cuda else None),
            copy_stream=torch.cuda.Stream(dev) if cuda else None)

    @property
    def model_tag(self) -> str:
        # the transfer codec changes embedding values, and the backend
        # marker keeps JAX-made tables out of the port's cache hits
        mode = settings.SCAN_TRANSFER
        suffix = "" if mode == "full" else f"|{mode}"
        return f"{self._tag}|{BACKEND}|{self.cfg.image_size}px{suffix}"

    # ------------------------------------------------------------------
    def _pack_transfer(self, part: np.ndarray) -> np.ndarray:
        """Host half of the compact transfer codec (``SCAN_TRANSFER``);
        no-op for ``full`` or already-packed input."""
        mode = settings.SCAN_TRANSFER
        if part.ndim != 4 or part.shape[-1] != 3:
            return part          # already packed
        if mode == "i420" and self.cfg.image_size % 4 == 0:
            return pack_frames_i420(part, self.cfg.image_size)
        if mode == "rgb":
            return pack_frames_rgb(part, self.cfg.image_size)
        return part

    def _pad(self, part: np.ndarray) -> torch.Tensor:
        """uint8 host tensor padded to a bucket that splits evenly over the
        data devices (pinned when they are cards, so the copies can run
        asynchronously)."""
        bucket = self.mesh.pad_to_data(
            pick_bucket(len(part), settings.FRAME_BUCKETS))
        host = torch.zeros((bucket,) + part.shape[1:], dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host[: len(part)] = torch.from_numpy(np.ascontiguousarray(part))
        return host

    def _shards(self, batch: torch.Tensor
                ) -> List[Tuple[torch.Tensor, torch.device]]:
        """``batch`` (its length a multiple of ``n_data``) cut into the
        data devices' equal, contiguous slices, each with its device."""
        per = len(batch) // self.mesh.n_data
        return [(batch[i * per: (i + 1) * per], dev)
                for i, dev in enumerate(self.mesh.data_devices)]

    def _gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """The shards' results, in order, on the first data device."""
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.device, non_blocking=True)
                          for o in outs])

    @torch.inference_mode()
    def _embed_device(self, x: torch.Tensor) -> torch.Tensor:
        """Device uint8 batch (one shard, on its data device) → unit-norm
        f32 [B, D] via the fused path: packed I420 [B, S*3/2, S],
        model-geometry RGB [B, S, S, 3], or full frames [B, H, W, 3]
        (crop + antialiased bicubic resize)."""
        rep = self._replicas[x.device]
        size, patch = self.cfg.image_size, self.cfg.patch_size
        if x.dim() == 3:
            tokens = fused_patch_embed_i420(x, rep.w2, rep.b2, patch,
                                            rep.w_split,
                                            self.cfg.torch_dtype)
        else:
            if tuple(x.shape[1:3]) != (size, size):
                x = resize_frames(central_square_crop(x).float(), size)
            tokens = fused_patch_embed(x.contiguous(), rep.w2, rep.b2,
                                       patch, rep.w_split)
        return rep.model.encode_image_from_patches(tokens)

    def _empty(self) -> np.ndarray:
        return np.zeros((0, self.cfg.projection_dim), np.float32)

    def embed_frames(self, frames: np.ndarray) -> np.ndarray:
        """uint8 [N, H, W, 3] (or packed) → unit-norm float32 [N, D], in
        bucket-padded chunks of at most ``EMBED_BATCH_PER_DEVICE ×
        n_data``."""
        n = len(frames)
        if n == 0:
            return self._empty()
        cap = settings.EMBED_BATCH_PER_DEVICE * self.mesh.n_data
        return self.embed_stream(frames[lo: lo + cap]
                                 for lo in range(0, n, cap))

    def _upload(self, host: torch.Tensor, dev: torch.device):
        """Start ``host``'s copy to ``dev`` on its replica's side stream
        → (device tensor, event that marks the copy done; None on the
        CPU)."""
        stream = self._replicas[dev].copy_stream
        if stream is None:
            return host.to(dev), None
        with torch.cuda.stream(stream):
            out = host.to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(stream)
        return out, ready

    def embed_stream(self, chunks: Iterable[np.ndarray]) -> np.ndarray:
        """Overlapped decode→embed over an iterator of uint8 chunks: a
        staging thread packs, pads and starts each shard's host→device
        copy on a side stream while the devices embed the previous
        chunk. Only the final device→host copy waits for the devices."""
        lens: List[int] = []

        def stage(part: np.ndarray):
            part = self._pack_transfer(part)
            host = self._pad(part)
            lens.append(len(part))
            return [self._upload(h, dev) for h, dev in self._shards(host)]

        outs: List[torch.Tensor] = []
        for shards in _staged(chunks, stage):
            embs = []
            for x, ready in shards:
                if ready is not None:
                    cur = torch.cuda.current_stream(x.device)
                    cur.wait_event(ready)
                    x.record_stream(cur)
                embs.append(self._embed_device(x))
            outs.append(self._gather(embs))
        if not outs:
            return self._empty()
        return torch.cat([e[:n] for e, n in zip(outs, lens)]
                         ).float().cpu().numpy()

    def embed_frames_device(self, frames: np.ndarray
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Like ``embed_frames`` (one bucket) but keeps the padded result
        on the first data device → (embeddings [B, D], valid mask
        [B])."""
        part = self._pack_transfer(frames)
        host = self._pad(part)
        emb = self._gather([self._embed_device(h.to(dev, non_blocking=True))
                            for h, dev in self._shards(host)])
        valid = torch.arange(len(host), device=self.device) < len(part)
        return emb, valid

    def embed_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 [H_i, W_i, 3] images of any sizes → unit-norm float32
        [N, D]: each is center-cropped and resized to the model square on
        its own (on the engine's device), then one tower call, shared
        with concurrent callers through the batching executor when
        ``BATCHING_EXECUTOR_ENABLED`` is set."""
        if len(images) == 0:
            return self._empty()
        size = self.cfg.image_size
        batch = torch.cat([
            clip_preprocess(torch.from_numpy(np.ascontiguousarray(
                img, np.uint8)[None]).to(self.device), size=size)
            for img in images])
        if settings.BATCHING_EXECUTOR_ENABLED:
            return self._pixel_batcher()(batch)
        return self.embed_pixels(batch)

    @torch.inference_mode()
    def embed_pixels(self, batch: Union[np.ndarray, torch.Tensor]
                     ) -> np.ndarray:
        """Preprocessed float [N, S, S, 3] → unit-norm float32 [N, D],
        padded to a bucket of ``[1, 4, 16, 64, 256]`` (one image runs
        alone), rounded up to a multiple of ``n_data`` and split over the
        data devices."""
        n = len(batch)
        if n == 0:
            return self._empty()
        size = self.cfg.image_size
        bucket = self.mesh.pad_to_data(
            1 if n == 1 else pick_bucket(n, [4, 16, 64, 256]))
        padded = torch.zeros((bucket, size, size, 3), dtype=torch.float32,
                             device=self.device)
        padded[:n] = torch.as_tensor(batch, device=self.device)
        padded = padded.to(self.cfg.torch_dtype)
        out = self._gather([
            self._replicas[dev].model.encode_image(x.to(dev))
            for x, dev in self._shards(padded)])
        return out[:n].float().cpu().numpy()

    def _pixel_batcher(self):
        """The request coalescer over ``embed_pixels``, built at first
        use."""
        if self._batcher is None:
            with self._lock:
                if self._batcher is None:
                    from .scheduler import BatchingExecutor

                    self._batcher = BatchingExecutor(
                        self.embed_pixels,
                        max_batch=settings.EMBED_BATCH_PER_DEVICE
                        * self.mesh.n_data,
                        max_wait_ms=settings.BATCHING_MAX_WAIT_MS)
        return self._batcher

    # ------------------------------------------------------------------
    def _remember_text(self, text: str, emb: np.ndarray) -> None:
        cap = settings.TEXT_EMBED_CACHE
        if cap <= 0:
            return
        with self._lock:
            self._text_cache[text] = emb
            self._text_cache.move_to_end(text)
            while len(self._text_cache) > cap:
                self._text_cache.popitem(last=False)

    def embed_texts(self, texts: Union[Sequence[str], str]) -> np.ndarray:
        """→ unit-norm float32 [Q, D]; per-text LRU cache."""
        if isinstance(texts, str):
            texts = [texts]
        texts = list(texts)
        if not texts:
            return self._empty()
        hits: Dict[str, np.ndarray] = {}
        with self._lock:
            for t in texts:
                if t in self._text_cache:
                    hits[t] = self._text_cache[t]
                    self._text_cache.move_to_end(t)
        misses = list(dict.fromkeys(t for t in texts if t not in hits))
        if misses:
            bucket = self._text_bucket(len(misses))
            with span("clip.encode_text", graph=bucket):
                ids = self.tokenizer(misses)
                fresh = (self._replay_text(ids, bucket) if bucket
                         else self._encode_text_eager(ids))
            for t, e in zip(misses, fresh):
                hits[t] = e
                self._remember_text(t, e)
        return np.stack([hits[t] for t in texts])

    def _text_bucket(self, n: int) -> int:
        """The graph bucket that ``n`` text misses replay; 0 runs the
        tower eagerly (the CPU, or more than the largest bucket)."""
        if self.device.type != "cuda" or n > TEXT_GRAPH_BUCKETS[-1]:
            return 0
        return pick_bucket(n, TEXT_GRAPH_BUCKETS)

    @torch.inference_mode()
    def _encode_text_eager(self, ids: np.ndarray) -> np.ndarray:
        with self._lock:
            self.text_eager_runs += 1
        return self.model.encode_text(torch.from_numpy(ids).to(
            self.device)).float().cpu().numpy()

    @torch.inference_mode()
    def _replay_text(self, ids: np.ndarray, bucket: int) -> np.ndarray:
        """Token ids ``[Q, max_text_len]`` → the tower's f32 ``[Q, D]``
        by a replay of ``bucket``'s graph (Q ≤ bucket)."""
        padded = np.zeros((bucket, ids.shape[1]), ids.dtype)
        padded[: len(ids)] = ids
        with self._text_graph_lock, torch.cuda.device(self.device):
            if self._text_graphs is None:
                self._text_graphs = self._capture_text_graphs()
            g = self._text_graphs[bucket]
            g.ids.copy_(torch.from_numpy(padded))
            g.graph.replay()
            self.text_graph_replays += 1
            return g.out[: len(ids)].float().cpu().numpy()

    def _capture_text_graphs(self) -> Dict[int, _TextGraph]:
        """The text tower captured once a bucket of
        ``TEXT_GRAPH_BUCKETS``, in one memory pool; each bucket warmed up
        on the capture stream first. Capture errors only for this
        thread's calls, so other threads may go on launching on the
        card."""
        stream = torch.cuda.Stream(self.device)
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        for b in TEXT_GRAPH_BUCKETS:
            ids = torch.zeros((b, self.cfg.max_text_len), dtype=torch.int32,
                              device=self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                self.model.encode_text(ids)
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = self.model.encode_text(ids)
            graphs[b] = _TextGraph(graph, ids, out)
        return graphs

    def resident_table(self, emb: np.ndarray, middle_idx: np.ndarray
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Bucket-padded device copies of a score table + window indices
        (f32 [Nb, D], bool [Nb], int32 [Wb]), cached by host-array
        identity (LRU of 8): the embedding cache returns the same array
        object for repeat lookups and tables are never mutated in
        place, so repeat queries upload nothing."""
        mids = np.asarray(middle_idx, np.int32)
        with self._lock:
            for key, (href, hmids, cached) in self._table_lru.items():
                if href is emb and np.array_equal(hmids, mids):
                    self._table_lru.move_to_end(key)
                    return cached
        pemb, valid, pmids = pad_table(np.asarray(emb, np.float32), mids,
                                       settings.FRAME_BUCKETS)
        dev = (torch.from_numpy(pemb).to(self.device),
               torch.from_numpy(valid).to(self.device),
               torch.from_numpy(pmids).to(self.device))
        with self._lock:
            self._table_seq += 1
            self._table_lru[self._table_seq] = (emb, mids, dev)
            while len(self._table_lru) > 8:
                self._table_lru.popitem(last=False)
        return dev

    def query_window_topk(self, query: str, emb: np.ndarray,
                          middle_idx: np.ndarray, k: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Warm-query serving path: token ids → text tower → score the
        window middles of the resident table, mask and top-k in one
        kernel launch (``cosine_window_topk``). The text embedding lands
        in the LRU for other consumers."""
        dev = self.resident_table(emb, middle_idx)
        ids = torch.from_numpy(self.tokenizer([query])).to(self.device)
        vals, idx, q = self._query_topk_fn(ids, dev[0], dev[1], dev[2], k)
        self._remember_text(query, q.cpu().numpy())
        return vals.cpu().numpy(), idx.cpu().numpy()


_DEFAULT: Optional[ClipEngine] = None


def get_engine() -> ClipEngine:
    """The process-wide engine (``ClipEngine()``: on ``get_mesh()``, every
    visible card), built at first use. The port's services take their engine as an argument; this
    is the JAX package's default for callers that pass none."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ClipEngine()
    return _DEFAULT


def set_engine(engine: Optional[ClipEngine]) -> None:
    """Replace (or with None, forget) the process-wide engine."""
    global _DEFAULT
    _DEFAULT = engine
