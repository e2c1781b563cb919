#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises
and the script exits non-zero without printing a result:

1. print the card's name and power limit (``nvidia-smi``), and what the
   machine could decode video and serve HTTP with (a report, installing
   nothing: ``torchvision.io``, torchaudio's ffmpeg, ``av``, ``cv2``,
   ``aiohttp``, the ``avcodec``/``nvcuvid`` libraries, an ``ffmpeg``
   binary);
2. build every kernel under ``avede_tpu_torch/csrc/`` (one ``nvcc`` per
   source, all at once) into ``build/kernels/``;
3. hold each kernel against its plain PyTorch version at the shapes of
   the main path, with f32 references (TF32 off) and the tolerance
   ``max |kernel - plain| <= 1e-4 * max |plain| + 1e-5``; an entry that
   returns bf16 (flash attention on ``[B, L, H, hd]``, the I420 patch
   embed) is held to its plain f32 result rounded to bf16: within one
   bf16 ulp plus 1e-5 (flash) or plus the f32 bar (patch embed, whose
   bf16 ×3 sums carry more than rounding), with the share of elements
   that are not bit-equal reported; time kernel,
   plain version and one library call on the device (CUDA events around
   a CUDA-graph replay, host launch cost excluded), and the kernel's
   eager per-call wall (``call_ms``). The fused score + top-k entries
   (``cosine_window_topk`` at the main path's 74 windows, and at Q = 4
   and W = 5000; ``cosine_topk_f32``, ``_bf16`` and ``_int8`` over 2^20
   rows at k = 64 and 1024) must equal ``topk_scores`` of their contract
   entry's scores bit for bit; their yardstick is the contract entry +
   ``torch.topk(sorted=True)``. The bf16 flash entry is also held at
   BLIP's vision shape (row ``flash_attention_blhd[blip]``: 30
   candidates x 577 tokens, q, k and v the thirds of one fused qkv
   projection read in place), SDPA its yardstick, and at the detection
   path's shapes, contiguous heads at a row stride of 768: OWL-ViT
   B/32's (row ``[owl]``: a 16-frame batch x 577 tokens), the CLIP
   grid's (row ``[grid]``: 16 frames x 8 x 8 cells = 1024 images x 50
   tokens) and the largest crop bucket's (row ``[crop]``: 256 x 50), and
   at image query's small buckets: a reference image alone (row
   ``[ref]``: 1 x 50) and a frame's crops (row ``[crops16]``: 16 x 50),
   and at BLIP-2's ViT-g shape (row ``[blip2]``: 30 candidates x 257
   tokens, 16 heads of 88, the thirds of a fused qkv at row stride
   4224; the entry's hd = 88 instantiation). The eval modes' tiny
   towers (32 px, patch 8, width 64, 4 heads of 16) at the eval path's
   batch of 32: row ``fused_patch_embed_i420[tiny]`` (1c: packed I420
   [32, 48, 32] → bf16 [32, 16, 64], the patch embed's simple kernel,
   which every P other than 32 and D not a multiple of 96 takes) and
   row ``flash_attention_blhd[tiny]`` (2j: [32, 17, 4, 16], the hd = 16
   instantiation), and the ``detection`` eval mode's OWL-ViT (64 px,
   patch 8, 4 heads of 24) at one frame: row
   ``flash_attention_blhd[owl24]`` (2k: [1, 65, 4, 24], row stride 96,
   the hd = 24 instantiation, padded to 32 columns in shared memory).
   The entry counts launches by L only, so the detection rows' counts
   are its L = 577 (OWL-ViT) and L = 50 (grid and crops) launches. The
   library's entries run at the index's serving size: the bf16 and int8
   cosine entries over 2^20 rows with a valid mask, ``quantize_rows`` at
   an add-block (768 rows) and at growth (1,024,000 rows),
   ``quantize_per_channel`` at the TPU kernel's [3072, 768] and at odd
   shapes; quantization must equal its plain version exactly. Where no
   single PyTorch call computes a kernel's function, ``library_ms`` is
   null and ``library`` says why;
4. check the card's bf16 embeddings against the CPU's f32 plain path
   on the same seeded weights, on a few frames (cosine >= 0.99);
5. drive the main path at CLIP ViT-B/32 width (random weights from a
   seed, bf16): a ``Phase1Scan`` over an in-memory source of 600 seeded
   288×512 BGR frames with a moving object, an ``EmbeddingCache`` in a
   temporary directory, one cold ``process_video``, six warm ones
   (three queries, each twice) and one four-query ``process_queries``;
   the launch counts, zeroed just before, must be above 0 for the
   path's kernels (the I420 patch embed, bf16 flash attention, the fused
   ``cosine_window_topk``) and 0 for the contract entries (RGB patch
   embed, f32 flash, ``cosine_scores``);
   scores must be finite and sorted, repeated queries identical, and
   the top windows those of a numpy reference on the cached table;
6. drive whole-library search (``LibrarySearch``, the service behind
   ``POST /api/search-library``) over three synthetic videos, in the
   bfloat16, int8 and float32 tiers, each with a fresh cache and search:
   one video gets a cold ``process_video`` first, so ingest backfills
   it, the others take the dense scan; one cold search and three warm
   ones. The kernels of ingest and of the tier (its fused top-k entry)
   must have launched and every contract entry not at all; the
   indexed hits must rank as a numpy reference of the host path with
   the index's run collapse (near ties within 2e-3 may swap), with
   confidences within 2e-3 of the f32 tables, and the host path
   (``video_ids=``) must rank as the plain reference;
7. build a ``DeviceLibraryIndex`` at serving size, 1000 seeded videos
   of 1000 unit rows (1,024,000 padded rows, capacity 2^20), in the
   bfloat16 and the int8 tier: add p50, total growth time, search p50
   over 20 queries at k = 64 (the fused entry must launch, the contract
   entry not), device ms of the fused search beside its bound (and of
   the contract entry + stable sort it replaced), one search at k = 2048
   (above the fused entry's largest k: the contract entry, whose first
   64 hits must be the fused search's), and each search's top 10
   against an f32 reference on the same (dequantized) table where score
   gaps exceed 1e-4;
8. (run before phase 7, while the CLIP engine is loaded) drive the
   ``reranked`` and ``advanced`` query modes through
   ``VideoProcessor.process_query`` at full width: BLIP-base (random
   weights from seed 0, bf16) and the default grounding head (512 →
   256, depth 4, 4 heads, 1024 frames, f32) on phase 5's source. One
   cold ``reranked`` call (fresh caches) and three warm ones; then one
   ``advanced`` call on the warm table (its 4 × top_k candidates miss
   half the cached captions, read by seeks; grounding backfills the
   sparse table by a re-decode) and three warm ones. The cold rerank
   must launch the I420 patch embed, the fused ``cosine_window_topk``
   and the bf16 flash entry at both L = 50 (CLIP) and L = 577 (BLIP,
   counted apart); no contract entry may run; warm calls run no BLIP
   (no L = 577 launch). Results sorted and finite, reranked confidences
   ``0.7·clip + 0.3·caption`` within 1e-5, every anchor inside its
   segment, repeated queries identical; the card's bf16 BLIP vision
   states and teacher-forced logits (on the CPU's greedy tokens) and
   the grounding head's saliency and offsets against the CPU f32 plain
   path on the same weights, two frames, row cosine >= 0.99; the card's
   own greedy decode, each step's logits against the card's
   teacher-forced logits on the tokens it chose, row cosine >= 0.99
   (the leading tokens it shares with the CPU's are reported). Prints the
   cold and warm walls, BLIP vision and generate ms per candidate
   batch, decode steps and ms per step, and the grounding forward's ms.
9. (run after phase 8, while the CLIP engine is loaded) drive
   open-vocabulary detection through
   ``VideoProcessor.process_unlimited_detection`` at full width: OWL-ViT
   B/32 (768 px, vision 768 x 12 with 12 heads, text 512 x 12, random
   weights from seed 0, bf16), YOLOv8n at 640 px and the CLIP engine's
   8 x 8 grid, on phase 5's source read as 200 evenly spread frames in
   16-frame batches (the synthetic source serves ``stream_batches``):
   one cold and one warm ``hybrid`` call, one each of ``owlvit``,
   ``clip`` and ``yolo_enhanced``. The bf16 flash entry must launch at
   L = 577 (OWL-ViT) and in the CLIP grid (L = 50; the crops' L = 50
   launches are reported apart) and no other kernel at all; results
   finite, sorted by the composite score, boxes ordered and overlapping
   the frame, the two ``hybrid`` calls identical; the card's OWL-ViT
   logits and boxes, YOLO's raw head, the CLIP grid's cell embeddings
   and crop embeddings (``extract_object_embeddings``) against the
   CPU's f32 plain path on the same weights, two frames, row cosine
   >= 0.99. Prints each call's wall, the detections before
   and after the temporal dedup, and the device ms (CUDA events around
   eager calls) of the OWL-ViT forward, the YOLO forward and the CLIP
   grid per 16-frame batch.
10. (run after phase 9, while the CLIP engine and phase 9's OWL-ViT are
   loaded) drive small-object detection and background independence
   through ``VideoProcessor`` on an in-memory 1080p source (60 seeded
   1920×1080 frames, six squares and discs of 16-64 px moving over a
   textured background; 8 tiles of 640 px at overlap 128 a frame): the
   route's default ``process_small_object_detection`` (``clip`` mode,
   RPN, adaptive thresholds, background independence, top 20) cold and
   warm on the first 10 frames, one ``owlvit`` call at top 5 on the
   first 2 frames, two ``clip`` calls at threshold -1 without the
   adaptive thresholds on the
   first 2 frames (top 2), one ``process_background_independence`` with
   its defaults and one at threshold -1 on the first 4 frames; cv2 is
   required (GrabCut, Farnebäck flow, contours) and its RNG is seeded
   before each call and each GrabCut. The bf16 flash entry must launch
   at L = 50 in every call and at L = 577 in the ``owlvit`` call only,
   no other kernel at all; results finite, sorted by confidence, sizes
   in [16, 128], boxes overlapping the frame, the two default calls and
   the two ``clip`` calls at -1 identical, and the ``owlvit``, ``clip``
   and background calls that keep every candidate must return results
   and segment some. ``extract_features`` on four boxes around planted
   objects runs on the card (CLIP bf16, an EfficientNet-B0 of seeded
   random weights in f32) and on the CPU's f32 plain path on the same
   weights: CLIP and EfficientNet row cosines >= 0.99, GrabCut masks and
   shape descriptors equal. The CLIP grid's cell embeddings of one
   frame's 8 tiles (flash at [512, 50, 12, 64]) and OWL-ViT's logits and
   boxes on them ([8, 577, 12, 64]) are held to the CPU's f32 path too,
   row cosine >= 0.99. Prints each call's wall, host seconds by stage,
   ``enhancement_stats``, flash launches at L = 50 and 577, the CLIP
   grid's device ms over one frame's 8 tiles and EfficientNet-B0's ms
   at batch 1 and 16, cuDNN's TF32 off and on.
11. (run after phase 10, while the CLIP engine is loaded) drive image
   query through ``VideoProcessor.process_image_matching`` at full
   width (CLIP ViT-B/32 bf16, YOLOv8n at 640 px, random weights from
   seed 0) on a real video file: 150 seeded frames of 1280×720 at 30 fps
   (a textured background, four objects of 64-200 px moving) written by
   ``cv2.VideoWriter`` as ``mp4v`` in ``.mp4`` and decoded by the port's
   ``VideoReader`` (fails, printing cv2's Video I/O build information,
   where cv2 cannot write or read it). References from the decoded
   frames: A the middle frame, B a 160 × 160 crop around an object in
   it, C A in grayscale. Calls, top 5: ``traditional`` with A cold
   (fresh caches; clips cut, each read back by cv2; the top match must be
   A's frame ± 15) and again (the result cache: the same list, no
   launch), ``fast_match`` with B at -1, ``cross_domain`` with C,
   ``object_focused`` with B at -1, ``hybrid`` with B, ``smart_match``
   with A and with C. The cold call must launch the I420 patch embed and
   flash at L = 50, the later calls no patch embed (the table is warm),
   the YOLO-crop calls flash at L = 50, and no other kernel may run;
   results finite, sorted, inside the video, quality in [0, 1]. Then
   eight threads embed 3-20 crops each at once through the engine's
   batching executor (fewer batches than requests; rows against direct
   ``embed_pixels``, cosine >= 0.999), and the card's bf16 against the
   CPU's f32 plain path (8 frames, reference B, 16 YOLO crops: row
   cosine >= 0.99; the cold call's top frame kept when the CLIP part of
   the 40 survivors' composite is recomputed on the CPU). Prints each
   call's wall, host seconds by stage and launches.
12. (run after phase 8, with BLIP-base freed) drive the ``reranked``
   mode with ``BLIP_MODEL = "blip2-itm-vit-g"`` through
   ``VideoProcessor.process_query`` at full width: the Q-Former reranker
   (``QFormerConfig()``: ViT-g 1408 x 39 at 224 px, 16 heads of 88, MLP
   6144; Q-Former 768 x 12, 32 queries, projection 256, vocab 30523;
   bf16, random weights from seed 0) on phase 5's source: one cold call
   (fresh caches; the 30 candidates through the tower) and three warm
   ones (the text side only). The cold call must launch the bf16 flash
   entry 39 times at L = 257 for each candidate batch, and at L = 50,
   the I420 patch embed and ``cosine_window_topk`` for the scan; warm
   calls no L = 257 launch; no contract entry. Results sorted and
   finite, ``0.7·clip + 0.3·itc_score`` within 1e-5, repeated calls
   identical. The cold call again on fresh caches and one warm call run
   under ``torch.profiler`` for the device's busy time and idle share.
   Two candidates' per-query image embeddings and the query's text
   embedding on the card against the CPU's f32 plain path on the card's
   weights in f32: row cosine >= 0.999. Prints the cold wall, the warm
   p50, the tower's and the text side's ms, and the launches.
13. (run after phase 11) drive person search through
   ``VideoProcessor.process_person_search`` at full width (CLIP
   ViT-B/32 bf16, random weights from seed 0; YOLOv8n at 640 px bf16
   through ``YOLO_WEIGHTS``: a file of its seed-0 random weights with the
   person class's logit bias at 1.0, since random YOLOv8n scores every
   class about 0.5 and keeps no person box; ``DETECTION_MAX_OBJECTS``
   4) on a real video file: 300 frames of 1280×720 at 30 fps, four seeded
   identities with fixed outfits walking over a textured background
   (the port's ``utils.synthetic`` drawer), written by cv2 as ``mp4v``
   in ``.mp4``; the reference image is the first identity drawn alone
   by ``draw_person``. Call (a): the defaults (every 5th frame: 60; no
   weights: the gray-crop face, GrabCut body and CLIP visual cues), then
   again under the profiler (the same matches); call (b): the
   appearance encoder, the face-region YOLO and the face embedder loaded
   through ``APPEARANCE_WEIGHTS``, ``FACE_DETECTOR_WEIGHTS`` and
   ``FACE_EMBED_WEIGHTS`` from ``.npz`` files the script writes in the
   JAX package's layout (port random weights from seed 0, f32), at
   threshold -1 with annotated frames saved. Some sampled frame must
   have a person box (the bias puts every anchor's person score at
   sigmoid(1) = 0.73, above detect_persons' fixed 0.3);
   the bf16 flash entry must launch at L = 50 and no other kernel run.
   One frame's CLIP visual, appearance and face-encoder rows on the
   card against the CPU's f32 plain path, on the card's person boxes:
   row cosine >= 0.9999. Prints each call's wall and host seconds by
   stage, the device's busy time and idle share, and the launches.

14. (run after phase 13, while the CLIP engine is loaded) train at full
   width in f32 with TF32 off (``parallel/train.py``,
   ``train_reid.py``): CLIP ViT-B/32 from seed 0 (clip 1.0, adamw 1e-4 /
   0.05) on one fixed seeded batch of 32 images (224 px) and 77-token
   ids, 10 ``make_train_step`` steps and one more under the profiler;
   BLIP-base's ``make_caption_train_step`` (``use_flash=False``: plain
   attention, no kernel; 384 px, 577 tokens; adam 1e-4 behind clip 1.0)
   on a batch of 8 with 20-token ids and pads, 5 steps; the default
   grounding head (512 → 256, depth 4) at B = 16, N = 256 and the
   default appearance encoder (64 px) at batch 64, 10 steps each; the
   detector trainers (``train_det.py``, ``train_owl.py``): YOLOv8n at
   640 px, 80 classes, on 16 scenes of up to 8 shapes (its BatchNorm
   statistics must not move) and OWL-ViT B/32 at 768 px (577 tokens,
   plain attention: no flash launch) on 4 scenes against the three
   detection queries, 10 steps each. Each run prints its step ms (CUDA
   events, median of steps 3 on), first and
   last loss and gradient norm, and peak memory; every loss must be
   finite and the last below the first; each trainer's first step on
   the card is held to the same step on the CPU at a small batch (loss
   within 1e-4 relative, gradient norm within 1e-3). Then the CLIP
   trained there is written by ``save_params`` and served by a
   ``ClipEngine`` (bf16, the kernels) on phase 5's source: one cold
   ``process_video`` and two warm queries, launches zeroed before them
   and kept as path ``train_serve`` (the I420 patch embed, flash at
   L = 50 and ``cosine_window_topk`` above 0, every contract entry 0);
   the engine's embeddings of 8 frames must be within row cosine 0.99
   of the trained f32 model's ``encode_image`` and nearer to it than to
   the untrained engine's. Last, ``avede_tpu_torch.eval.eval_grounding``
   on the card (seed 0: 3 seeds of 500 steps), held to EVAL.json's JAX
   spread: mean tIoU >= 0.686, tIoU@0.5 >= 0.9.
15. (run after phase 14) a Hugging Face checkpoint into the port: a
   random ViT-B/32 state dict under ``CLIPModel``'s names
   (``hf_clip_state_dict``, made without ``transformers``) written by
   ``torch.save``, converted by ``python -m
   avede_tpu_torch.models.convert --model clip`` in its own process and
   served by ``ClipEngine(weights_path=...)`` through the kernels on
   phase 5's source (one cold and two warm queries, path
   ``convert_serve``); the card's embeddings of 8 frames against the
   same file on the CPU in f32, row cosine >= 0.9999.
16. (run after phase 15) the eval modes ``image`` (2 seeds) and
   ``text`` (2 seeds of 700 training steps) through
   ``avede_tpu_torch.eval.main`` on the card, path ``eval``: the simple
   patch kernel (``fused_patch_embed_i420[simt]``), flash at L = 17 and
   ``cosine_window_topk`` must launch, the wgmma patch kernel and the
   contract entries not at all; image p@1 >= 0.75, text p@1 >= 0.875
   (EVAL.json's JAX reference less one test item).
17. (run after phase 16) the ``detection`` eval mode's OWL-ViT (64 px,
   patch 8, 4 heads of 24) trained on the card for 400 steps, then
   served through ``UniversalDetector``'s ``owlvit`` and ``hybrid``
   modes on 12 held-out 128 px scenes (path ``eval_detection``: flash
   at L = 65 must launch 4 times a call, no contract entry at all); the
   card's logits against the same weights in f32 on the CPU, row cosine
   >= 0.999. The mode itself (its 700 + 2 × 2000 training steps),
   ``detection4k`` and ``person`` run as their own
   ``python -m avede_tpu_torch.eval`` calls.

Every kernel's row reports its launches on each path
(``launches_by_path``, counts zeroed just before each path) and, as
``launches``, those on its own path: ``mvp`` for the first slice's
kernels, the library search of its tier for the library's, the cold
``reranked`` call for the flash entry at BLIP's L = 577, and phase 9's
five detection calls for it at OWL-ViT's; phase 10's seven calls are
the ``small_object`` path, phase 11's eight the ``image_query`` path
(the ``[ref]`` and ``[crops16]`` rows read its L = 50 launches), phase
12's cold call the ``reranked_blip2`` path (the ``[blip2]`` row reads
its L = 257 launches), phase 13's three calls the ``person_search``
path, phase 14's three calls of the trained CLIP the ``train_serve``
path, phase 15's three calls the ``convert_serve`` path, phase 16's
two modes the ``eval`` path (rows 1c and 2j read its simple-kernel and
L = 17 launches) and phase 17's 24 calls the ``eval_detection`` path
(row 2k reads its L = 65 launches).

The line before the last is ``nvidia-smi``'s name and power limit; the
last is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32
# FLOP/s outside the tensor cores, and the dense bf16 tensor-core rate.
# Each row's bound uses the peak of the unit its design runs on.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12
TOL_REL, TOL_ABS = 1e-4, 1e-5

N_FRAMES, FRAME_H, FRAME_W, FPS = 600, 288, 512, 30.0
# the library index at serving size: 1000 videos of 1000 frames, each
# span padded to 1024 rows, in a table of 2^20 rows
INDEX_VIDEOS, INDEX_VIDEO_ROWS = 1000, 1000
INDEX_ROWS, INDEX_CAPACITY = INDEX_VIDEOS * 1024, 1 << 20
# whole-library search: three synthetic videos; indexed confidences are
# held to the f32 host tables within the bf16/int8 tiers' rounding
LIBRARY_VIDEOS = ("lib-0", "lib-1", "lib-2")
LIBRARY_TOL = 2e-3
# BLIP-base's vision tower: 384 px in 16 px patches, plus CLS
BLIP_TOKENS = (384 // 16) ** 2 + 1
# OWL-ViT B/32's vision tower: 768 px in 32 px patches, plus CLS
OWL_TOKENS = (768 // 32) ** 2 + 1
# CLIP ViT-B/32's: 224 px in 32 px patches, plus CLS
CLIP_TOKENS = (224 // 32) ** 2 + 1
# BLIP-2's ViT-g: 224 px in 14 px patches, plus CLS (16 heads of 88)
BLIP2_TOKENS = (224 // 14) ** 2 + 1
BLIP2_DEPTH = 39
# the eval modes' tiny towers: 32 px in 8 px patches, plus CLS (4 heads
# of 16, width 64); their batch on the eval path is the text mode's
# sparse cold scan, 15 window middles in the 32-row bucket
TINY_TOKENS = (32 // 8) ** 2 + 1
TINY_BATCH = 32
# the bf16 flash entry counts its launches by L only, read under these
# keys: L = 577 is BLIP-base's vision tower on the rerank paths and
# OWL-ViT's on the detection path (neither runs the other's model);
# L = 50 is CLIP's (the mvp scan, the detection grid and crops)
FLASH_L577 = f"flash_attention_blhd[L={BLIP_TOKENS}]"
FLASH_L50 = f"flash_attention_blhd[L={CLIP_TOKENS}]"
FLASH_L257 = f"flash_attention_blhd[L={BLIP2_TOKENS}]"
FLASH_L17 = f"flash_attention_blhd[L={TINY_TOKENS}]"
# the patch embed counts its launches by kernel too: the wgmma kernel
# (P = 32, D a multiple of 96) and the simple one (any other P and D)
SIMT_PATCH = "fused_patch_embed_i420[simt]"
# phase 3's rows of the bf16 flash entry at each model's shape
BLIP_FLASH = "flash_attention_blhd[blip]"
BLIP2_FLASH = "flash_attention_blhd[blip2]"
OWL_FLASH = "flash_attention_blhd[owl]"
GRID_FLASH = "flash_attention_blhd[grid]"
CROP_FLASH = "flash_attention_blhd[crop]"
# image query's small buckets: a reference image alone, a frame's crops
REF_FLASH = "flash_attention_blhd[ref]"
CROPS16_FLASH = "flash_attention_blhd[crops16]"
# the eval modes' tiny shapes: rows 1c (the patch embed's simple kernel)
# and 2j (flash at head dim 16)
TINY_PATCH = "fused_patch_embed_i420[tiny]"
TINY_FLASH = "flash_attention_blhd[tiny]"
# the ``detection`` eval mode's OWL-ViT: 64 px in 8 px patches, plus CLS
# (4 heads of 24, width 96): row 2k, and phase 17's path
DET_OWL_TOKENS = (64 // 8) ** 2 + 1
FLASH_L65 = f"flash_attention_blhd[L={DET_OWL_TOKENS}]"
DET_FLASH = "flash_attention_blhd[owl24]"
DETECTION_BATCH = 16
# the port's ``utils.trace`` span names, which the profiler also records
# as device-side ranges
TRACE_SPANS = ("phase1.", "phase2.", "phase3.", "owlvit.", "yolo.")
# phase 10: a 1080p source of 60 frames with six planted objects
# (kind, side px, x, y, px per frame in x and y, RGB)
SMALL_W, SMALL_H, SMALL_FRAMES = 1920, 1080, 60
# the default small-object calls read the first 10 of them: cut from 60,
# where the two took about 130 s of the phase's 238 s, then from 30,
# where they took 85.7 s (NVIDIA H100 80GB HBM3, 700 W), to keep the
# whole script within 600 s beside phases 12-16
SMALL_DEFAULT_FRAMES = 10
# the ``owlvit`` call reads the first 2: cut from 8, where it took 32 s,
# then from 4, where it took 27.8 s (NVIDIA H100 80GB HBM3, 700 W), to
# make room for phases 14-16
SMALL_OWLVIT_FRAMES = 2
SMALL_OBJECTS = [("square", 16, 200, 150, 9, 2, (220, 30, 30)),
                 ("disc", 24, 700, 300, -6, 4, (40, 220, 60)),
                 ("square", 32, 1200, 500, 5, -3, (30, 60, 230)),
                 ("disc", 40, 300, 800, 12, -5, (230, 220, 40)),
                 ("square", 48, 1500, 900, -10, -6, (220, 40, 220)),
                 ("disc", 64, 900, 700, 4, 5, (40, 220, 220))]
SMALL_QUERIES = ["a small red square", "a green ball", "a tiny object"]
# phase 11: a phone/CCTV clip written as a real mp4 (1280×720, 30 fps),
# a textured background and four moving objects (kind, side px, x, y,
# px per frame in x and y, BGR); every call keeps the top 5. 150 frames
# (5 s), cut from 600 (20 s), where the phase took 152 s, then from 300,
# where its calls took 81.7 s (NVIDIA H100 80GB HBM3, 700 W), to keep
# the script within 600 s beside phases 15-16; the reference is the
# middle frame
IMAGE_W, IMAGE_H, IMAGE_FRAMES = 1280, 720, 150
IMAGE_REF = IMAGE_FRAMES // 2
IMAGE_OBJECTS = [("square", 200, 120, 90, 1.1, 0.4, (40, 40, 220)),
                 ("disc", 140, 900, 140, -0.9, 0.7, (60, 200, 40)),
                 ("square", 64, 520, 520, 1.5, -0.6, (230, 60, 40)),
                 ("disc", 100, 300, 420, 0.6, -0.5, (40, 220, 230))]
IMAGE_TOP_K = 5
# phase 13: people walking in a 1280×720 mp4 of 300 frames at 30 fps:
# per identity its height px, start x, y and px per frame in x and y
PERSON_FRAMES = 300
# YOLOv8n's person logit bias in phase 13's weight file, and the boxes
# NMS keeps a frame there (one per walking identity)
PERSON_BIAS, PERSON_MAX_BOXES = 1.0, 4
PERSON_WALKS = [(420, 100, 200, 2.5, 0.3), (360, 900, 250, -2.0, 0.4),
                (300, 500, 380, 1.2, -0.5), (460, 300, 120, -1.4, 0.2)]
IMAGE_VIDEO_ID = "image-query"
# phase 14: each trainer's (batch, steps, rows of its card-vs-CPU first
# step); the caption ids' length; the grounding head's frames
TRAIN_CLIP, TRAIN_CAPTION = (32, 10, 4), (8, 5, 1)
TRAIN_GROUNDING, TRAIN_REID = (16, 10, 2), (64, 10, 8)
TRAIN_CAPTION_LEN, TRAIN_GROUNDING_N, TRAIN_SERVE_FRAMES = 20, 256, 8
# the detector trainers at full width: YOLOv8n (640 px, 80 classes) and
# OWL-ViT B/32 (768 px, the three DETECTION_QUERIES), scenes of up to
# TRAIN_DET_BOXES non-overlapping shapes; OWL-ViT B/32 at adam 1e-4 (at
# the trainer's default 1e-3, tuned for the tiny towers, its loss rose
# from 5.9 to 8.6 and stayed above its start over 10 steps on an NVIDIA
# H100 80GB HBM3 at 700 W)
TRAIN_YOLO, TRAIN_OWL, TRAIN_DET_BOXES = (16, 10, 2), (4, 10, 1), 8
TRAIN_OWL_LR = 1e-4
# a first step's loss and gradient norm, card against CPU (relative)
TRAIN_LOSS_REL, TRAIN_NORM_REL = 1e-4, 1e-3
# the grounding eval's bar: EVAL.json's JAX spread over 3 seeds (mean
# tIoU 0.776, std 0.030; tIoU@0.5 1.0): the mean less 3 std, and 0.9
GROUNDING_MIN_TIOU, GROUNDING_MIN_AT_05 = 0.686, 0.9
# phase 16's bars, from EVAL.json's JAX reference and its spread over
# seeds (spread 0: one test item's share): image p@1 1.0 of 4 subjects,
# text p@1 0.9375 of 16 classes
EVAL_BARS = {"image": ("image_retrieval", 0.75),
             "text": ("text_retrieval_trained", 0.875)}
# phase 15: the converted HF checkpoint served on the card against the
# same file on the CPU (8 frames, row cosine)
CONVERT_FRAMES, CONVERT_MIN_COSINE = 8, 0.9999
# phase 17: the detection mode's OWL-ViT trained on the card (steps of
# its warmup-cosine schedule), served on held-out 128 px scenes at one
# confidence in the ``owlvit`` and ``hybrid`` modes, its logits held to
# the same weights in f32 on the CPU (row cosine over each frame's)
DET_EVAL_STEPS, DET_EVAL_FRAMES, DET_EVAL_CONF = 400, 12, 0.65
DET_EVAL_MIN_COSINE = 0.999
DETECTION_QUERIES = ["a red square", "a car", "a person walking"]
# the largest crop bucket of ``ClipEngine.embed_pixels``
CROP_BUCKET = 256
# the path whose launches a kernel's row reports (default: mvp), and
# the launch key it reads there (default: the row's name)
KERNEL_PATH = {OWL_FLASH: "unlimited_detection",
               GRID_FLASH: "unlimited_detection",
               CROP_FLASH: "unlimited_detection",
               "cosine_topk_f32": "library_float32",
               "cosine_scores_bf16": "library_bfloat16",
               "cosine_topk_bf16": "library_bfloat16",
               "cosine_scores_int8": "library_int8",
               "cosine_topk_int8": "library_int8",
               "quantize_rows": "library_int8",
               "quantize_per_channel": "library_int8",
               BLIP_FLASH: "reranked", BLIP2_FLASH: "reranked_blip2",
               REF_FLASH: "image_query", CROPS16_FLASH: "image_query",
               TINY_PATCH: "eval", TINY_FLASH: "eval",
               DET_FLASH: "eval_detection"}
LAUNCH_KEY = {BLIP_FLASH: FLASH_L577, BLIP2_FLASH: FLASH_L257,
              OWL_FLASH: FLASH_L577,
              GRID_FLASH: FLASH_L50, CROP_FLASH: FLASH_L50,
              REF_FLASH: FLASH_L50, CROPS16_FLASH: FLASH_L50,
              TINY_PATCH: SIMT_PATCH, TINY_FLASH: FLASH_L17,
              DET_FLASH: FLASH_L65}
NO_MASKED_MV = ("null: no single PyTorch call scores the rows and writes "
                "-inf for the masked ones")
QUERIES = ["a red square moving across the street",
           "an empty road at dusk", "a person walking a dog"]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def bound_ms(nbytes: float, flops: float, peak: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Device ms per call: CUDA events around one replay of a CUDA graph
    that holds ``iters`` calls, so host launch cost is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_ms(torch, fn, iters: int = 50) -> float:
    """Wall ms per eager call in a loop (host launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, ref):
    """(max |got - ref|, tolerance) with -inf entries required equal."""
    got, ref = got.float(), ref.float()
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin) \
            or not torch.equal(got[~fin], ref[~fin]):
        fail("kernel and plain version disagree on non-finite entries")
    err = (got[fin] - ref[fin]).abs().max().item()
    return err, TOL_REL * ref[fin].abs().max().item() + TOL_ABS


def bf16_err(torch, got, ref, rel: float = 0.0):
    """bf16 ``got`` against the f32 ``ref`` rounded to bf16 → (max |got -
    bf16(ref)|, max excess over one bf16 ulp + ``rel · max|ref|`` +
    1e-5 (<= 0 passes), share of elements not bit-equal)."""
    want = ref.to(torch.bfloat16)
    _, exp = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(exp, dtype=torch.float32), exp - 8)
    err = (got.float() - want.float()).abs()
    tol = ulp + rel * ref.abs().max().item() + TOL_ABS
    return (err.max().item(), (err - tol).max().item(),
            (got != want).float().mean().item())



def hf_clip_state_dict(torch, cfg, seed: int = 0) -> dict:
    """A random state dict under HF ``CLIPModel``'s key names and shapes
    for the port's ``CLIPConfig`` (MLPs 4x wide), made without
    ``transformers``: matrices normal(0, 0.02), LayerNorm scales 1 +
    normal(0, 0.02), biases normal(0, 0.02), the logit scale log(1/0.07).
    Seeded on the host's generator."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, mean=0.0):
        return torch.randn(*shape, generator=gen) * 0.02 + mean

    sd = {}

    def tower(prefix, dim, depth):
        for i in range(depth):
            s = f"{prefix}.encoder.layers.{i}"
            for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
                sd[f"{s}.self_attn.{proj}.weight"] = rnd(dim, dim)
                sd[f"{s}.self_attn.{proj}.bias"] = rnd(dim)
            sd[f"{s}.layer_norm1.weight"] = rnd(dim, mean=1.0)
            sd[f"{s}.layer_norm1.bias"] = rnd(dim)
            sd[f"{s}.mlp.fc1.weight"] = rnd(4 * dim, dim)
            sd[f"{s}.mlp.fc1.bias"] = rnd(4 * dim)
            sd[f"{s}.mlp.fc2.weight"] = rnd(dim, 4 * dim)
            sd[f"{s}.mlp.fc2.bias"] = rnd(dim)
            sd[f"{s}.layer_norm2.weight"] = rnd(dim, mean=1.0)
            sd[f"{s}.layer_norm2.bias"] = rnd(dim)

    t, v = cfg.text_dim, cfg.vision_dim
    sd["text_model.embeddings.token_embedding.weight"] = rnd(cfg.vocab_size,
                                                            t)
    sd["text_model.embeddings.position_embedding.weight"] = rnd(
        cfg.max_text_len, t)
    tower("text_model", t, cfg.text_depth)
    sd["text_model.final_layer_norm.weight"] = rnd(t, mean=1.0)
    sd["text_model.final_layer_norm.bias"] = rnd(t)
    sd["vision_model.embeddings.class_embedding"] = rnd(v)
    sd["vision_model.embeddings.patch_embedding.weight"] = rnd(
        v, 3, cfg.patch_size, cfg.patch_size)
    sd["vision_model.embeddings.position_embedding.weight"] = rnd(
        cfg.num_patches + 1, v)
    sd["vision_model.pre_layrnorm.weight"] = rnd(v, mean=1.0)
    sd["vision_model.pre_layrnorm.bias"] = rnd(v)
    tower("vision_model", v, cfg.vision_depth)
    sd["vision_model.post_layernorm.weight"] = rnd(v, mean=1.0)
    sd["vision_model.post_layernorm.bias"] = rnd(v)
    sd["visual_projection.weight"] = rnd(cfg.projection_dim, v)
    sd["text_projection.weight"] = rnd(cfg.projection_dim, t)
    sd["logit_scale"] = torch.tensor(2.6592)
    return sd

class SyntheticVideo:
    """An in-memory decoder: 600 seeded BGR frames of 288×512, a
    textured background with a red square crossing it, served with the
    ``VideoReader`` interface ``Phase1Scan`` uses."""

    sample_rate = 1

    def __init__(self, np, seed: int = 0) -> None:
        self.np = np
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W]
        # the seed also shifts the pattern's phase (not at seed 0), so
        # the library's videos differ in more than their noise
        base = np.stack([60 + 40 * np.sin(xx / 23.0 + seed),
                         90 + 50 * np.cos(yy / 17.0 + 2 * seed),
                         120 + 30 * np.sin((xx + yy) / 41.0 + 3 * seed)], -1)
        self.background = np.clip(base + rng.normal(0, 12, base.shape),
                                  0, 255).astype(np.uint8)
        self.seed = seed

    def expected_sample_count(self, path: str) -> int:
        return N_FRAMES

    def _chunk(self, lo: int, hi: int):
        np = self.np
        rng = np.random.default_rng((self.seed, lo))
        frames = np.repeat(self.background[None], hi - lo, axis=0)
        noise = rng.integers(-6, 7, frames.shape, dtype=np.int16)
        frames = np.clip(frames + noise, 0, 255).astype(np.uint8)
        for i in range(lo, hi):
            x = int(i / (N_FRAMES - 1) * (FRAME_W - 64))
            frames[i - lo, 100:164, x:x + 64] = (30, 30, 220)   # BGR red
        return frames

    def stream_frames(self, path: str, chunk: int = 256, finish=None,
                      **_):
        self.chunk = chunk
        for lo in range(0, N_FRAMES, chunk):
            hi = min(lo + chunk, N_FRAMES)
            frames = self._chunk(lo, hi)
            ts = [i / FPS for i in range(lo, hi)]
            yield (finish(frames, ts) if finish is not None else frames), ts

    def stream_batches(self, path: str, batch: int, sample_rate=None,
                       max_frames=None):
        """The detection path's ``VideoReader.stream_batches``: RGB frames
        at the reader's sampled indices (every ``sample_rate``-th, spread
        evenly under ``max_frames``), in exact ``batch``-sized pairs of
        (frames, timestamps); the pixels are the 256-frame stream's."""
        from avede_tpu_torch.io.video_reader import sample_indices

        np, step = self.np, 256
        idx = sample_indices(N_FRAMES, sample_rate or self.sample_rate,
                             max_frames or N_FRAMES)
        chunks = {lo: self._chunk(lo, min(lo + step, N_FRAMES))[..., ::-1]
                  for lo in sorted({i - i % step for i in idx})}
        for lo in range(0, len(idx), batch):
            part = idx[lo: lo + batch]
            yield (np.ascontiguousarray(np.stack(
                [chunks[i - i % step][i % step] for i in part])),
                [i / FPS for i in part])

    def read_frames_at(self, path: str, timestamps, return_ok: bool = False):
        """RGB frames at ``timestamps``, the pixels the last stream gave
        (each frame's chunk is made again at that stream's chunk size);
        ``frames_read`` counts them."""
        np, step = self.np, getattr(self, "chunk", 256)
        self.frames_read = getattr(self, "frames_read", 0) + len(timestamps)
        idx = [min(max(int(round(t * FPS)), 0), N_FRAMES - 1)
               for t in timestamps]
        out = np.zeros((len(idx), FRAME_H, FRAME_W, 3), np.uint8)
        for lo in sorted({i - i % step for i in idx}):
            frames = self._chunk(lo, min(lo + step, N_FRAMES))
            for n, i in enumerate(idx):
                if lo <= i < lo + step:
                    out[n] = frames[i - lo, :, :, ::-1]
        return (out, np.ones(len(idx), bool)) if return_ok else out


def check_kernels(torch, np, video):
    """Phase 3: each kernel against its plain version at main-path
    shapes, with times of kernel, plain version and library call."""
    import torch.nn.functional as F

    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.ops.preprocess import (clip_preprocess_i420,
                                                pack_frames_i420)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    # 1. fused patch embed at the 128-frame bucket of the sparse cold
    # scan, from real packed frames. (a) the serving entry: packed I420
    # in, bf16 tokens out; (b) the TPU kernel's contract: the same frames
    # unpacked to 0..255 f32 (and rounded to uint8), f32 out. Both run
    # bf16 x3 on the tensor cores (two passes for uint8).
    n, s, p, d = 128, 224, 32, 768
    packed = torch.from_numpy(pack_frames_i420(video._chunk(0, n), s,
                                               src="bgr")).to(dev)
    frames = (clip_preprocess_i420(packed, normalize=False) * 255.0
              ).contiguous()
    kernel = torch.randn(p, p, 3, d, device=dev, generator=gen) \
        * (3 * p * p) ** -0.5
    w2, b2 = kernels.fold_for_uint8(kernel)
    w2, b2 = w2.contiguous(), b2.contiguous()
    split = kernels.split_patch_weights(w2, p)
    gg, k = (s // p) ** 2, p * p * 3
    w_oihw = w2.reshape(p, p, 3, d).permute(3, 2, 0, 1).contiguous()
    gemm = 2.0 * n * gg * k * d
    tensor_peak = "bf16 tensor cores 989 TFLOP/s"

    got = kernels.fused_patch_embed_i420(packed, w2, b2, p, split)
    ref = kernels.fused_patch_embed_i420_plain(packed, w2, b2, p,
                                               torch.float32)
    err, excess, unequal = bf16_err(torch, got, ref, TOL_REL)
    w_bf = w_oihw.to(torch.bfloat16)
    b, f = bound_ms(packed.numel() + 2 * 2 * w2.numel() + 4 * d
                    + 2 * n * gg * d, 3 * gemm, BF16_TENSOR_FLOP_PER_S)
    rows.append(dict(
        name="fused_patch_embed_i420", route="cuda",
        source="avede_tpu_torch/csrc/patch_embed.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:95",
        shape=f"packed I420 u8 [{n},{s * 3 // 2},{s}] x W' [{k},{d}] "
              f"-> bf16 [{n},{gg},{d}]",
        max_abs_err=err, tol="1 bf16 ulp + 1e-4*max|plain| + 1e-5",
        tol_excess=excess, not_bit_equal=unequal,
        ms=time_ms(torch, lambda: kernels.fused_patch_embed_i420(
            packed, w2, b2, p, split)),
        call_ms=call_ms(torch, lambda: kernels.fused_patch_embed_i420(
            packed, w2, b2, p, split)),
        plain_ms=time_ms(torch, lambda: kernels.fused_patch_embed_i420_plain(
            packed, w2, b2, p)),
        bound_ms=b, bound_by=f, bound_peak=tensor_peak, bound_passes=3,
        library_ms=None,
        library="null: no single PyTorch call unpacks I420",
        yardstick_ms=time_ms(torch, lambda: F.conv2d(
            (clip_preprocess_i420(packed, normalize=False) * 255.0
             ).permute(0, 3, 1, 2).to(torch.bfloat16), w_bf,
            b2.to(torch.bfloat16), stride=p)),
        yardstick="clip_preprocess_i420(normalize=False)*255 + F.conv2d "
                  "in bf16 (cuDNN)"))
    if excess > 0:
        fail(f"fused_patch_embed_i420: max err {err} over its bar by "
             f"{excess}")

    got = kernels.fused_patch_embed(frames, w2, b2, p, split)
    ref = kernels.fused_patch_embed_plain(frames, w2, b2, p)
    err, tol = max_err(torch, got, ref)
    u8 = frames.round().clamp(0, 255).to(torch.uint8)
    err_u8, tol_u8 = max_err(torch, kernels.fused_patch_embed(
        u8, w2, b2, p, split), kernels.fused_patch_embed_plain(u8, w2, b2, p))
    x_nchw = frames.permute(0, 3, 1, 2)
    b, f = bound_ms(4 * (frames.numel() + b2.numel() + n * gg * d)
                    + 2 * 2 * w2.numel(), 3 * gemm, BF16_TENSOR_FLOP_PER_S)
    rows.append(dict(
        name="fused_patch_embed", route="cuda",
        source="avede_tpu_torch/csrc/patch_embed.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:95",
        shape=f"frames f32 [{n},{s},{s},3] x W' [{k},{d}] -> f32",
        max_abs_err=err, tol=tol, u8_max_abs_err=err_u8,
        ms=time_ms(torch, lambda: kernels.fused_patch_embed(
            frames, w2, b2, p, split)),
        u8_ms=time_ms(torch, lambda: kernels.fused_patch_embed(
            u8, w2, b2, p, split)),
        call_ms=call_ms(torch, lambda: kernels.fused_patch_embed(
            frames, w2, b2, p, split)),
        plain_ms=time_ms(torch, lambda: kernels.fused_patch_embed_plain(
            frames, w2, b2, p)),
        bound_ms=b, bound_by=f, bound_peak=tensor_peak, bound_passes=3,
        library_ms=time_ms(torch, lambda: F.conv2d(
            x_nchw, w_oihw, b2, stride=p)),
        library="torch.nn.functional.conv2d (cuDNN, TF32 off)"))
    if err > tol or err_u8 > tol_u8:
        fail(f"fused_patch_embed: max err {err} (u8 {err_u8}) > {tol}")
    del frames, u8, x_nchw

    # 2. flash attention: one vision layer of the 128-frame bucket.
    # (a) the serving entry: bf16 q, k, v in the projections' [B, L, H,
    # hd] layout, bf16 [B, L, H*hd] out; (b) the TPU kernel's contract:
    # f32 [B, H, L, D].
    bsz, h, length, hd = 128, 12, 50, 64
    q, kk, v = (torch.randn(bsz, length, h, hd, device=dev, generator=gen
                            ).to(torch.bfloat16) for _ in range(3))
    got = attention.flash_attention_blhd(q, kk, v)
    ref = attention.flash_attention_blhd_plain(q.float(), kk.float(),
                                               v.float())
    err, excess, unequal = bf16_err(torch, got, ref)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    # the function's q.k and p.v, once each (the kernel's second p.v
    # pass, for P's low bf16 term, is its design's overhead)
    b, f = bound_ms(2 * 4 * q.numel(), 4.0 * bsz * h * length * length * hd,
                    BF16_TENSOR_FLOP_PER_S)
    rows.append(dict(
        name="flash_attention_blhd", route="cuda",
        source="avede_tpu_torch/csrc/flash_attention.cu",
        replaces="avede_tpu/ops/attention.py:85",
        shape=f"q,k,v bf16 [{bsz},{length},{h},{hd}] -> bf16 "
              f"[{bsz},{length},{h * hd}]",
        max_abs_err=err, tol="1 bf16 ulp + 1e-5", tol_excess=excess,
        not_bit_equal=unequal,
        ms=time_ms(torch, lambda: attention.flash_attention_blhd(q, kk, v)),
        call_ms=call_ms(torch, lambda: attention.flash_attention_blhd(
            q, kk, v)),
        plain_ms=time_ms(torch, lambda: attention.flash_attention_blhd_plain(
            q, kk, v)),
        bound_ms=b, bound_by=f, bound_peak=tensor_peak, bound_passes=1,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
        library="torch.nn.functional.scaled_dot_product_attention on the "
                "bf16 [B, H, L, D] views"))
    if excess > 0:
        fail(f"flash_attention_blhd: max err {err} over its bar by {excess}")

    q, kk, v = (torch.randn(bsz, h, length, hd, device=dev, generator=gen)
                for _ in range(3))
    got = attention.flash_attention(q, kk, v)
    ref = attention.attention_reference(q, kk, v)
    err, tol = max_err(torch, got, ref)
    b, f = bound_ms(4 * 4 * q.numel(), 4.0 * bsz * h * length * length * hd)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="avede_tpu_torch/csrc/flash_attention.cu",
        replaces="avede_tpu/ops/attention.py:85",
        shape=f"q,k,v f32 [{bsz},{h},{length},{hd}]",
        max_abs_err=err, tol=tol,
        ms=time_ms(torch, lambda: attention.flash_attention(q, kk, v)),
        call_ms=call_ms(torch, lambda: attention.flash_attention(q, kk, v)),
        plain_ms=time_ms(torch, lambda: attention.attention_reference(
            q, kk, v)),
        bound_ms=b, bound_by=f, bound_peak="f32 67 TFLOP/s",
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, kk, v)),
        library="torch.nn.functional.scaled_dot_product_attention"))
    if err > tol:
        fail(f"flash_attention: max err {err} > {tol}")
    rows.append(check_blip_flash(torch, F, dev, gen))
    rows.append(check_blip_flash(torch, F, dev, gen, BLIP2_FLASH,
                                 BLIP2_TOKENS, 16, 88))
    # the detection path: OWL-ViT's batch, the CLIP grid's cells of a
    # 16-frame batch and the largest crop bucket
    rows.append(check_blhd_flash(torch, F, dev, gen, OWL_FLASH,
                                 DETECTION_BATCH, OWL_TOKENS))
    rows.append(check_blhd_flash(torch, F, dev, gen, GRID_FLASH,
                                 DETECTION_BATCH * 8 * 8, CLIP_TOKENS))
    rows.append(check_blhd_flash(torch, F, dev, gen, CROP_FLASH,
                                 CROP_BUCKET, CLIP_TOKENS))
    # image query: the reference image alone and one frame's crops
    rows.append(check_blhd_flash(torch, F, dev, gen, REF_FLASH, 1,
                                 CLIP_TOKENS))
    rows.append(check_blhd_flash(torch, F, dev, gen, CROPS16_FLASH, 16,
                                 CLIP_TOKENS))
    # the detection eval mode's OWL-ViT: one frame, 4 heads of 24
    rows.append(check_blhd_flash(torch, F, dev, gen, DET_FLASH, 1,
                                 DET_OWL_TOKENS, h=4, hd=24))

    # 3. cosine scores: the 1024-row bucket of a 600-frame table
    nb, dim, n_valid = 1024, 512, N_FRAMES
    emb = F.normalize(torch.randn(nb, dim, device=dev, generator=gen), dim=1)
    qv = F.normalize(torch.randn(dim, device=dev, generator=gen), dim=0)
    valid = torch.arange(nb, device=dev) < n_valid
    invalid = ~valid
    got = kernels.cosine_scores(emb, qv, valid)
    ref = kernels.cosine_scores_plain(emb, qv[None], valid)[:, 0]
    err, tol = max_err(torch, got, ref)
    b, f = bound_ms(4 * (emb.numel() + dim + nb) + nb, 2.0 * nb * dim)
    rows.append(dict(
        name="cosine_scores", route="cuda",
        source="avede_tpu_torch/csrc/cosine_scores.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:139",
        shape=f"table f32 [{nb},{dim}] x query [{dim}], valid mask",
        max_abs_err=err, tol=tol,
        ms=time_ms(torch, lambda: kernels.cosine_scores(emb, qv, valid),
                   iters=200),
        call_ms=call_ms(torch, lambda: kernels.cosine_scores(
            emb, qv, valid), iters=200),
        plain_ms=time_ms(torch, lambda: kernels.cosine_scores_plain(
            emb, qv[None], valid), iters=200),
        bound_ms=b, bound_by=f, bound_peak="f32 67 TFLOP/s",
        bound_passes=1, library_ms=None,
        library=NO_MASKED_MV,
        yardstick_ms=time_ms(torch, lambda: torch.mv(emb, qv).masked_fill_(
            invalid, float("-inf")), iters=200),
        yardstick="torch.mv + masked_fill_ (two calls)"))
    if err > tol:
        fail(f"cosine_scores: max err {err} > {tol}")
    rows.append(check_window_topk(torch, F, dev, gen, emb, valid))
    del emb

    rows += check_library_kernels(torch, F, dev, gen)
    rows += check_tiny_kernels(torch, F, dev, gen, video)
    return rows


def check_tiny_kernels(torch, F, dev, gen, video):
    """Phase 3, rows 1c and 2j: the eval modes' tiny towers (32 px, patch
    8, width 64, 4 heads of 16) at the eval path's batch. 1c: the I420
    serving entry on real packed frames [N, 48, 32] → bf16 [N, 16, 64],
    which the wgmma tile does not take (P = 8, D = 64): the simple
    kernel; same bar as row 1, the same unpack + bf16 ``F.conv2d``
    yardstick. 2j: the bf16 flash entry at [N, 17, 4, 16] (contiguous
    heads, row stride 64), one key tile holding 17 keys; same bar as row
    2, SDPA its library call."""
    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.ops.preprocess import (clip_preprocess_i420,
                                                pack_frames_i420)

    n, s, p, d = TINY_BATCH, 32, 8, 64
    packed = torch.from_numpy(pack_frames_i420(video._chunk(0, n), s,
                                               src="bgr")).to(dev)
    kernel = torch.randn(p, p, 3, d, device=dev, generator=gen) \
        * (3 * p * p) ** -0.5
    w2, b2 = kernels.fold_for_uint8(kernel)
    w2, b2 = w2.contiguous(), b2.contiguous()
    split = kernels.split_patch_weights(w2, p)
    gg, k = (s // p) ** 2, p * p * 3
    before = kernels.fused_patch_embed_i420.launches_by_kernel["simt"]
    got = kernels.fused_patch_embed_i420(packed, w2, b2, p, split)
    if kernels.fused_patch_embed_i420.launches_by_kernel["simt"] \
            != before + 1:
        fail(f"{TINY_PATCH}: the simple kernel did not launch")
    ref = kernels.fused_patch_embed_i420_plain(packed, w2, b2, p,
                                               torch.float32)
    err, excess, unequal = bf16_err(torch, got, ref, TOL_REL)
    w_bf = w2.reshape(p, p, 3, d).permute(3, 2, 0, 1).to(torch.bfloat16)
    b, f = bound_ms(packed.numel() + 2 * 2 * w2.numel() + 4 * d
                    + 2 * n * gg * d, 3 * 2.0 * n * gg * k * d,
                    BF16_TENSOR_FLOP_PER_S)
    rows = [dict(
        name=TINY_PATCH, route="cuda",
        source="avede_tpu_torch/csrc/patch_embed.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:95",
        shape=f"packed I420 u8 [{n},{s * 3 // 2},{s}] x W' [{k},{d}] "
              f"-> bf16 [{n},{gg},{d}] (patch {p}: the simple kernel)",
        max_abs_err=err, tol="1 bf16 ulp + 1e-4*max|plain| + 1e-5",
        tol_excess=excess, not_bit_equal=unequal,
        ms=time_ms(torch, lambda: kernels.fused_patch_embed_i420(
            packed, w2, b2, p, split), iters=200),
        call_ms=call_ms(torch, lambda: kernels.fused_patch_embed_i420(
            packed, w2, b2, p, split), iters=200),
        plain_ms=time_ms(torch, lambda: kernels.fused_patch_embed_i420_plain(
            packed, w2, b2, p), iters=200),
        bound_ms=b, bound_by=f, bound_peak="bf16 tensor cores 989 TFLOP/s",
        bound_passes=3, library_ms=None,
        library="null: no single PyTorch call unpacks I420",
        yardstick_ms=time_ms(torch, lambda: F.conv2d(
            (clip_preprocess_i420(packed, normalize=False) * 255.0
             ).permute(0, 3, 1, 2).to(torch.bfloat16), w_bf,
            b2.to(torch.bfloat16), stride=p), iters=200),
        yardstick="clip_preprocess_i420(normalize=False)*255 + F.conv2d "
                  "in bf16 (cuDNN)")]
    if excess > 0:
        fail(f"{TINY_PATCH}: max err {err} over its bar by {excess}")

    h, hd, length = 4, 16, TINY_TOKENS
    q, kk, v = (torch.randn(n, length, h * hd, device=dev, generator=gen
                            ).to(torch.bfloat16).view(n, length, h, hd)
                for _ in range(3))
    got = attention.flash_attention_blhd(q, kk, v)
    ref = attention.flash_attention_blhd_plain(q.float(), kk.float(),
                                               v.float())
    err, excess, unequal = bf16_err(torch, got, ref)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    b, f = bound_ms(2 * 4 * q.numel(), 4.0 * n * h * length * length * hd,
                    BF16_TENSOR_FLOP_PER_S)
    rows.append(dict(
        name=TINY_FLASH, route="cuda",
        source="avede_tpu_torch/csrc/flash_attention.cu",
        replaces="avede_tpu/ops/attention.py:85",
        shape=f"q,k,v bf16 [{n},{length},{h},{hd}] (row stride {h * hd}) "
              f"-> bf16 [{n},{length},{h * hd}] (the hd = 16 instantiation)",
        max_abs_err=err, tol="1 bf16 ulp + 1e-5", tol_excess=excess,
        not_bit_equal=unequal,
        ms=time_ms(torch, lambda: attention.flash_attention_blhd(q, kk, v),
                   iters=200),
        call_ms=call_ms(torch, lambda: attention.flash_attention_blhd(
            q, kk, v), iters=200),
        plain_ms=time_ms(torch, lambda: attention.flash_attention_blhd_plain(
            q, kk, v), iters=200),
        bound_ms=b, bound_by=f, bound_peak="bf16 tensor cores 989 TFLOP/s",
        bound_passes=1,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt), iters=200),
        library="torch.nn.functional.scaled_dot_product_attention on the "
                "bf16 [B, H, L, D] views"))
    if excess > 0:
        fail(f"{TINY_FLASH}: max err {err} over its bar by {excess}")
    return rows


def check_blip_flash(torch, F, dev, gen, name=BLIP_FLASH,
                     length=BLIP_TOKENS, h=12, hd=64):
    """Phase 3, rows 2c and 2i: the serving flash entry at a BLIP vision
    tower's shape, 2 x TOP_K_RESULTS candidates, q, k and v the thirds of
    one fused qkv projection read in place (row stride 3 x h x hd), as the
    reranked path runs it: BLIP-base's [30, 577, 12, 64] (row stride
    2304) and BLIP-2's ViT-g [30, 257, 16, 88] (row stride 4224; the
    entry's hd = 88 instantiation). Same bar as the CLIP row."""
    from avede_tpu_torch.ops import attention
    from avede_tpu_torch.utils.config import settings

    bsz = 2 * settings.TOP_K_RESULTS
    qkv = torch.randn(bsz, length, 3 * h * hd, device=dev, generator=gen
                      ).to(torch.bfloat16)
    q, kk, v = (t.unflatten(-1, (h, hd)) for t in qkv.chunk(3, dim=-1))
    got = attention.flash_attention_blhd(q, kk, v)
    ref = attention.flash_attention_blhd_plain(q.float(), kk.float(),
                                               v.float())
    err, excess, unequal = bf16_err(torch, got, ref)
    del ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    # q, k, v read once and the output written once; q.k and p.v once
    # each on the tensor cores, as for the CLIP row
    b, f = bound_ms(2 * 4 * q.numel(), 4.0 * bsz * h * length * length * hd,
                    BF16_TENSOR_FLOP_PER_S)
    row = dict(
        name=name, route="cuda",
        source="avede_tpu_torch/csrc/flash_attention.cu",
        replaces="avede_tpu/ops/attention.py:85",
        shape=f"q,k,v bf16 [{bsz},{length},{h},{hd}], thirds of a fused "
              f"qkv [{bsz},{length},{3 * h * hd}] -> bf16 "
              f"[{bsz},{length},{h * hd}]",
        max_abs_err=err, tol="1 bf16 ulp + 1e-5", tol_excess=excess,
        not_bit_equal=unequal,
        ms=time_ms(torch, lambda: attention.flash_attention_blhd(q, kk, v)),
        call_ms=call_ms(torch, lambda: attention.flash_attention_blhd(
            q, kk, v)),
        plain_ms=time_ms(torch, lambda: attention.flash_attention_blhd_plain(
            q, kk, v), iters=5),
        bound_ms=b, bound_by=f, bound_peak="bf16 tensor cores 989 TFLOP/s",
        bound_passes=1,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
        library="torch.nn.functional.scaled_dot_product_attention on the "
                "bf16 [B, H, L, D] views")
    if excess > 0:
        fail(f"{name}: max err {err} over its bar by {excess}")
    return row


def check_blhd_flash(torch, F, dev, gen, name, bsz, length, h=12, hd=64):
    """Phase 3, a detection row of the serving flash entry: [bsz,
    length, h, hd], q, k and v each a projection's own [B, L, h·hd]
    output viewed per head (contiguous heads, row stride h·hd), as the
    detection path runs it: 12 heads of 64 at width 768, or the
    ``detection`` eval mode's OWL-ViT, 4 heads of 24 (row 2k, the entry's
    hd = 24 instantiation). Same bar as the CLIP row."""
    from avede_tpu_torch.ops import attention

    q, kk, v = (torch.randn(bsz, length, h * hd, device=dev, generator=gen
                            ).to(torch.bfloat16).view(bsz, length, h, hd)
                for _ in range(3))
    got = attention.flash_attention_blhd(q, kk, v)
    ref = attention.flash_attention_blhd_plain(q.float(), kk.float(),
                                               v.float())
    err, excess, unequal = bf16_err(torch, got, ref)
    del ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    b, f = bound_ms(2 * 4 * q.numel(), 4.0 * bsz * h * length * length * hd,
                    BF16_TENSOR_FLOP_PER_S)
    row = dict(
        name=name, route="cuda",
        source="avede_tpu_torch/csrc/flash_attention.cu",
        replaces="avede_tpu/ops/attention.py:85",
        shape=f"q,k,v bf16 [{bsz},{length},{h},{hd}] (row stride "
              f"{h * hd}) -> bf16 [{bsz},{length},{h * hd}]",
        max_abs_err=err, tol="1 bf16 ulp + 1e-5", tol_excess=excess,
        not_bit_equal=unequal,
        ms=time_ms(torch, lambda: attention.flash_attention_blhd(q, kk, v)),
        call_ms=call_ms(torch, lambda: attention.flash_attention_blhd(
            q, kk, v)),
        plain_ms=time_ms(torch, lambda: attention.flash_attention_blhd_plain(
            q, kk, v), iters=5),
        bound_ms=b, bound_by=f, bound_peak="bf16 tensor cores 989 TFLOP/s",
        bound_passes=1,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt)),
        library="torch.nn.functional.scaled_dot_product_attention on the "
                "bf16 [B, H, L, D] views")
    if excess > 0:
        fail(f"{name}: max err {err} over its bar by {excess}")
    return row


def exact_pair(torch, what, got, ref) -> None:
    """Fail unless (values, indices) equal ``ref`` bit for bit."""
    if got[0].shape != ref[0].shape or got[1].shape != ref[1].shape \
            or not torch.equal(got[0].view(torch.int32),
                               ref[0].view(torch.int32)) \
            or not torch.equal(got[1], ref[1]):
        fail(f"{what}: fused (values, indices) != topk_scores of the "
             f"contract entry")


def check_window_topk(torch, F, dev, gen, emb, valid):
    """Phase 3, the mvp serving entry: the main path's 74 windows of the
    1024-row table (bucket 128), k = 10; also Q = 4 and W = 5000 (the
    running merge). Bar: bit-for-bit ``topk_scores`` of the contract
    entry after the window gather."""
    from avede_tpu_torch.ops import kernels
    from avede_tpu_torch.ops.windows import window_middle_indices
    from avede_tpu_torch.utils.config import settings

    nb, dim, k = emb.shape[0], emb.shape[1], 10
    w_mids = window_middle_indices(N_FRAMES, settings.WINDOW_SIZE,
                                   settings.WINDOW_STRIDE)
    mids = torch.full((128,), -1, dtype=torch.int32, device=dev)
    mids[:len(w_mids)] = torch.from_numpy(w_mids.astype("int32")).to(dev)
    qs = F.normalize(torch.randn(4, dim, device=dev, generator=gen), dim=1)

    def contract(q, m, kk):
        s = kernels.cosine_scores(emb, q, valid)
        return kernels.topk_scores(kernels.window_scores(s, m).T, kk)

    def yardstick(q, m, kk):
        s = kernels.cosine_scores(emb, q, valid)
        return torch.topk(kernels.window_scores(s, m).T, kk, sorted=True)

    q1 = qs[:1]
    exact_pair(torch, "cosine_window_topk", kernels.cosine_window_topk(
        emb, valid, q1, mids, k), contract(q1, mids, k))
    exact_pair(torch, "cosine_window_topk Q=4", kernels.cosine_window_topk(
        emb, valid, qs, mids, 5), contract(qs, mids, 5))
    big = torch.randint(-1, nb, (5000,), device=dev, generator=gen,
                        dtype=torch.int32)
    exact_pair(torch, "cosine_window_topk W=5000", kernels.cosine_window_topk(
        emb, valid, q1, big, 1024), contract(q1, big, 1024))

    used = int((mids >= 0).sum())
    # the gathered rows, their mask bytes, the query, mids and the output
    b, f = bound_ms(4 * used * dim + used + 4 * dim + 4 * mids.numel()
                    + 12 * k, 2.0 * used * dim)
    return dict(
        name="cosine_window_topk", route="cuda",
        source="avede_tpu_torch/csrc/cosine_scores.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:139",
        shape=f"table f32 [{nb},{dim}], valid, {used} window middles in "
              f"mids [{mids.numel()}], query [{dim}], k {k}",
        max_abs_err=0.0, tol="bit-equal to topk_scores(contract entry)",
        exact=True,
        ms=time_ms(torch, lambda: kernels.cosine_window_topk(
            emb, valid, q1, mids, k), iters=200),
        call_ms=call_ms(torch, lambda: kernels.cosine_window_topk(
            emb, valid, q1, mids, k), iters=200),
        plain_ms=time_ms(torch, lambda: kernels.cosine_window_topk_plain(
            emb, valid, q1, mids, k), iters=200),
        q4_ms=time_ms(torch, lambda: kernels.cosine_window_topk(
            emb, valid, qs, mids, 5), iters=200),
        w5000_k1024_ms=time_ms(torch, lambda: kernels.cosine_window_topk(
            emb, valid, q1, big, 1024)),
        bound_ms=b, bound_by=f, bound_peak="f32 67 TFLOP/s",
        bound_passes=1, library_ms=None,
        library="null: no single PyTorch call scores, masks, gathers and "
                "selects",
        yardstick_ms=time_ms(torch, lambda: yardstick(q1, mids, k),
                             iters=200),
        yardstick="cosine_scores (contract) + gather + torch.topk("
                  "sorted=True), unstable order",
        contract_sort_ms=time_ms(torch, lambda: contract(q1, mids, k),
                                 iters=200),
        contract_sort="cosine_scores (contract) + gather + topk_scores: the "
                      "path before the fused entry")


def check_library_kernels(torch, F, dev, gen):
    """Phase 3, library rows: the bf16 and int8 cosine entries at the
    index's serving size, and the quantize kernel at the shapes of an
    add-block, of growth and of the TPU kernel's own contract (exact)."""
    from avede_tpu_torch.ops import kernels, quant

    rows = []
    nb, dim = INDEX_CAPACITY, 512
    # spans of 1000 rows padded to 1024, as the index holds them
    valid = (torch.arange(nb, device=dev) % 1024) < 1000
    qv = F.normalize(torch.randn(dim, device=dev, generator=gen), dim=0)
    q_bf = qv.to(torch.bfloat16)
    invalid = ~valid
    emb = F.normalize(torch.randn(nb, dim, device=dev, generator=gen), dim=1)
    table_i8, scales = quant.quantize_rows(emb)
    table_bf = emb.to(torch.bfloat16)
    rows.append(fused_topk_row(
        torch, "cosine_topk_f32", kernels.cosine_topk_f32,
        kernels.cosine_topk_f32_plain, kernels.cosine_scores, (emb,), qv,
        valid, 4 * emb.numel(),
        f"table f32 [{nb},{dim}] x query [{dim}], valid mask"))
    del emb
    mask_out = nb + 4 * nb + 4 * dim            # mask + scores + query

    got = kernels.cosine_scores_bf16(table_bf, qv, valid)
    ref = kernels.cosine_scores_bf16_plain(table_bf, qv[None], valid)[:, 0]
    err, tol = max_err(torch, got, ref)
    b, f = bound_ms(2 * table_bf.numel() + mask_out, 2.0 * nb * dim)
    rows.append(dict(
        name="cosine_scores_bf16", route="cuda",
        source="avede_tpu_torch/csrc/cosine_scores.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:139",
        shape=f"table bf16 [{nb},{dim}] x query [{dim}], valid mask",
        max_abs_err=err, tol=tol,
        ms=time_ms(torch, lambda: kernels.cosine_scores_bf16(
            table_bf, qv, valid)),
        call_ms=call_ms(torch, lambda: kernels.cosine_scores_bf16(
            table_bf, qv, valid)),
        plain_ms=time_ms(torch, lambda: kernels.cosine_scores_bf16_plain(
            table_bf, qv[None], valid), iters=3),
        bound_ms=b, bound_by=f, bound_peak="f32 67 TFLOP/s",
        bound_passes=1, library_ms=None,
        library=NO_MASKED_MV + "; torch.mv on bf16 also returns bf16 "
                               "scores",
        yardstick_ms=time_ms(torch, lambda: torch.mv(
            table_bf, q_bf).masked_fill_(invalid, float("-inf"))),
        yardstick="torch.mv (bf16 scores) + masked_fill_ (two calls)"))
    if err > tol:
        fail(f"cosine_scores_bf16: max err {err} > {tol}")
    rows.append(fused_topk_row(
        torch, "cosine_topk_bf16", kernels.cosine_topk_bf16,
        kernels.cosine_topk_bf16_plain, kernels.cosine_scores_bf16,
        (table_bf,), qv, valid, 2 * table_bf.numel(),
        f"table bf16 [{nb},{dim}] x query [{dim}], valid mask"))
    del table_bf

    got = kernels.cosine_scores_int8(table_i8, scales, qv, valid)
    ref = kernels.cosine_scores_int8_plain(table_i8, scales, qv[None],
                                           valid)[:, 0]
    err, tol = max_err(torch, got, ref)
    b, f = bound_ms(table_i8.numel() + 4 * nb + mask_out, 2.0 * nb * dim)
    rows.append(dict(
        name="cosine_scores_int8", route="cuda",
        source="avede_tpu_torch/csrc/cosine_scores.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:139",
        shape=f"table int8 [{nb},{dim}] + scales [{nb}] x query [{dim}], "
              f"valid mask",
        max_abs_err=err, tol=tol,
        ms=time_ms(torch, lambda: kernels.cosine_scores_int8(
            table_i8, scales, qv, valid)),
        call_ms=call_ms(torch, lambda: kernels.cosine_scores_int8(
            table_i8, scales, qv, valid)),
        plain_ms=time_ms(torch, lambda: kernels.cosine_scores_int8_plain(
            table_i8, scales, qv[None], valid), iters=3),
        bound_ms=b, bound_by=f, bound_peak="f32 67 TFLOP/s",
        bound_passes=1, library_ms=None,
        library="null: no PyTorch call takes int8 rows with row scales"))
    if err > tol:
        fail(f"cosine_scores_int8: max err {err} > {tol}")
    rows.append(fused_topk_row(
        torch, "cosine_topk_int8", kernels.cosine_topk_int8,
        kernels.cosine_topk_int8_plain, kernels.cosine_scores_int8,
        (table_i8, scales), qv, valid, table_i8.numel() + 4 * nb,
        f"table int8 [{nb},{dim}] + scales [{nb}] x query [{dim}], "
        f"valid mask"))
    del table_i8, scales

    def quant_case(fn, plain, shape, per_row, iters):
        x = torch.randn(*shape, device=dev, generator=gen) * 0.05
        if per_row:
            x[1] = 0.0                            # a removal's zero row
        else:
            x[:, 1] = 0.0                         # an all-zero column
        q, s = fn(x)
        pq, ps = plain(x)
        if not (torch.equal(q, pq) and torch.equal(s, ps)):
            fail(f"{fn.__name__} {shape}: kernel != plain version "
                 f"({int((q != pq).sum())} values, "
                 f"{int((s != ps).sum())} scales differ)")
        # read 4 B and write 1 B an element, plus the scales; |x|, max,
        # divide, round and clip an element
        b, f = bound_ms(5 * x.numel() + 4 * s.numel(), 5.0 * x.numel())
        out = dict(shape=f"f32 {list(shape)}", max_abs_err=0.0, exact=True,
                   ms=time_ms(torch, lambda: fn(x), iters=iters),
                   call_ms=call_ms(torch, lambda: fn(x), iters=iters),
                   plain_ms=time_ms(torch, lambda: plain(x), iters=3),
                   bound_ms=b, bound_by=f, bound_peak="f32 67 TFLOP/s",
                   bound_passes=1)
        del x
        return out

    big = quant_case(quant.quantize_rows, quant.quantize_rows_plain,
                     (INDEX_ROWS, dim), True, 5)
    rows.append(dict(
        name="quantize_rows", route="cuda",
        source="avede_tpu_torch/csrc/quantize.cu",
        replaces="avede_tpu/ops/quant.py:70", **big,
        library_ms=None,
        library="null: no PyTorch call computes per-row amax/127 "
                "symmetric int8 with its scales",
        add_block=quant_case(quant.quantize_rows, quant.quantize_rows_plain,
                             (768, dim), True, 200)))
    # the TPU kernel's own contract, on thread-block clusters; odd shapes
    # are held exact too
    for shape in ((33, 130), (1, 40), (7, 33), (5001, 70)):
        quant_case(quant.quantize_per_channel,
                   quant.quantize_per_channel_plain, shape, False, 3)
    rows.append(dict(
        name="quantize_per_channel", route="cuda",
        source="avede_tpu_torch/csrc/quantize.cu",
        replaces="avede_tpu/ops/quant.py:70",
        **quant_case(quant.quantize_per_channel,
                     quant.quantize_per_channel_plain, (3072, 768), False,
                     200),
        odd_shapes_exact=[[33, 130], [1, 40], [7, 33], [5001, 70]],
        library_ms=None,
        library="null: no PyTorch call computes per-column amax/127 "
                "symmetric int8 with its scales"))
    return rows


def fused_topk_row(torch, name, fused, plain, contract, tables, qv, valid,
                   table_bytes, shape):
    """A library serving entry at 2^20 rows: bit-for-bit ``topk_scores``
    of its contract entry at k = 64 and k = 1024, timed at k = 64 (the
    index's default search) and 1024 (its widest fused one)."""
    from avede_tpu_torch.ops import kernels

    nb, dim, k = valid.shape[0], qv.shape[0], 64
    for kk in (k, kernels.FUSED_MAX_K):
        exact_pair(torch, f"{name} k={kk}", fused(*tables, qv, valid, kk),
                   kernels.topk_scores(contract(*tables, qv, valid), kk))
    # table (+ scales), mask, query and the output: the scores' scratch
    # is the design's overhead, not the function's
    b, f = bound_ms(table_bytes + nb + 4 * dim + 12 * k, 2.0 * nb * dim)
    return dict(
        name=name, route="cuda",
        source="avede_tpu_torch/csrc/cosine_scores.cu",
        replaces="avede_tpu/ops/pallas_kernels.py:139",
        shape=f"{shape}, k {k}", max_abs_err=0.0,
        tol="bit-equal to topk_scores(contract entry) at k 64 and 1024",
        exact=True,
        ms=time_ms(torch, lambda: fused(*tables, qv, valid, k)),
        k1024_ms=time_ms(torch, lambda: fused(*tables, qv, valid, 1024)),
        call_ms=call_ms(torch, lambda: fused(*tables, qv, valid, k)),
        plain_ms=time_ms(torch, lambda: plain(*tables, qv, valid, k),
                         iters=3),
        bound_ms=b, bound_by=f, bound_peak="f32 67 TFLOP/s",
        bound_passes=1, library_ms=None,
        library="null: no single PyTorch call scores, masks and selects",
        yardstick_ms=time_ms(torch, lambda: torch.topk(
            contract(*tables, qv, valid), k, sorted=True)),
        yardstick="contract entry + torch.topk(sorted=True), unstable "
                  "order",
        contract_sort_ms=time_ms(torch, lambda: kernels.topk_scores(
            contract(*tables, qv, valid), k)),
        contract_sort="contract entry + topk_scores (stable sort): the "
                      "index search before the fused entry")


def check_against_cpu(torch, np, engine, video):
    """Phase 4: bf16 card embeddings vs the CPU f32 plain path on the
    same seeded weights."""
    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.parallel.embed import ClipEngine

    cpu = ClipEngine(cfg=vit_b32(), device="cpu", seed=0)
    frames = video._chunk(0, 300)[::75]                   # 4 frames
    a = engine.embed_frames(frames)
    b = cpu.embed_frames(frames)
    ta, tb = engine.embed_texts(QUERIES), cpu.embed_texts(QUERIES)

    def cos(x, y):
        return (x * y).sum(1) / (np.linalg.norm(x, axis=1)
                                 * np.linalg.norm(y, axis=1))

    img_cos, txt_cos = float(cos(a, b).min()), float(cos(ta, tb).min())
    if not (img_cos >= 0.99 and txt_cos >= 0.99):
        fail(f"card vs CPU cosine: image {img_cos}, text {txt_cos}")
    return {"image_min_cosine": img_cos, "text_min_cosine": txt_cos,
            "frames": len(frames)}


def drive_main_path(torch, np, engine, video, cache_dir):
    """Phase 5: cold scan, warm queries and a multi-query through
    ``Phase1Scan`` at ViT-B/32 width."""
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.ops.windows import window_middle_indices
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.utils.config import settings

    # the contract entries (f32 flash, RGB patch embed, the cosine
    # scores) are counted too: they must stay at 0 on this path
    needed = (kernels.fused_patch_embed_i420, attention.flash_attention_blhd,
              kernels.cosine_window_topk)
    contracts = (kernels.fused_patch_embed, attention.flash_attention,
                 kernels.cosine_scores)
    counted = needed + contracts
    scan = Phase1Scan(engine, reader=video,
                      cache=EmbeddingCache(str(cache_dir)))
    path, vid, top_k = "memory://synthetic-street", "synthetic-street", 10

    reset_launches(counted)
    t0 = time.perf_counter()
    cold = scan.process_video(path, QUERIES[0], top_k=top_k,
                              threshold=-1.0, video_id=vid)
    cold_s = time.perf_counter() - t0
    warm, warm_ms = [], []
    for q in QUERIES + QUERIES:
        t0 = time.perf_counter()
        warm.append(scan.process_video(path, q, top_k=top_k,
                                       threshold=-1.0, video_id=vid))
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    multi = scan.process_queries(path, QUERIES + ["a bright light"],
                                 top_k=5, threshold=-1.0, video_id=vid)
    multi_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches(counted)

    if any(launches[fn.__name__] <= 0 for fn in needed):
        fail(f"a kernel of the main path never launched: {launches}")
    if any(launches[fn.__name__] for fn in contracts):
        fail(f"a contract entry ran on the main path: {launches}")
    for res in [cold] + warm + list(multi.values()):
        conf = [r["confidence"] for r in res]
        if not res or not np.all(np.isfinite(conf)) \
                or conf != sorted(conf, reverse=True):
            fail(f"scores not finite and sorted: {conf}")
    nq = len(QUERIES)
    for i in range(nq):
        if warm[i] != warm[i + nq]:
            fail(f"repeated query {QUERIES[i]!r} gave different results")
    if warm[0] != cold:
        fail("warm result differs from the cold one for the same query")
    # the top windows against a numpy reference on the cached table
    emb, _ = scan.frame_embeddings(path, vid, rows="scan")
    mids = window_middle_indices(len(emb), settings.WINDOW_SIZE,
                                 settings.WINDOW_STRIDE)
    qemb = engine.embed_texts(QUERIES)
    for i in range(nq):
        ref = emb[mids] @ qemb[i]
        order = np.argsort(-ref, kind="stable")[:top_k]
        got = [r["window_index"] for r in warm[i]]
        gap = np.min(np.abs(np.diff(np.sort(ref[order]))))
        if gap > 1e-4 and got != order.tolist():
            fail(f"top windows {got} != numpy reference {order.tolist()}")
        worst = max(abs(r["confidence"] - float(ref[r["window_index"]]))
                    for r in warm[i])
        if worst > 1e-4:
            fail(f"confidence off the numpy reference by {worst}")
    return {
        "cold_scan_s": cold_s,
        "warm_p50_ms": statistics.median(warm_ms),
        "warm_ms": warm_ms,
        "multi_query_ms": multi_ms,
        "windows": int(len(mids)),
        "launches": launches,
        "top_window": cold[0]["window_index"],
    }


class LibraryReader:
    """The ``VideoReader`` interface over one ``SyntheticVideo`` per
    library video, chosen by the path's stem."""

    sample_rate = 1

    def __init__(self, np) -> None:
        self.videos = {vid: SyntheticVideo(np, seed=i + 1)
                       for i, vid in enumerate(LIBRARY_VIDEOS)}

    def expected_sample_count(self, path: str) -> int:
        return N_FRAMES

    def stream_frames(self, path: str, **kwargs):
        return self.videos[Path(path).stem].stream_frames(path, **kwargs)


def library_reference(np, tables, q, top_k, per_video_k, collapse):
    """The host path's answer in numpy: each video's best
    ``per_video_k`` rows, then the global ``top_k``, ties to the lower
    row. With ``collapse`` only run heads compete (a row that differs
    from the one before it), as in the index. → [(score, vid, frame)]."""
    cands = []
    for vid, emb in tables.items():
        s = emb @ q
        rows = np.arange(len(emb))
        if collapse:
            rows = rows[np.r_[True, np.any(emb[1:] != emb[:-1], axis=1)]]
        best = rows[np.argsort(-s[rows], kind="stable")][:per_video_k]
        cands += [(float(s[i]), vid, int(i)) for i in best]
    cands.sort(key=lambda c: -c[0])
    return cands[:top_k]


def check_ranking(what, got, ref, tables, q, tol):
    """``got`` against the reference ranking: the same length, each hit's
    confidence within ``tol`` of its row's f32 score, and each position's
    (video_id, frame_index) the reference's unless the two rows' scores
    are within 2·tol (a near tie that the tier's rounding may swap).
    → the number of positions that match exactly."""
    if len(got) != len(ref):
        fail(f"{what}: {len(got)} hits, reference {len(ref)}")
    exact = 0
    for hit, (score, vid, frame) in zip(got, ref):
        own = float(tables[hit["video_id"]][hit["frame_index"]] @ q)
        if not abs(hit["confidence"] - own) <= tol:
            fail(f"{what}: confidence {hit['confidence']} vs f32 {own}")
        if (hit["video_id"], hit["frame_index"]) == (vid, frame):
            exact += 1
        elif not abs(own - score) <= 2 * tol:
            fail(f"{what}: hit {hit['video_id']}:{hit['frame_index']} "
                 f"({own}) where the reference has {vid}:{frame} ({score})")
    return exact


def drive_library(torch, np, engine, root):
    """Phase 6: whole-library search through ``LibrarySearch`` at
    ViT-B/32 width, in the bfloat16, int8 and float32 tiers of the
    index."""
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.ops import attention, kernels, quant
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.services.library_search import LibrarySearch
    from avede_tpu_torch.utils.config import settings

    videos = root / "library"
    videos.mkdir(parents=True)
    for vid in LIBRARY_VIDEOS:           # list_videos and _resolve find these
        (videos / f"{vid}.mp4").touch()
    settings.VIDEO_DIR = str(videos)
    contracts = (kernels.fused_patch_embed, attention.flash_attention,
                 kernels.cosine_scores, kernels.cosine_scores_bf16,
                 kernels.cosine_scores_int8, quant.quantize_per_channel)
    counted = (kernels.fused_patch_embed_i420, attention.flash_attention_blhd,
               kernels.cosine_window_topk, kernels.cosine_topk_f32,
               kernels.cosine_topk_bf16, kernels.cosine_topk_int8,
               quant.quantize_rows) + contracts
    tier_kernels = {"bfloat16": ("cosine_topk_bf16",),
                    "int8": ("cosine_topk_int8", "quantize_rows"),
                    "float32": ("cosine_topk_f32",)}
    top_k, per_video_k, out = 10, 3, {}
    for dtype, needed in tier_kernels.items():
        settings.LIBRARY_INDEX_DTYPE = dtype
        scan = Phase1Scan(engine, reader=LibraryReader(np), cache=EmbeddingCache(
            str(root / f"library-cache-{dtype}")))
        # a sparse cold scan first, so that ingest backfills this video;
        # the others take the dense scan
        first = str(videos / f"{LIBRARY_VIDEOS[0]}.mp4")
        scan.process_video(first, QUERIES[0], threshold=-1.0,
                           video_id=LIBRARY_VIDEOS[0])
        search = LibrarySearch(scan)
        reset_launches(counted)
        t0 = time.perf_counter()
        cold = search.search(QUERIES[0], top_k=top_k, threshold=-1.0,
                             per_video_k=per_video_k)
        cold_s = time.perf_counter() - t0
        warm, warm_ms = [], []
        for q in QUERIES:
            t0 = time.perf_counter()
            warm.append(search.search(q, top_k=top_k, threshold=-1.0,
                                      per_video_k=per_video_k))
            warm_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches(counted)
        for name in ("fused_patch_embed_i420",
                     "flash_attention_blhd") + needed:
            if launches[name] <= 0:
                fail(f"library ({dtype}): {name} never launched: {launches}")
        if any(launches[fn.__name__] for fn in contracts):
            fail(f"library ({dtype}): a contract entry ran: {launches}")
        if warm[0]["results"] != cold["results"]:
            fail(f"library ({dtype}): warm result differs from the cold one")
        meta = cold["metadata"]
        if meta["videos_searched"] != len(LIBRARY_VIDEOS) \
                or meta["index"]["dtype"] != dtype:
            fail(f"library ({dtype}): metadata {meta}")
        # the host tables (the cache's, completed) and the host path
        tables = {vid: scan.frame_embeddings(str(videos / f"{vid}.mp4"),
                                             vid)[0]
                  for vid in LIBRARY_VIDEOS}
        qemb = engine.embed_texts(QUERIES)
        exact, rows = [], sum(len(t) for t in tables.values())
        for i, res in enumerate(warm):
            q = qemb[i]
            ref = library_reference(np, tables, q, top_k, per_video_k, True)
            exact.append(check_ranking(f"indexed {dtype}",
                                       res["results"], ref, tables, q,
                                       LIBRARY_TOL))
            for hit in res["results"]:   # the index reports run heads
                emb, f = tables[hit["video_id"]], hit["frame_index"]
                if f > 0 and np.array_equal(emb[f], emb[f - 1]):
                    fail(f"library ({dtype}): frame {f} is not a run head")
            host = search.search(QUERIES[i], top_k=top_k, threshold=-1.0,
                                 per_video_k=per_video_k,
                                 video_ids=list(LIBRARY_VIDEOS))
            check_ranking(f"host path {dtype}", host["results"],
                          library_reference(np, tables, q, top_k,
                                            per_video_k, False),
                          tables, q, 1e-5)
        out[dtype] = {
            "cold_s": cold_s, "warm_ms": warm_ms,
            "warm_p50_ms": statistics.median(warm_ms),
            "index_rows": meta["index"]["rows"], "table_rows": rows,
            "capacity": meta["index"]["capacity"],
            "exact_positions": exact, "launches": launches,
        }
    return out


def reset_launches(fns) -> None:
    """Zero each wrapper's count (the bf16 flash entry's, kept by L; the
    patch embed's by kernel too)."""
    for fn in fns:
        if hasattr(fn, "launches_by_length"):
            fn.launches_by_length.clear()
        else:
            fn.launches = 0
        if hasattr(fn, "launches_by_kernel"):
            fn.launches_by_kernel.clear()


def read_launches(fns) -> dict:
    """Each wrapper's count; the bf16 flash entry's, kept by L, is
    summed, and its L = 577, 50, 257, 17 and 65 launches are also given
    apart, as ``FLASH_L577``, ``FLASH_L50``, ``FLASH_L257``,
    ``FLASH_L17`` and ``FLASH_L65``; a patch embed's are also given by
    kernel, as
    ``<name>[wgmma]`` and ``<name>[simt]``."""
    out = {}
    for fn in fns:
        by_len = getattr(fn, "launches_by_length", None)
        if by_len is None:
            out[fn.__name__] = fn.launches
            for kind in ("wgmma", "simt"):
                if hasattr(fn, "launches_by_kernel"):
                    out[f"{fn.__name__}[{kind}]"] = \
                        fn.launches_by_kernel[kind]
            continue
        out[fn.__name__] = by_len.total()
        out[FLASH_L577] = by_len[BLIP_TOKENS]
        out[FLASH_L50] = by_len[CLIP_TOKENS]
        out[FLASH_L257] = by_len[BLIP2_TOKENS]
        out[FLASH_L17] = by_len[TINY_TOKENS]
        out[FLASH_L65] = by_len[DET_OWL_TOKENS]
    return out


def row_cosine(np, a, b) -> float:
    """Least cosine between matching rows of two arrays (last axis)."""
    a = np.asarray(a, np.float64).reshape(-1, a.shape[-1])
    b = np.asarray(b, np.float64).reshape(-1, b.shape[-1])
    return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))).min())


def drive_rerank(torch, np, engine, video, cache_dir):
    """Phase 8: the ``reranked`` and ``advanced`` modes through
    ``VideoProcessor.process_query`` at full width: BLIP-base (random
    weights from seed 0, bf16) behind phase 2, the default grounding head
    (512 → 256, depth 4, 4 heads, 1024 frames; f32) behind phase 3, on
    phase 5's 600-frame source. ``reranked``: one cold call (fresh
    embedding and caption caches), three warm ones. ``advanced``: one
    call on the warm table, whose 4 x top_k candidates miss half the
    cached captions (read by seeks: no scan ran in that request) and
    whose grounding backfills the sparse table by a re-decode, then
    three warm calls."""
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.models.blip import blip_base, init_blip
    from avede_tpu_torch.models.univtg import init_grounding
    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.ops.preprocess import blip_preprocess
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.services import video_processor
    from avede_tpu_torch.utils.config import settings

    # the machine with the card has no cv2: the in-memory source stands
    # in for the container that validate_video would probe
    video_processor.validate_video = lambda path: None
    proc = video_processor.VideoProcessor(engine=engine)
    proc.phase1 = Phase1Scan(engine, reader=video,
                             cache=EmbeddingCache(str(cache_dir)))
    needed = (kernels.fused_patch_embed_i420, attention.flash_attention_blhd,
              kernels.cosine_window_topk)
    contracts = (kernels.fused_patch_embed, attention.flash_attention,
                 kernels.cosine_scores)
    counted = needed + contracts
    path, vid, top_k = "memory://rerank-street", "rerank-street", \
        settings.TOP_K_RESULTS
    t0 = time.perf_counter()
    cap, ground = proc.phase2.captioner, proc.phase3     # build the models
    build_s = time.perf_counter() - t0

    def query(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = proc.process_query(path, QUERIES[0], mode=mode,
                                 threshold=-1.0, extract_clips=False,
                                 video_id=vid)
        torch.cuda.synchronize()
        if out["status"] != "completed":
            fail(f"{mode} query: {out}")
        return out["results"], (time.perf_counter() - t0) * 1e3

    runs, launches = {}, {}
    for mode in ("reranked", "advanced"):
        reset_launches(counted)
        first, first_ms = query(mode)
        launches[mode] = read_launches(counted)
        steps = cap.model.decode_steps
        reset_launches(counted)
        warm = [query(mode) for _ in range(3)]
        launches[f"{mode}_warm"] = read_launches(counted)
        runs[mode] = (first, first_ms, [r for r, _ in warm],
                      [ms for _, ms in warm], steps)

    rer, adv = launches["reranked"], launches["advanced"]
    for name in [fn.__name__ for fn in needed] + [FLASH_L577, FLASH_L50]:
        if rer[name] <= 0:
            fail(f"reranked: {name} never launched on the cold call: {rer}")
    if adv[FLASH_L577] <= 0 or adv["fused_patch_embed_i420"] <= 0:
        fail(f"advanced: no BLIP forward or no backfill embed: {adv}")
    for key, counts in launches.items():
        if any(counts[fn.__name__] for fn in contracts):
            fail(f"{key}: a contract entry ran: {counts}")
        if key.endswith("_warm") and counts[FLASH_L577]:
            fail(f"{key}: BLIP ran on a warm query: {counts}")

    for mode, (first, _, warm, _, _) in runs.items():
        for res in [first] + warm:
            conf = [r["confidence"] for r in res]
            # advanced may drop overlapping segments below top_k
            if not 0 < len(res) <= top_k or not np.all(np.isfinite(conf)) \
                    or conf != sorted(conf, reverse=True):
                fail(f"{mode}: scores not finite and sorted: {conf}")
            for r in res:
                if mode == "reranked" and abs(r["confidence"] - (
                        0.7 * r["clip_score"]
                        + 0.3 * r["caption_similarity"])) > 1e-5:
                    fail(f"reranked: confidence identity broken: {r}")
                if mode == "advanced" and not (
                        r["start_time"] <= r["timestamp"] <= r["end_time"]):
                    fail(f"advanced: anchor outside its segment: {r}")
        if any(w != first for w in warm):
            fail(f"{mode}: repeated queries gave different results")

    # card bf16 against the CPU f32 plain path on the same seeded weights
    frames = np.ascontiguousarray(video._chunk(0, 300)[::150, :, :, ::-1])
    size = cap.cfg.image_size
    cpu = init_blip(blip_base(), seed=0).eval()              # f32
    with torch.inference_mode():
        px_cpu = blip_preprocess(torch.from_numpy(frames), size)
        v_cpu = cpu.encode_vision(px_cpu)
        ids = cpu.generate(px_cpu)
        logits_cpu = cpu(px_cpu, ids)
        px = px_cpu.cuda()
        v_card = cap.model.encode_vision(px).float().cpu()
        logits_card = cap.model(px, ids.cuda()).cpu()
        # the card's own greedy decode (in-place KV cache, cross K/V laid
        # out once) against the card's teacher-forced forward on the
        # tokens it chose: each step's logits and that position's
        text_model = cap.model.text
        step_logits = []

        def recorded_step(*args):
            out = type(text_model).step(text_model, *args)
            step_logits.append(out[:, 0].cpu())
            return out

        text_model.step = recorded_step
        card_ids = cap.model.generate(px)
        del text_model.step
        decoded = torch.stack(step_logits, 1)               # [B, steps, V]
        forced = cap.model(px, card_ids[:, :decoded.shape[1]]).cpu()
    same = (card_ids.cpu() == ids).int().cumprod(1).sum(1)
    emb, _ = proc.phase1.frame_embeddings(path, vid)
    text = engine.embed_texts(QUERIES[0])[0]
    sal, off = ground._forward(emb, text)
    g_cpu = init_grounding(ground.cfg, seed=0).eval()
    with torch.inference_mode():
        ref_sal, ref_off = g_cpu(torch.from_numpy(emb)[None],
                                 torch.from_numpy(text)[None])
    checks = {"blip_vision_min_row_cosine": row_cosine(np, v_card, v_cpu),
              "blip_logits_min_row_cosine": row_cosine(
                  np, logits_card, logits_cpu),
              "grounding_saliency_cosine": row_cosine(
                  np, sal[None], ref_sal.numpy()),
              "grounding_offsets_cosine": row_cosine(
                  np, off.reshape(1, -1), ref_off.numpy().reshape(1, -1)),
              "blip_decode_vs_forced_min_row_cosine": row_cosine(
                  np, decoded.numpy(), forced.numpy()),
              "decode_steps_checked": decoded.shape[1],
              "cpu_greedy_tokens": int((ids[:, 1:] != 0).sum()),
              "card_tokens_equal_cpu_prefix": same.tolist()}
    if min(v for k, v in checks.items() if "cosine" in k) < 0.99:
        fail(f"rerank card vs CPU: {checks}")
    del cpu, g_cpu

    # device times of the pieces on the cold path's shapes
    n_cand = 2 * top_k
    cand = torch.from_numpy(np.repeat(frames, n_cand // 2, axis=0)).cuda()
    with torch.inference_mode():
        px = blip_preprocess(cand, size).to(cap.cfg.torch_dtype)
        vision_ms = call_ms(torch, lambda: cap.model.encode_vision(px),
                            iters=5)
        generate_ms = call_ms(torch, lambda: cap.model.generate(px), iters=3)
    steps = cap.model.decode_steps
    t0 = time.perf_counter()
    for _ in range(5):
        ground._forward(emb, text)
    ground_ms = (time.perf_counter() - t0) / 5 * 1e3
    return {
        "build_models_s": build_s,
        "candidates": {"reranked": n_cand, "advanced": 2 * n_cand},
        "reranked_cold_ms": runs["reranked"][1],
        "advanced_first_ms": runs["advanced"][1],
        "reranked_warm_p50_ms": statistics.median(runs["reranked"][3]),
        "advanced_warm_p50_ms": statistics.median(runs["advanced"][3]),
        "warm_ms": {m: r[3] for m, r in runs.items()},
        "decode_steps_first_call": {m: r[4] for m, r in runs.items()},
        "results": {m: len(r[0]) for m, r in runs.items()},
        "blip_vision_ms_per_batch": vision_ms,
        "blip_generate_ms_per_batch": generate_ms,
        "decode_steps": steps,
        "decode_ms_per_step": (generate_ms - vision_ms) / max(steps, 1),
        "grounding_forward_ms": ground_ms,
        "frames_read_by_seek": getattr(video, "frames_read", 0),
        "top_caption": runs["reranked"][0][0]["caption"][:80],
        "launches": launches, **checks,
    }


def detection_box_report(np, results, width: int, height: int):
    """(every box finite, ordered and overlapping the frame; share wholly
    inside it). The detectors' boxes are not clipped (an OWL-ViT box
    near the crop's edge may reach past the frame), as in the JAX
    package."""
    ok, inside = True, 0
    for r in results:
        x0, y0, x1, y1 = r["bbox"]
        ok &= bool(np.all(np.isfinite(r["bbox"])) and x0 < x1 and y0 < y1
                   and x1 > 0 and y1 > 0 and x0 < width and y0 < height)
        inside += 0 <= x0 and 0 <= y0 and x1 <= width and y1 <= height
    return ok, inside / max(len(results), 1)


def device_window(torch, fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA) → (its result,
    wall ms, device busy ms: the union of kernel and copy intervals,
    idle share 1 - busy / wall). The wall includes the profiler's own
    cost."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    # kernels and copies, not the device-side ranges of ``trace`` spans
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith(TRACE_SPANS))
    busy_us, lo, hi = 0.0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            if hi is not None:
                busy_us += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy_us += hi - lo
    if busy_us <= 0:
        fail("the profiler saw no device work in a traced window")
    busy_ms = busy_us / 1e3
    return out, {"wall_ms_profiled": wall_ms, "device_busy_ms": busy_ms,
                 "device_idle_share": 1.0 - busy_ms / wall_ms,
                 "device_events": len(spans)}


def drive_blip2(torch, np, engine, video, cache_dir):
    """Phase 12: the ``reranked`` mode with ``BLIP_MODEL`` naming BLIP-2,
    through ``VideoProcessor.process_query`` at full width: the Q-Former
    reranker (``QFormerConfig()``: ViT-g 1408 x 39 at 224 px, 16 heads of
    88, MLP 6144; Q-Former 768 x 12, 32 queries, projection 256, vocab
    30523; bf16, random weights from seed 0) on phase 5's 600-frame
    source. One cold call (fresh caches: 30 candidates through the tower,
    cached as ``blip2img``) and three warm ones (the text side only);
    the cold call again on fresh caches and one warm call under the
    profiler, for the device's busy and idle time."""
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.models.qformer import Blip2Retrieval, QFormerConfig
    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.ops.preprocess import blip_preprocess
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.pipelines.phase2 import Phase2Rerank
    from avede_tpu_torch.services import captioner, video_processor
    from avede_tpu_torch.utils.config import settings

    blip_model, settings.BLIP_MODEL = settings.BLIP_MODEL, "blip2-itm-vit-g"
    # the in-memory source stands in for the container validate_video
    # would probe
    video_processor.validate_video = lambda path: None
    proc = video_processor.VideoProcessor(engine=engine)
    proc.phase1 = Phase1Scan(engine, reader=video,
                             cache=EmbeddingCache(str(cache_dir / "a")))
    needed = (kernels.fused_patch_embed_i420, attention.flash_attention_blhd,
              kernels.cosine_window_topk)
    contracts = (kernels.fused_patch_embed, attention.flash_attention,
                 kernels.cosine_scores)
    counted = needed + contracts
    path, vid, top_k = "memory://blip2-street", "blip2-street", \
        settings.TOP_K_RESULTS
    t0 = time.perf_counter()
    svc = proc.phase2.captioner                          # builds ViT-g
    build_s = time.perf_counter() - t0
    cfg = svc.cfg
    if not isinstance(svc, captioner.Blip2RerankService) \
            or cfg != QFormerConfig(dtype="bfloat16"):
        fail(f"BLIP_MODEL={settings.BLIP_MODEL}: got {type(svc).__name__} "
             f"with {cfg}")
    stages: dict = {}
    batches = []
    frame_repr = svc.frame_repr

    def counted_repr(frames):
        batches.append(len(frames))
        return frame_repr(frames)

    svc.frame_repr = counted_repr
    undo = timed_stage(stages, svc, "frame_repr", "blip2_image_embeds")

    def query():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = proc.process_query(path, QUERIES[0], mode="reranked",
                                 threshold=-1.0, extract_clips=False,
                                 video_id=vid)
        torch.cuda.synchronize()
        if out["status"] != "completed":
            fail(f"BLIP-2 reranked query: {out}")
        return out["results"], (time.perf_counter() - t0) * 1e3

    reset_launches(counted)
    cold, cold_ms = query()
    cold_launches = read_launches(counted)
    cold_stages, cold_batches = dict(stages), list(batches)
    reset_launches(counted)
    warm = [query() for _ in range(3)]
    warm_launches = read_launches(counted)
    undo()
    del svc.frame_repr
    for name in [fn.__name__ for fn in needed] + [FLASH_L50]:
        if cold_launches[name] <= 0:
            fail(f"BLIP-2 reranked: {name} never launched on the cold "
                 f"call: {cold_launches}")
    n_batches = sum(1 for n in cold_batches if n)
    if n_batches == 0 or cold_launches[FLASH_L257] \
            != BLIP2_DEPTH * n_batches:
        fail(f"BLIP-2 reranked: {cold_launches[FLASH_L257]} flash launches "
             f"at L = {BLIP2_TOKENS} for {n_batches} candidate batches "
             f"({cold_batches}), not {BLIP2_DEPTH} each")
    if warm_launches[FLASH_L257] or any(
            c[fn.__name__] for c in (cold_launches, warm_launches)
            for fn in contracts):
        fail(f"BLIP-2: the tower ran warm or a contract entry ran: "
             f"{cold_launches}, {warm_launches}")
    for res in [cold] + [r for r, _ in warm]:
        conf = [r["confidence"] for r in res]
        if not 0 < len(res) <= top_k or not np.all(np.isfinite(conf)) \
                or conf != sorted(conf, reverse=True):
            fail(f"BLIP-2 reranked: scores not finite and sorted: {conf}")
        for r in res:
            if "caption" in r or not np.isfinite(r["itc_score"]) \
                    or abs(r["confidence"] - (0.7 * r["clip_score"]
                                              + 0.3 * r["itc_score"])) > 1e-5:
                fail(f"BLIP-2 reranked: not an ITC result: {r}")
        if res != cold:
            fail("BLIP-2 reranked: repeated queries gave different results")

    # the device's busy and idle time: the cold call again on fresh caches
    # (the captioner kept), and one warm call
    proc.phase1 = Phase1Scan(engine, reader=video,
                             cache=EmbeddingCache(str(cache_dir / "b")))
    proc._phase2 = Phase2Rerank(proc.phase1, captioner=svc)
    (again, _), cold_window = device_window(torch, query)
    _, warm_window = device_window(torch, query)
    if again != cold:
        fail("BLIP-2 reranked: the cold call on fresh caches differs")

    # the card's bf16 against the CPU's f32 plain path on the same weights
    # (the card's, in f32): two candidate frames' per-query image
    # embeddings, the query's text embedding, their ITC scores
    t0 = time.perf_counter()
    frames = np.ascontiguousarray(video._chunk(0, 300)[::150, :, :, ::-1])
    sd = {k: v.float().cpu() for k, v in svc.model.state_dict().items()}
    with torch.device("meta"):
        cpu = Blip2Retrieval(QFormerConfig())
    cpu.load_state_dict(sd, assign=True)
    cpu.eval()
    del sd
    ids = torch.from_numpy(svc.query_ids(QUERIES[0]))
    with torch.inference_mode():
        px = blip_preprocess(torch.from_numpy(frames), cfg.image_size)
        img_cpu = cpu.image_embeds(px).numpy()
        txt_cpu = cpu.text_embeds(ids).numpy()
        img_card = svc.model.image_embeds(px.cuda()).cpu().numpy()
        txt_card = svc.model.text_embeds(ids.cuda()).cpu().numpy()
    del cpu
    gc.collect()
    itc_card = (img_card @ txt_card[0]).max(1)
    itc_cpu = (img_cpu @ txt_cpu[0]).max(1)
    checks = {
        "image_embeds_min_row_cosine": row_cosine(np, img_card, img_cpu),
        "text_embed_cosine": row_cosine(np, txt_card, txt_cpu),
        "itc_max_abs_diff": float(np.abs(itc_card - itc_cpu).max()),
        "rows_checked": int(img_card.shape[0] * img_card.shape[1]),
        "card_and_cpu_s": time.perf_counter() - t0}
    if checks["image_embeds_min_row_cosine"] < 0.999 \
            or checks["text_embed_cosine"] < 0.999:
        fail(f"BLIP-2 card vs CPU: {checks}")

    # device times of the pieces at the cold path's shapes
    cand = torch.from_numpy(np.repeat(frames, top_k, axis=0)).cuda()
    with torch.inference_mode():
        px = blip_preprocess(cand, cfg.image_size)
        tower_ms = call_ms(torch, lambda: svc.model.image_embeds(px),
                           iters=5)
        text_ms = call_ms(torch, lambda: svc.model.text_embeds(ids.cuda()),
                          iters=10)
    # ViT-g's and the Q-Former's matrix products for the batch
    d, m, L = cfg.vision_dim, cfg.vision_mlp, BLIP2_TOKENS
    vision_flop = 2.0 * len(cand) * cfg.vision_depth * L * (
        4 * d * d + 2 * d * m + 2 * L * d)
    out = {
        "build_models_s": build_s, "candidates": len(cold),
        "candidate_batches": cold_batches,
        "reranked_cold_ms": cold_ms,
        "reranked_warm_p50_ms": statistics.median(ms for _, ms in warm),
        "warm_ms": [ms for _, ms in warm],
        "cold_host_stages_s": cold_stages,
        "cold_profiled": cold_window, "warm_profiled": warm_window,
        "image_embeds_ms_per_batch": tower_ms,
        "text_embed_ms": text_ms,
        "vision_tflop_per_batch": vision_flop / 1e12,
        "flash_launches_L257": cold_launches[FLASH_L257],
        "launches": {"cold": cold_launches, "warm": warm_launches},
        "top": [(round(r["timestamp"], 3), round(r["itc_score"], 6))
                for r in cold[:5]], **checks}
    settings.BLIP_MODEL = blip_model
    del proc, svc, cand, px
    gc.collect()
    torch.cuda.empty_cache()
    return out


def drive_detection(torch, np, engine, video):
    """Phase 9: open-vocabulary detection through
    ``VideoProcessor.process_unlimited_detection`` at full width: OWL-ViT
    B/32 (768 px, random weights from seed 0, bf16, flash attention at
    L = 577 in every vision layer), YOLOv8n at 640 px (seed 0, bf16) and
    the CLIP engine's grid (8 × 8 cells, flash at L = 50), on phase 5's
    600-frame source read as 200 evenly spread frames in 16-frame
    batches, ``comprehensive`` precision. One cold and one warm ``hybrid``
    call, then one call each of ``owlvit``, ``clip`` and
    ``yolo_enhanced``; launch counts zeroed before the phase, the grid's
    L = 50 launches told apart from the crops'. Random
    OWL-ViT weights put a sigmoid near 0.5 on every patch, so ``hybrid``
    and ``owlvit`` must find objects; random CLIP weights score every
    cell and crop near cosine 0, so ``clip`` and ``yolo_enhanced`` may
    rightly find none under the adaptive thresholds (their counts are
    reported)."""
    import dataclasses

    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.models.owlvit import init_owlvit
    from avede_tpu_torch.models.yolo import init_yolo
    from avede_tpu_torch.ops import attention, kernels, quant
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.detector import (
        ClipGridDetector, extract_object_embeddings)
    from avede_tpu_torch.services import video_processor
    from avede_tpu_torch.services.open_vocab_matcher import OpenVocabMatcher
    from avede_tpu_torch.utils.config import settings

    video_processor.validate_video = lambda path: None
    proc = video_processor.VideoProcessor(engine=engine)
    t0 = time.perf_counter()
    det = proc.universal_detector              # OWL-ViT B/32
    yolo = det.yolo                            # YOLOv8n
    matcher = proc.open_vocab
    build_s = time.perf_counter() - t0
    matcher.reader = video
    dedup_counts = []

    def counted_dedup(results, **kw):
        out = OpenVocabMatcher._deduplicate(results, **kw)
        dedup_counts.append((len(results), len(out)))
        return out

    matcher._deduplicate = counted_dedup
    # the grid's L = 50 launches, told apart from the crops' by the
    # entry's count around each grid call
    by_len = attention.flash_attention_blhd.launches_by_length
    grid_embed, grid_l50 = det.clip_grid.cell_embeddings, [0]

    def counted_grid(frames):
        before = by_len[CLIP_TOKENS]
        out = grid_embed(frames)
        grid_l50[0] += by_len[CLIP_TOKENS] - before
        return out

    det.clip_grid.cell_embeddings = counted_grid
    counted = (attention.flash_attention_blhd, kernels.fused_patch_embed_i420,
               kernels.cosine_window_topk, kernels.cosine_topk_f32,
               kernels.cosine_topk_bf16, kernels.cosine_topk_int8,
               quant.quantize_rows, kernels.fused_patch_embed,
               attention.flash_attention, kernels.cosine_scores,
               kernels.cosine_scores_bf16, kernels.cosine_scores_int8,
               quant.quantize_per_channel)
    path = "memory://detection-street"
    rank_key = "composite_score"     # the comprehensive precision's rank
    runs = []
    reset_launches(counted)
    for mode in ("hybrid", "hybrid", "owlvit", "clip", "yolo_enhanced"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = proc.process_unlimited_detection(
            path, DETECTION_QUERIES, detection_mode=mode,
            matching_precision="comprehensive", top_k=25,
            confidence_threshold=0.1, video_id="detection-street")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if out["status"] != "completed":
            fail(f"detection ({mode}): {out}")
        runs.append((mode, out, wall_ms, dedup_counts[-1]))
    launches = read_launches(counted)
    del det.clip_grid.cell_embeddings
    flash_l50 = {"clip_grid": grid_l50[0],
                 "crops": launches[FLASH_L50] - grid_l50[0]}
    if launches[FLASH_L577] <= 0 or flash_l50["clip_grid"] <= 0:
        fail(f"detection: flash never launched at L = {OWL_TOKENS} "
             f"(OWL-ViT) or in the CLIP grid: {launches}, {flash_l50}")
    if any(n for name, n in launches.items()
           if not name.startswith("flash_attention_blhd")):
        fail(f"detection: a kernel off this path ran: {launches}")

    per_mode, boxes_inside = {}, {}
    for mode, out, wall_ms, (before, after) in runs:
        res = out["results"]
        keys = [r[rank_key] for r in res]
        ok, share = detection_box_report(np, res, FRAME_W, FRAME_H)
        if (not res and mode in ("hybrid", "owlvit")) or not ok \
                or not np.all(np.isfinite(keys)) \
                or keys != sorted(keys, reverse=True):
            fail(f"detection ({mode}): results not finite, sorted and in "
                 f"the frame: {res[:3]}")
        for r in res:
            if r["query"] not in DETECTION_QUERIES or not all(np.isfinite(
                    [r["confidence"], r["visual_quality"],
                     r["semantic_relevance"], r["size_score"]])):
                fail(f"detection ({mode}): bad result {r}")
        if out["metadata"]["frames_processed"] != 200:
            fail(f"detection ({mode}): {out['metadata']}")
        boxes_inside[mode] = share
        per_mode.setdefault(mode, []).append({
            "wall_ms": wall_ms, "results": len(res),
            "before_dedup": before, "after_dedup": after})

    if runs[0][1]["results"] != runs[1][1]["results"]:
        fail("detection: repeated hybrid calls gave different results")

    # card bf16 against the CPU's f32 plain path on the same seeded
    # weights, two frames: OWL-ViT, YOLO's head, the CLIP grid's cell
    # embeddings and crop embeddings through the bucketed path
    frames = next(video.stream_batches(path, 2, max_frames=200))[0]
    ids = det.owl_tokenizer(DETECTION_QUERIES)
    cpu_owl = init_owlvit(dataclasses.replace(det.owl_cfg, dtype="float32"),
                          seed=0).eval()
    cpu_yolo = init_yolo(dataclasses.replace(yolo.cfg, dtype="float32"),
                         seed=0).eval()
    cpu_clip = ClipEngine(cfg=vit_b32(), device="cpu", seed=0)
    # crops of a large, a medium, a thin and a sub-2-px box (an 8 x 8
    # black crop) of each frame: 8 crops, the embed bucket of 16
    crop_boxes = [[0, 0, FRAME_W, FRAME_H], [100, 50, 300, 250],
                  [10, 10, 14, 200], [40, 40, 41, 41]]
    from avede_tpu_torch.models.yolo import resize_bilinear
    from avede_tpu_torch.ops.preprocess import clip_preprocess

    with torch.inference_mode():
        logits, boxes = det.owl_forward(frames, ids)
        x_cpu = torch.from_numpy(frames)
        ref_logits, ref_boxes = cpu_owl(
            clip_preprocess(x_cpu, size=det.owl_cfg.image_size),
            torch.from_numpy(ids))
        heads = yolo.raw_outputs(frames)
        ref_heads = cpu_yolo(resize_bilinear(x_cpu.float() / 255.0,
                                             yolo.cfg.img_size))
        cells = det.clip_grid.cell_embeddings(frames).float().cpu()
        ref_cells = ClipGridDetector(cpu_clip, det.clip_grid.grid
                                     ).cell_embeddings(frames)
    crops = np.concatenate([extract_object_embeddings(engine, f, crop_boxes)
                            for f in frames])
    ref_crops = np.concatenate([extract_object_embeddings(
        cpu_clip, f, crop_boxes) for f in frames])
    checks = {
        "owl_logits_min_row_cosine": row_cosine(
            np, logits.float().cpu().reshape(2, -1).numpy(),
            ref_logits.reshape(2, -1).numpy()),
        "owl_boxes_min_row_cosine": row_cosine(
            np, boxes.float().cpu().reshape(2, -1).numpy(),
            ref_boxes.reshape(2, -1).numpy()),
        "yolo_head_min_row_cosine": min(
            row_cosine(np, g.float().cpu().reshape(2, -1).numpy(),
                       r.reshape(2, -1).numpy())
            for gh, rh in zip(heads, ref_heads) for g, r in zip(gh, rh)),
        "clip_grid_cells_min_row_cosine": row_cosine(
            np, cells.numpy(), ref_cells.numpy()),
        "clip_crops_min_row_cosine": row_cosine(np, crops, ref_crops),
    }
    if min(checks.values()) < 0.99:
        fail(f"detection card vs CPU: {checks}")
    del cpu_owl, cpu_yolo, cpu_clip

    # device ms of the pieces on one 16-frame batch (eager calls, CUDA
    # events, launch cost included)
    batch = next(video.stream_batches(path, DETECTION_BATCH,
                                      max_frames=200))[0]
    text = engine.embed_texts(DETECTION_QUERIES)
    with torch.inference_mode():
        owl_ms = call_ms(torch, lambda: det.owl_forward(batch, ids), iters=5)
        yolo_ms = call_ms(torch, lambda: yolo.raw_outputs(batch), iters=5)
        grid_ms = call_ms(torch, lambda: det.clip_grid.cell_scores(
            batch, text), iters=5)
    return det, {
        "build_models_s": build_s,
        "queries": DETECTION_QUERIES,
        "hybrid_cold_ms": runs[0][2], "hybrid_warm_ms": runs[1][2],
        "walls_ms": {m: [r["wall_ms"] for r in v] for m, v in per_mode.items()},
        "per_mode": per_mode,
        "frames_processed": 200,
        "boxes_wholly_inside_share": boxes_inside,
        "owl_forward_ms_per_batch": owl_ms,
        "yolo_forward_ms_per_batch": yolo_ms,
        "clip_grid_ms_per_batch": grid_ms,
        "batch": DETECTION_BATCH,
        "top_result": {k: runs[0][1]["results"][0][k] for k in (
            "query", "bbox", "confidence", "composite_score", "method")},
        "launches": launches, "flash_l50_launches": flash_l50, **checks,
    }


class SmallObjectVideo:
    """An in-memory 1080p source for the small-object path: seeded RGB
    frames of 1920×1080, a textured background and six squares and
    discs of 16-64 px moving at different speeds. It serves
    ``extract_frames`` (the small-object reader, 4096 px a side) and
    ``stream_batches`` (the background service's reader, whose frames
    ``VideoReader`` fits to ``max_side`` with cv2's area resize), at the
    reader's sampled indices."""

    sample_rate = 1

    def __init__(self, np, n_frames: int = SMALL_FRAMES,
                 max_side: int = 4096) -> None:
        self.np, self.n_frames, self.max_side = np, n_frames, max_side
        rng = np.random.default_rng(7)
        yy, xx = np.mgrid[0:SMALL_H, 0:SMALL_W]
        base = np.stack([90 + 40 * np.sin(xx / 37.0),
                         110 + 45 * np.cos(yy / 29.0),
                         100 + 30 * np.sin((xx + yy) / 53.0)], -1)
        self.background = np.clip(base + rng.normal(0, 10, base.shape),
                                  0, 255).astype(np.uint8)

    def box(self, obj: int, i: int):
        """xyxy of object ``obj`` in frame ``i``."""
        _, size, x, y, vx, vy, _ = SMALL_OBJECTS[obj]
        x0, y0 = x + vx * i, y + vy * i
        return [x0, y0, x0 + size, y0 + size]

    def frame(self, i: int):
        np = self.np
        f = self.background.copy()
        yy, xx = np.ogrid[0:SMALL_H, 0:SMALL_W]
        for obj, (kind, size, *_, rgb) in enumerate(SMALL_OBJECTS):
            x0, y0, x1, y1 = self.box(obj, i)
            if kind == "square":
                f[y0:y1, x0:x1] = rgb
            else:
                r = size / 2
                inside = ((yy - y0 - r + 0.5) ** 2
                          + (xx - x0 - r + 0.5) ** 2) <= r * r
                f[inside] = rgb
        return f

    def _indices(self, sample_rate, max_frames):
        from avede_tpu_torch.io.video_reader import sample_indices

        return sample_indices(self.n_frames, sample_rate or 1,
                              max_frames or self.n_frames)

    def extract_frames(self, path: str, sample_rate=None, max_frames=None):
        idx = self._indices(sample_rate, max_frames)
        return (self.np.stack([self.frame(i) for i in idx]),
                [i / FPS for i in idx])

    def stream_batches(self, path: str, batch: int, sample_rate=None,
                       max_frames=None):
        import cv2

        from avede_tpu_torch.io.video_reader import _fit_size

        np = self.np
        idx = self._indices(sample_rate, max_frames)
        size = _fit_size(SMALL_W, SMALL_H, self.max_side)
        for lo in range(0, len(idx), batch):
            part = idx[lo: lo + batch]
            frames = [self.frame(i) for i in part]
            if size != (SMALL_W, SMALL_H):
                frames = [cv2.resize(f, size, interpolation=cv2.INTER_AREA)
                          for f in frames]
            yield np.stack(frames), [i / FPS for i in part]


def timed_stage(stages: dict, owner, name: str, label: str):
    """Wrap ``owner.name`` so that each call adds its wall to
    ``stages[label]`` → a function that undoes the wrap."""
    fn = getattr(owner, name)
    own = vars(owner)
    had, raw = name in own, own.get(name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            stages[label] = stages.get(label, 0.0) + time.perf_counter() - t0

    setattr(owner, name, wrapper)
    return (lambda: setattr(owner, name, raw)) if had \
        else (lambda: delattr(owner, name))


def drive_small_objects(torch, np, engine, det):
    """Phase 10: small-object detection and background independence at
    full width on the card, while the CLIP engine (ViT-B/32) and phase
    9's ``UniversalDetector`` (OWL-ViT B/32) are loaded, on a 1080p
    source of 60 frames (8 tiles of 640 px at overlap 128 a frame):
    the route's default ``process_small_object_detection`` (``clip``
    mode, RPN, adaptive thresholds and background independence, top 20)
    cold and warm; one ``owlvit`` call at top 5 on the first 2 frames;
    two ``clip`` calls on the first 2 frames that keep every cell (top
    2); one ``process_background_independence`` with its defaults and
    one at threshold -1 on the first 4 frames (frames fitted to 512 px
    by its reader); then ``extract_features`` on four
    boxes around planted objects, on the card (CLIP bf16 and an
    EfficientNet-B0 of seeded random weights, f32) and on the CPU (f32
    plain path, the same weights), cv2's RNG seeded before each GrabCut
    (its GMM initialisation draws from it; it is also seeded before each
    call, so the cold and warm calls can be compared)."""
    try:
        import cv2
    except ImportError:
        fail("cv2 is missing: the small-object path needs cv2.grabCut, "
             "calcOpticalFlowFarneback, findContours, HuMoments and "
             "approxPolyDP")
    import dataclasses

    from avede_tpu_torch.io.video_reader import _fit_size
    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.models.owlvit import init_owlvit
    from avede_tpu_torch.ops import attention, kernels, quant
    from avede_tpu_torch.ops.preprocess import clip_preprocess
    from avede_tpu_torch.ops.tiling import tile_frame
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services import (adaptive_threshold,
                                          background_independent,
                                          small_object, video_processor)
    from avede_tpu_torch.services.background_independent import (
        BackgroundIndependentService, EffNetExtractor, grabcut_mask)
    from avede_tpu_torch.services.detector import ClipGridDetector
    from avede_tpu_torch.ops.preprocess import imagenet_preprocess

    video_processor.validate_video = lambda path: None
    proc = video_processor.VideoProcessor(engine=engine)
    proc._universal_detector = det
    so, bg = proc.small_object, proc.background
    counted = (attention.flash_attention_blhd, kernels.fused_patch_embed_i420,
               kernels.cosine_window_topk, kernels.cosine_topk_f32,
               kernels.cosine_topk_bf16, kernels.cosine_topk_int8,
               quant.quantize_rows, kernels.fused_patch_embed,
               attention.flash_attention, kernels.cosine_scores,
               kernels.cosine_scores_bf16, kernels.cosine_scores_int8,
               quant.quantize_per_channel)
    by_len = attention.flash_attention_blhd.launches_by_length
    stages: dict = {}
    undo = [timed_stage(stages, det, "detect_unlimited_objects", "detect"),
            timed_stage(stages, so.proposals, "generate_proposals",
                        "proposals"),
            timed_stage(stages, adaptive_threshold.DetectionContext,
                        "from_frame", "frame_statistics"),
            timed_stage(stages, so.thresholds, "apply",
                        "thresholds_and_merge"),
            timed_stage(stages, small_object, "merge_detections",
                        "thresholds_and_merge"),
            timed_stage(stages, BackgroundIndependentService,
                        "extract_features", "grabcut_and_features")]
    path = "memory://small-objects"
    # random CLIP scores every cell below 0.1 (phase 9's `clip` call
    # keeps none at 0.1), so the default calls rightly find nothing; the
    # `_all` calls keep every cell (threshold -1, and the small-object
    # call without the adaptive thresholds, whose floors lie at 0.05 and
    # above) so that merge, GrabCut and the re-scoring run on detections
    all_cells = dict(confidence_threshold=-1.0,
                     enable_adaptive_thresholds=False, top_k=2)
    calls = (("default_cold", "small_object", SMALL_DEFAULT_FRAMES, {}),
             ("default_warm", "small_object", SMALL_DEFAULT_FRAMES, {}),
             ("owlvit", "small_object", SMALL_OWLVIT_FRAMES,
              dict(detection_mode="owlvit", top_k=5)),
             ("clip_all", "small_object", 2, all_cells),
             ("clip_all_again", "small_object", 2, all_cells),
             ("background", "background", SMALL_FRAMES, {}),
             ("background_all", "background", 4,
              dict(confidence_threshold=-1.0)))
    runs = []
    reset_launches(counted)
    t_phase = time.perf_counter()
    for name, kind, n_frames, kw in calls:
        so.reader = SmallObjectVideo(np, n_frames=n_frames)
        bg.reader = SmallObjectVideo(np, n_frames=n_frames, max_side=512)
        stages.clear()
        l50, l577 = by_len[CLIP_TOKENS], by_len[OWL_TOKENS]
        cv2.setRNGSeed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "small_object":
            out = proc.process_small_object_detection(
                path, SMALL_QUERIES, video_id="small-objects", **kw)
        else:
            out = proc.process_background_independence(
                path, SMALL_QUERIES, video_id="small-objects", **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        if out["status"] != "completed":
            fail(f"small objects ({name}): {out}")
        runs.append((name, out, {
            "wall_ms": wall_ms,
            "host_stages_s": dict(stages),
            "flash_launches_l50": by_len[CLIP_TOKENS] - l50,
            "flash_launches_l577": by_len[OWL_TOKENS] - l577}))
    launches = read_launches(counted)
    calls_s = time.perf_counter() - t_phase
    for u in undo:
        u()
    if any(n for name, n in launches.items()
           if not name.startswith("flash_attention_blhd")):
        fail(f"small objects: a kernel off this path ran: {launches}")
    per_call = {}
    for name, out, rep in runs:
        if rep["flash_launches_l50"] <= 0 or (
                (rep["flash_launches_l577"] > 0) != (name == "owlvit")):
            fail(f"small objects ({name}): flash launches at L = "
                 f"{CLIP_TOKENS} / {OWL_TOKENS}: {rep}")
        res = out["results"]
        conf = [r["confidence"] for r in res]
        on_bg = name.startswith("background")
        ok, share = detection_box_report(
            np, res, *(_fit_size(SMALL_W, SMALL_H, 512) if on_bg
                       else (SMALL_W, SMALL_H)))
        if not ok or not np.all(np.isfinite(conf)) \
                or conf != sorted(conf, reverse=True):
            fail(f"small objects ({name}): results not finite, sorted and "
                 f"in the frame: {res[:3]}")
        if not on_bg and not all(
                16 <= r["object_size"] <= 128 for r in res):
            fail(f"small objects ({name}): a size outside [16, 128]")
        stats = out.get("enhancement_stats",
                        out.get("background_independence_stats"))
        per_call[name] = {**rep, "results": len(res),
                          "boxes_wholly_inside_share": share,
                          "frames_processed":
                              out["metadata"]["frames_processed"],
                          "stats": {k: v for k, v in stats.items()
                                    if k != "processing_time"}}
    outs = {name: out for name, out, _ in runs}
    for a, b in (("default_cold", "default_warm"),
                 ("clip_all", "clip_all_again")):
        if outs[a]["results"] != outs[b]["results"]:
            fail(f"small objects: the {a} and {b} calls differ")
    for name, key in (("owlvit", "bg_features"), ("clip_all", "bg_features"),
                      ("background_all", "segmented")):
        if per_call[name]["results"] == 0 \
                or per_call[name]["stats"][key] == 0:
            fail(f"small objects: the {name} call found nothing to "
                 f"segment: {per_call[name]}")
    if not per_call["clip_all"]["host_stages_s"].get("thresholds_and_merge"):
        fail("small objects: the clip_all call merged nothing")

    # extract_features on boxes around four planted objects, on the card
    # and on the CPU (f32 plain path, the same seeded weights)
    src = SmallObjectVideo(np)
    frame = src.frame(10)
    boxes = []
    for obj in (0, 1, 3, 5):
        x0, y0, x1, y1 = src.box(obj, 10)
        pad = (x1 - x0) // 4
        boxes.append([x0 - pad, y0 - pad, x1 + pad, y1 + pad])
    card_eff = EffNetExtractor(device="cuda")
    cpu_eff = EffNetExtractor(device="cpu")
    cpu_clip = ClipEngine(cfg=vit_b32(), device="cpu", seed=0)
    card_bg = BackgroundIndependentService(engine, effnet=card_eff)
    cpu_bg = BackgroundIndependentService(cpu_clip, effnet=cpu_eff)
    masks = []

    def recorded_mask(*args, **kwargs):
        masks.append(grabcut_mask(*args, **kwargs))
        return masks[-1]

    background_independent.grabcut_mask = recorded_mask
    feats, masks_equal = [], True
    t0 = time.perf_counter()
    for b in boxes:
        pair = []
        for svc in (card_bg, cpu_bg):
            cv2.setRNGSeed(0)
            pair.append(svc.extract_features(frame, b))
        m_card, m_cpu = masks[-2:]
        masks_equal &= m_card is not None and bool(np.array_equal(m_card,
                                                                  m_cpu))
        feats.append(pair)
    features_s = time.perf_counter() - t0
    background_independent.grabcut_mask = grabcut_mask
    if any(f is None for pair in feats for f in pair):
        fail("small objects: extract_features gave no features")
    shapes_equal = all(np.array_equal(c["shape"], p["shape"])
                       and c["mask_coverage"] == p["mask_coverage"]
                       for c, p in feats)
    checks = {
        "bg_clip_min_row_cosine": row_cosine(
            np, np.stack([c["embedding"] for c, _ in feats]),
            np.stack([p["embedding"] for _, p in feats])),
        "effnet_min_row_cosine": row_cosine(
            np, np.stack([c["effnet"] for c, _ in feats]),
            np.stack([p["effnet"] for _, p in feats])),
    }
    if min(checks.values()) < 0.99 or not masks_equal or not shapes_equal:
        fail(f"small objects card vs CPU: {checks}, masks equal "
             f"{masks_equal}, shape descriptors equal {shapes_equal}")

    # the flash entry at this path's own shapes, card bf16 against the
    # CPU's f32 plain path on the same weights: the CLIP grid's cells of
    # one frame's 8 tiles ([512, 50, 12, 64]) and OWL-ViT B/32 on the
    # same tiles ([8, 577, 12, 64])
    tiles, _ = tile_frame(frame, so.tile, so.overlap)
    ids = det.owl_tokenizer(SMALL_QUERIES)
    t0 = time.perf_counter()
    cpu_owl = init_owlvit(dataclasses.replace(det.owl_cfg, dtype="float32"),
                          seed=0).eval()
    with torch.inference_mode():
        cells = det.clip_grid.cell_embeddings(tiles).float().cpu()
        ref_cells = ClipGridDetector(cpu_clip, det.clip_grid.grid
                                     ).cell_embeddings(tiles)
        logits, owl_boxes = det.owl_forward(tiles, ids)
        ref_logits, ref_boxes = cpu_owl(
            clip_preprocess(torch.from_numpy(tiles),
                            size=det.owl_cfg.image_size),
            torch.from_numpy(ids))
    n = len(tiles)
    tile_checks = {
        "tile_grid_cells": list(cells.shape),
        "tile_grid_cells_min_row_cosine": row_cosine(
            np, cells.numpy(), ref_cells.numpy()),
        "tile_owl_logits_min_row_cosine": row_cosine(
            np, logits.float().cpu().reshape(n, -1).numpy(),
            ref_logits.reshape(n, -1).numpy()),
        "tile_owl_boxes_min_row_cosine": row_cosine(
            np, owl_boxes.float().cpu().reshape(n, -1).numpy(),
            ref_boxes.reshape(n, -1).numpy()),
        "tiles_card_and_cpu_s": time.perf_counter() - t0,
    }
    if min(v for k, v in tile_checks.items() if k.endswith("cosine")) \
            < 0.99:
        fail(f"small objects card vs CPU on one frame's tiles: "
             f"{tile_checks}")
    del cpu_clip, cpu_eff, cpu_bg, cpu_owl

    # device ms (eager calls, CUDA events, launch cost included): the
    # CLIP grid over one frame's 8 tiles (512 cells), and EfficientNet-B0
    # at batch 1 and 16 with cuDNN's TF32 as this process has it (off
    # since phase 3) and on (PyTorch's default in a server process)
    text = engine.embed_texts(SMALL_QUERIES)
    tf32 = torch.backends.cudnn.allow_tf32
    eff_ms = {}
    with torch.inference_mode():
        grid_ms = call_ms(torch, lambda: det.clip_grid.cell_scores(
            tiles, text), iters=5)
        for allow in (False, True):
            torch.backends.cudnn.allow_tf32 = allow
            for n in (1, 16):
                x = imagenet_preprocess(torch.from_numpy(np.repeat(
                    frame[None, :224, :224], n, 0)).cuda())
                eff_ms[f"batch_{n}_tf32_{'on' if allow else 'off'}"] = \
                    call_ms(torch, lambda: card_eff.model(x), iters=10)
    torch.backends.cudnn.allow_tf32 = tf32
    return {
        "source": {"frames": SMALL_FRAMES, "width": SMALL_W,
                   "height": SMALL_H, "tile": so.tile,
                   "overlap": so.overlap, "tiles_per_frame": len(tiles),
                   "queries": SMALL_QUERIES},
        "calls": per_call,
        "calls_s": calls_s,
        "launches": launches,
        "features_card_and_cpu_s": features_s,
        "grabcut_masks_equal": masks_equal,
        "shape_descriptors_equal": shapes_equal, **checks, **tile_checks,
        "clip_grid_ms_per_frame_8_tiles": grid_ms,
        "effnet_b0_ms": eff_ms,
        "cudnn_allow_tf32_in_phase": tf32,
        "effnet_dtype": card_eff.cfg.dtype,
    }


def _bounce(p: float, hi: float) -> int:
    """``p`` reflected into [0, hi] (a triangle wave)."""
    p = abs(p) % (2 * hi)
    return int(2 * hi - p if p > hi else p)


def image_query_frame(np, cv2, background, i: int):
    """Frame ``i`` of phase 11's source, BGR uint8 [720, 1280, 3]."""
    frame = background.copy()
    for kind, side, x, y, vx, vy, color in IMAGE_OBJECTS:
        x0 = _bounce(x + vx * i, IMAGE_W - side)
        y0 = _bounce(y + vy * i, IMAGE_H - side)
        if kind == "square":
            cv2.rectangle(frame, (x0, y0), (x0 + side - 1, y0 + side - 1),
                          color, -1)
            cv2.rectangle(frame, (x0 + side // 4, y0 + side // 4),
                          (x0 + side // 2, y0 + side // 2), (250, 250, 250),
                          -1)
        else:
            r = side // 2
            cv2.circle(frame, (x0 + r, y0 + r), r, color, -1)
            cv2.circle(frame, (x0 + r, y0 + r), r // 3, (20, 20, 20), -1)
    return frame


def video_io_info(cv2) -> str:
    """The "Video I/O" part of ``cv2.getBuildInformation()``."""
    out, inside = [], False
    for line in cv2.getBuildInformation().splitlines():
        if line.strip().startswith("Video I/O"):
            inside = True
        elif inside and line and not line.startswith("    "):
            break
        if inside:
            out.append(line)
    return "\n".join(out)


def write_image_query_video(np, path) -> dict:
    """Phase 11's source as a real mp4 (``mp4v``, as the repo's tests
    write theirs): 150 frames of 1280×720 at 30 fps, a seeded textured
    background (coarse colour noise upscaled, plus fine grain) and four
    objects of 64-200 px moving and bouncing off the edges. Fails, with
    cv2's Video I/O build information, where cv2 cannot write it."""
    import cv2

    rng = np.random.default_rng(11)
    coarse = rng.integers(40, 200, (18, 32, 3), dtype=np.uint8)
    background = np.clip(cv2.resize(coarse, (IMAGE_W, IMAGE_H),
                                    interpolation=cv2.INTER_CUBIC
                                    ).astype(np.int16)
                         + rng.integers(-14, 15, (IMAGE_H, IMAGE_W, 3)),
                         0, 255).astype(np.uint8)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             FPS, (IMAGE_W, IMAGE_H))
    if not writer.isOpened():
        print(video_io_info(cv2), file=sys.stderr)
        fail(f"cv2 cannot write {path} (mp4v)")
    t0 = time.perf_counter()
    for i in range(IMAGE_FRAMES):
        writer.write(image_query_frame(np, cv2, background, i))
    backend = writer.getBackendName()
    writer.release()
    return {"container": Path(path).suffix.lstrip("."), "fourcc": "mp4v",
            "writer_backend": backend, "write_s": time.perf_counter() - t0,
            "bytes": Path(path).stat().st_size,
            "cv2": cv2.__version__, "video_io": video_io_info(cv2)}


def image_query_refs(np, frames) -> dict:
    """Phase 11's references, from the decoded frames: A, the middle
    frame whole; B, a 160 × 160 crop around the largest object in it;
    C, A in grayscale (RGB → gray → RGB)."""
    import cv2

    a = np.ascontiguousarray(frames[IMAGE_REF])
    h, w = a.shape[:2]
    _, side, x, y, vx, vy, _ = IMAGE_OBJECTS[0]
    cx = (_bounce(x + vx * IMAGE_REF, IMAGE_W - side) + side / 2) * w \
        / IMAGE_W
    cy = (_bounce(y + vy * IMAGE_REF, IMAGE_H - side) + side / 2) * h \
        / IMAGE_H
    x0 = int(min(max(cx - 80, 0), w - 160))
    y0 = int(min(max(cy - 80, 0), h - 160))
    b = np.ascontiguousarray(a[y0: y0 + 160, x0: x0 + 160])
    c = cv2.cvtColor(cv2.cvtColor(a, cv2.COLOR_RGB2GRAY), cv2.COLOR_GRAY2RGB)
    return {"A": a, "B": b, "C": c}


def image_query_stages(stages: dict, proc) -> list:
    """Wrap the image-query path's host stages (``timed_stage``) →
    functions that undo the wraps. ``traditional`` holds the pHash;
    SSIM, histograms and ORB are the rest of it."""
    from avede_tpu_torch.services import detector, image_matcher

    matcher = proc.image_matching.matcher
    return [timed_stage(stages, *w) for w in (
        (matcher.reader, "extract_frames", "decode"),
        (proc.engine, "embed_frames", "pack_embed"),
        (image_matcher, "_phash_distances", "phash"),
        (matcher, "_traditional", "traditional"),
        (matcher.cross_domain, "match_against_frames",
         "cross_domain_features"),
        (matcher.yolo, "detect", "yolo"),
        (detector, "extract_object_embeddings", "crop_embeddings"),
        (proc.image_matching.clip_writer, "extract_clip_with_padding",
         "clip_cuts"))]


def host_stage_report(stages: dict) -> dict:
    out = dict(stages)
    if "traditional" in out:
        out["ssim_hist_orb"] = out.pop("traditional") - out.get("phash", 0.0)
    return out


def drive_image_query(torch, np, engine, tmp: Path):
    """Phase 11: image query through ``VideoProcessor.process_image_matching``
    at full width (CLIP ViT-B/32 bf16, YOLOv8n at 640 px, random weights
    from seed 0) on a real 1280×720 mp4 of 150 frames decoded by the
    port's ``VideoReader`` (sample rate 1, frames fitted to 512 px):
    ``traditional`` cold and again (the result cache), ``fast_match``,
    ``cross_domain``, ``object_focused``, ``hybrid`` and ``smart_match``
    twice, top 5, clips cut in the first call only; launch counts zeroed
    before the first call. Then eight threads through the batching
    executor, and the card against the CPU's f32 plain path."""
    import copy
    import threading

    try:
        import cv2
    except ImportError:
        fail("cv2 is missing: image query decodes, hashes and cuts clips "
             "with cv2")
    from avede_tpu_torch.io import video_reader
    from avede_tpu_torch.io.embedding_cache import table_tag
    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.ops import attention, kernels, quant
    from avede_tpu_torch.ops.preprocess import clip_preprocess
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services import video_processor
    from avede_tpu_torch.services.detector import extract_object_embeddings
    from avede_tpu_torch.services.image_matcher import COMPOSITE

    video_processor.validate_video = video_reader.validate_video
    path = tmp / f"{IMAGE_VIDEO_ID}.mp4"
    source = write_image_query_video(np, path)
    cap = cv2.VideoCapture(str(path))
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
    source.update(reader_backend=cap.getBackendName(),
                  read_fourcc="".join(chr((fourcc >> 8 * k) & 255)
                                      for k in range(4)),
                  frames_reported=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
    cap.release()
    t0 = time.perf_counter()
    frames, ts = video_reader.VideoReader(sample_rate=1).extract_frames(
        str(path))
    source["decode_s"] = time.perf_counter() - t0
    source["decoded_shape"] = list(frames.shape)
    if len(frames) != IMAGE_FRAMES:
        print(video_io_info(cv2), file=sys.stderr)
        fail(f"image query: the port's reader decoded {len(frames)} of "
             f"{IMAGE_FRAMES} frames of {path}")
    refs = image_query_refs(np, frames)

    proc = video_processor.VideoProcessor(engine=engine)
    phase4 = proc.image_matching
    matcher = phase4.matcher
    t0 = time.perf_counter()
    yolo = matcher.yolo                                  # YOLOv8n
    build_s = time.perf_counter() - t0
    stages: dict = {}
    undo = image_query_stages(stages, proc)
    counted = (attention.flash_attention_blhd, kernels.fused_patch_embed_i420,
               kernels.cosine_window_topk, kernels.cosine_topk_f32,
               kernels.cosine_topk_bf16, kernels.cosine_topk_int8,
               quant.quantize_rows, kernels.fused_patch_embed,
               attention.flash_attention, kernels.cosine_scores,
               kernels.cosine_scores_bf16, kernels.cosine_scores_int8,
               quant.quantize_per_channel)
    calls = (("traditional_cold", "traditional", "A", None, True),
             ("traditional_again", "traditional", "A", None, False),
             ("fast_match", "fast_match", "B", -1.0, False),
             ("cross_domain", "cross_domain", "C", None, False),
             ("object_focused", "object_focused", "B", -1.0, False),
             ("hybrid", "hybrid", "B", None, False),
             ("smart_match_A", "smart_match", "A", None, False),
             ("smart_match_C", "smart_match", "C", None, False))
    runs, first = {}, None
    reset_launches(counted)
    before = read_launches(counted)
    t_phase = time.perf_counter()
    for name, mode, ref, thr, clips in calls:
        stages.clear()
        runs_before = matcher.stats["matches_run"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = proc.process_image_matching(
            str(path), refs[ref], matching_mode=mode, top_k=IMAGE_TOP_K,
            similarity_threshold=thr, extract_clips=clips,
            video_id=IMAGE_VIDEO_ID)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        now = read_launches(counted)
        if out["status"] != "completed":
            fail(f"image query ({name}): {out}")
        res = out["results"]
        sims = [r["similarity"] for r in res]
        if not np.all(np.isfinite(sims)) or sims != sorted(sims,
                                                           reverse=True) \
                or not all(0.0 <= r["timestamp"] < IMAGE_FRAMES / FPS
                           and 0.0 <= r["quality_score"] <= 1.0
                           for r in res):
            fail(f"image query ({name}): results not finite, sorted, "
                 f"inside the video and of quality in [0, 1]: {res[:3]}")
        runs[name] = {
            "mode": mode, "reference": ref, "threshold": thr,
            "wall_s": wall_s, "results": len(res),
            "top": [(r["frame_index"], round(r["similarity"], 6))
                    for r in res],
            "matched": runs_before != matcher.stats["matches_run"],
            "host_stages_s": host_stage_report(stages),
            "launches": {k: now[k] - before[k] for k in now if now[k]
                         - before[k]}}
        before = now
        if name == "traditional_cold":
            first = copy.deepcopy(res)
            if not res or abs(res[0]["frame_index"] - IMAGE_REF) > 15 \
                    or set(res[0]["breakdown"]) != set(COMPOSITE) \
                    or len(out["clips"]) != len(res):
                fail(f"image query: traditional found {runs[name]['top']} "
                     f"with {len(out['clips'])} clips, not frame "
                     f"{IMAGE_REF} ± 15 with its parts and clips")
            for clip in out["clips"]:
                cap = cv2.VideoCapture(clip["clip_path"])
                ok = cap.read()[0]
                cap.release()
                if not ok:
                    fail(f"image query: cv2 reads no frame of {clip}")
            runs[name]["clips"] = [(c["start_time"], c["end_time"])
                                   for c in out["clips"]]
        elif name == "traditional_again":
            if res != first or runs[name]["matched"] \
                    or runs[name]["launches"]:
                fail("image query: the repeated call missed the result "
                     "cache or answered differently")
        elif name in ("fast_match", "object_focused") \
                and len(res) != IMAGE_TOP_K:
            fail(f"image query ({name}) at threshold -1: {len(res)} "
                 f"results")
    calls_s = time.perf_counter() - t_phase
    launches = read_launches(counted)
    for u in undo:
        u()
    patch, l50 = "fused_patch_embed_i420", FLASH_L50
    per = {n: r["launches"] for n, r in runs.items()}
    if not (per["traditional_cold"].get(patch, 0) > 0
            and per["traditional_cold"].get(l50, 0) > 0):
        fail(f"image query: the cold call launched no patch embed or "
             f"flash at L = {CLIP_TOKENS}: {per['traditional_cold']}")
    for name in list(runs)[2:]:
        if per[name].get(patch, 0):
            fail(f"image query ({name}): the warm table re-embedded")
    for name in ("object_focused", "hybrid", "smart_match_A",
                 "smart_match_C"):
        if per[name].get(l50, 0) <= 0:
            fail(f"image query ({name}): no flash launch for the crops")
    if launches[FLASH_L577] or any(
            n for k, n in launches.items()
            if not k.startswith("flash_attention_blhd")
            and k not in (patch, f"{patch}[wgmma]")):
        fail(f"image query: a kernel off this path ran: {launches}")

    # eight threads through the batching executor at once, each with 3-20
    # crops of the decoded frames, against direct embed_pixels calls
    rng = np.random.default_rng(8)
    crops = []
    for n in rng.integers(3, 21, 8):
        mine = []
        for _ in range(int(n)):
            f = frames[int(rng.integers(0, IMAGE_FRAMES))]
            y0, x0 = int(rng.integers(0, 200)), int(rng.integers(0, 400))
            hh, ww = rng.integers(16, 88, 2)
            mine.append(np.ascontiguousarray(f[y0: y0 + hh, x0: x0 + ww]))
        crops.append(mine)
    batcher = engine._pixel_batcher()
    stats0 = batcher.stats
    outs, start = [None] * 8, threading.Barrier(8)

    def work(i):
        start.wait()
        outs[i] = engine.embed_images(crops[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stats = {k: v - stats0[k] for k, v in batcher.stats.items()}
    direct = [engine.embed_pixels(torch.cat([clip_preprocess(
        torch.from_numpy(c[None]).cuda(), size=engine.cfg.image_size)
        for c in mine])) for mine in crops]
    executor = {"stats": stats, "min_row_cosine": min(
        row_cosine(np, o, d) for o, d in zip(outs, direct))}
    if any(t.is_alive() for t in threads) or stats["requests"] != 8 \
            or stats["batches"] >= stats["requests"] \
            or executor["min_row_cosine"] < 0.999:
        fail(f"image query: the batching executor on the card: {executor}")

    # the card's bf16 against the CPU's f32 plain path on the same seeded
    # weights: frames, reference B, 16 YOLO crops of frame A, and the
    # traditional composite of the 40 CLIP survivors with its CLIP part
    # recomputed from the CPU's embeddings
    t0 = time.perf_counter()
    cpu_clip = ClipEngine(cfg=vit_b32(), device="cpu", seed=0)
    eight = frames[:: IMAGE_FRAMES // 8][:8]
    boxes = [d["bbox"] for d in yolo.detect(frames[IMAGE_REF: IMAGE_REF + 1]
                                             )[0][:16]]
    checks = {
        "frames_min_row_cosine": row_cosine(
            np, engine.embed_frames(eight), cpu_clip.embed_frames(eight)),
        "reference_B_row_cosine": row_cosine(
            np, engine.embed_images([refs["B"]]),
            cpu_clip.embed_images([refs["B"]])),
        "yolo_crops": len(boxes),
        "yolo_crops_min_row_cosine": row_cosine(
            np, extract_object_embeddings(engine, refs["A"], boxes),
            extract_object_embeddings(cpu_clip, refs["A"], boxes)),
    }
    table = matcher.cache.get_entry(IMAGE_VIDEO_ID,
                                    table_tag(engine.model_tag), 1)[0]
    clip_sims = table @ engine.embed_images([refs["A"]])[0]
    survivors = matcher._traditional(refs["A"], frames, ts, clip_sims, -1.0)
    idx = [m["frame_index"] for m in survivors]
    cpu_sims = cpu_clip.embed_frames(frames[idx]) \
        @ cpu_clip.embed_images([refs["A"]])[0]
    card_score = [m["similarity"] for m in survivors]
    cpu_score = [m["similarity"] + COMPOSITE["clip"] * (
        max(float(c), 0.0) - max(m["breakdown"]["clip"], 0.0))
        for m, c in zip(survivors, cpu_sims)]
    checks.update(
        traditional_survivors=len(idx),
        traditional_top_card=idx[int(np.argmax(card_score))],
        traditional_top_cpu_clip=idx[int(np.argmax(cpu_score))],
        survivor_clip_max_abs_diff=float(np.abs(
            cpu_sims - np.array([m["breakdown"]["clip"]
                                 for m in survivors])).max()),
        card_and_cpu_s=time.perf_counter() - t0)
    if min(v for k, v in checks.items() if k.endswith("cosine")) < 0.99 \
            or not boxes or checks["traditional_top_card"] \
            != checks["traditional_top_cpu_clip"]:
        fail(f"image query card vs CPU: {checks}")
    del cpu_clip
    return {
        "source": {**source, "width": IMAGE_W, "height": IMAGE_H,
                   "frames": IMAGE_FRAMES, "fps": FPS,
                   "reference_frame": IMAGE_REF,
                   "reference_shapes": {k: list(v.shape)
                                        for k, v in refs.items()}},
        "yolo_build_s": build_s, "calls": runs, "calls_s": calls_s,
        "launches": launches, "executor": executor, **checks,
    }


def person_scene(np, cv2, ids, background, i: int):
    """Frame ``i`` of phase 13's source, BGR uint8 [720, 1280, 3]: the
    identities of ``ids`` walking over ``background``, each a person of
    its own height bouncing along its own line (the port's
    ``utils.synthetic`` person drawer)."""
    from avede_tpu_torch.utils.synthetic import _draw_person_into

    rgb = background.copy()
    for ident, (ph, x, y, vx, vy) in zip(ids, PERSON_WALKS):
        pw = int(ph * 0.45)
        cx = pw // 2 + _bounce(x + vx * i, IMAGE_W - pw - 1)
        cy = ph // 2 + _bounce(y + vy * i, IMAGE_H - ph - 1)
        # outfits are fixed, so the drawer draws no random numbers
        _draw_person_into(rgb, ident, None, (cx, cy), ph)
    return cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)


def write_person_video(np, path):
    """Phase 13's source as a real mp4 (``mp4v``, 1280×720, 30 fps, 300
    frames): four seeded identities with fixed outfits walking over a
    seeded textured background → (source report, the reference image:
    the first identity drawn alone by ``draw_person``, RGB)."""
    import cv2

    from avede_tpu_torch.utils.synthetic import (draw_person, make_identity,
                                                 with_outfit)

    rng = np.random.default_rng(13)
    ids = [with_outfit(make_identity(rng), rng) for _ in PERSON_WALKS]
    coarse = rng.integers(40, 200, (18, 32, 3), dtype=np.uint8)
    background = np.clip(cv2.resize(coarse, (IMAGE_W, IMAGE_H),
                                    interpolation=cv2.INTER_CUBIC
                                    ).astype(np.int16)
                         + rng.integers(-14, 15, (IMAGE_H, IMAGE_W, 3)),
                         0, 255).astype(np.uint8)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             FPS, (IMAGE_W, IMAGE_H))
    if not writer.isOpened():
        print(video_io_info(cv2), file=sys.stderr)
        fail(f"cv2 cannot write {path} (mp4v)")
    t0 = time.perf_counter()
    for i in range(PERSON_FRAMES):
        writer.write(person_scene(np, cv2, ids, background, i))
    writer.release()
    ref, ref_box = draw_person(ids[0], rng, frame_hw=(480, 320))
    return {"write_s": time.perf_counter() - t0,
            "bytes": Path(path).stat().st_size, "frames": PERSON_FRAMES,
            "width": IMAGE_W, "height": IMAGE_H, "fps": FPS,
            "identities": len(ids), "reference_shape": list(ref.shape),
            "reference_box": ref_box}, ref


def timed_generator(stages: dict, owner, name: str, label: str):
    """Like ``timed_stage``, for a generator method: each step of the
    generator adds its wall to ``stages[label]``."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        it = fn(*args, **kwargs)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                stages[label] = stages.get(label, 0.0) \
                    + time.perf_counter() - t0
            yield item

    setattr(owner, name, wrapper)
    return lambda: delattr(owner, name)


def person_stages(stages: dict, svc) -> list:
    """Wrap the person search's host stages → functions that undo the
    wraps. ``extract_features`` holds the lighting, crop-embedding,
    silhouette, appearance, face-region and face-embedding stages."""
    from avede_tpu_torch.services import detector, person_detector

    det = svc.detector
    wraps = [(det.yolo, "detect", "yolo"),
             (person_detector, "normalize_lighting", "lighting"),
             (detector, "extract_object_embeddings", "crop_embeddings"),
             (person_detector, "_silhouette", "grabcut_silhouettes"),
             (det, "extract_features", "extract_features")]
    if det.appearance is not None:
        wraps.append((det.appearance, "embed", "appearance_embeds"))
    if det.face_embedder is not None:
        wraps.append((det.face_embedder, "embed", "face_embeds"))
    if det._face_yolo is not None:
        wraps.append((det._face_yolo, "detect", "face_yolo"))
    return ([timed_generator(stages, svc.reader, "stream_batches",
                             "decode")]
            + [timed_stage(stages, *w) for w in wraps])


def drive_person_search(torch, np, engine, tmp: Path):
    """Phase 13: person search through
    ``VideoProcessor.process_person_search`` at full width (CLIP ViT-B/32
    bf16, YOLOv8n at 640 px bf16 from ``YOLO_WEIGHTS``: seed-0 random
    weights with the person class's logit bias at ``PERSON_BIAS``, at most
    ``PERSON_MAX_BOXES`` boxes a frame) on a real 1280×720 mp4 of 300
    frames decoded by the port's ``VideoReader`` (every
    ``PERSON_FRAME_SKIP``-th frame, fitted to 512 px). Call (a):
    the defaults, no weights (the gray-crop face, GrabCut body and CLIP
    visual cues), then again under the profiler; call (b): the appearance
    encoder, the face-region YOLO and the face embedder loaded from
    ``.npz`` files in the JAX package's layout (``APPEARANCE_WEIGHTS``,
    ``FACE_DETECTOR_WEIGHTS``, ``FACE_EMBED_WEIGHTS``; port random weights
    from seed 0, f32), at threshold -1 with annotated frames saved. Then
    one frame's CLIP visual, appearance and face rows on the card against
    the CPU's f32 plain path, on the card's person boxes."""
    try:
        import cv2
    except ImportError:
        fail("cv2 is missing: person search decodes, normalises lighting "
             "and segments with cv2")
    from avede_tpu_torch.io import video_reader
    from avede_tpu_torch.models.appearance import (AppearanceEmbedder,
                                                   face_embed_config,
                                                   init_appearance)
    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.models.convert import save_params
    from avede_tpu_torch.models.yolo import YoloConfig, init_yolo, yolov8n
    from avede_tpu_torch.ops import attention, kernels, quant
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services import person_detector, video_processor
    from avede_tpu_torch.services.detector import (YoloService,
                                                   extract_object_embeddings)
    from avede_tpu_torch.utils.config import settings
    from avede_tpu_torch.utils.synthetic import head_crop

    video_processor.validate_video = video_reader.validate_video
    path = tmp / "person-search.mp4"
    source, ref = write_person_video(np, path)
    # random YOLOv8n scores every class about 0.5 and keeps no person
    # box on this video (seen on an H100): the person class's logit bias
    # is raised to PERSON_BIAS in a weight file of its seed-0 weights, so
    # every anchor's best class is "person" at sigmoid(PERSON_BIAS) above
    # detect_persons' fixed 0.3, and DETECTION_MAX_OBJECTS caps the boxes
    # NMS keeps a frame
    yolo_model = init_yolo(yolov8n(), seed=0)
    with torch.no_grad():
        for i in range(3):
            getattr(yolo_model, f"head_cls_{i}_2").bias[0] = PERSON_BIAS
    yolo_file = tmp / "yolov8n_person.npz"
    save_params(yolo_model, str(yolo_file))
    del yolo_model
    saved = {k: getattr(settings, k)
             for k in ("YOLO_WEIGHTS", "DETECTION_MAX_OBJECTS")}
    settings.YOLO_WEIGHTS = str(yolo_file)
    settings.DETECTION_MAX_OBJECTS = PERSON_MAX_BOXES
    proc = video_processor.VideoProcessor(engine=engine)
    t0 = time.perf_counter()
    svc = proc.person                          # the detector, YOLOv8n
    yolo = svc.detector.yolo
    build_s = time.perf_counter() - t0
    counted = (attention.flash_attention_blhd, kernels.fused_patch_embed_i420,
               kernels.cosine_window_topk, kernels.cosine_topk_f32,
               kernels.cosine_topk_bf16, kernels.cosine_topk_int8,
               quant.quantize_rows, kernels.fused_patch_embed,
               attention.flash_attention, kernels.cosine_scores,
               kernels.cosine_scores_bf16, kernels.cosine_scores_int8,
               quant.quantize_per_channel)

    def call(name, **kw):
        stages: dict = {}
        undo = person_stages(stages, proc.person)
        cv2.setRNGSeed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = proc.process_person_search(str(path), ref, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        for u in undo:
            u()
        if out["status"] != "completed":
            fail(f"person search ({name}): {out}")
        summ = out["summary"]
        sims = [m["similarity"] for m in out["matches"]]
        if summ["frames_processed"] != PERSON_FRAMES // \
                settings.PERSON_FRAME_SKIP or not np.all(np.isfinite(sims)) \
                or not all(0.0 <= m["timestamp"] < PERSON_FRAMES / FPS
                           for m in out["matches"]):
            fail(f"person search ({name}): {summ}, {sims[:5]}")
        if summ["frames_with_persons"] == 0:
            fail(f"person search ({name}): no person box reached "
                 f"extract_features: {summ}")
        return out, {"wall_s": wall_s, "host_stages_s": stages,
                     "matches": len(out["matches"]),
                     "summary": {k: v for k, v in summ.items()
                                 if k != "presence_segments"},
                     "presence_segments": len(summ["presence_segments"])}

    reset_launches(counted)
    out_a, runs_a = call("a")
    (out_again, _), profiled = device_window(
        torch, lambda: call("a, profiled"))
    if out_again["matches"] != out_a["matches"]:
        fail("person search: the repeated call (a) answered differently")

    # call (b): the learned cues, from .npz files in the JAX layout
    weights = {"APPEARANCE_WEIGHTS": init_appearance(seed=0),
               "FACE_DETECTOR_WEIGHTS": init_yolo(YoloConfig(
                   num_classes=1, scale="n", img_size=64), seed=0),
               "FACE_EMBED_WEIGHTS": init_appearance(face_embed_config(),
                                                     seed=0)}
    for setting, model in weights.items():
        file = tmp / f"{setting.lower()}.npz"
        save_params(model, str(file))
        setattr(settings, setting, str(file))
    proc._person = person_detector.PersonSearchService(
        engine, detector=person_detector.PersonDetector(engine, yolo=yolo))
    det = proc.person.detector
    if det.appearance is None or det._face_yolo is None \
            or det.face_embedder is None:
        fail("person search: the learned cues did not load from settings")
    out_b, runs_b = call("b", similarity_threshold=-1.0,
                         save_annotated_frames=True)
    launches = read_launches(counted)
    annotated = out_b["annotated_frames"]
    if not out_b["matches"] or len(annotated) != min(
            50, len(out_b["matches"])) or not all(
            Path(p).exists() for p in annotated):
        fail(f"person search (b): {len(out_b['matches'])} matches, "
             f"{len(annotated)} annotated frames")
    if launches[FLASH_L50] <= 0 or any(
            n for k, n in launches.items()
            if not k.startswith("flash_attention_blhd")) \
            or launches[FLASH_L577] or launches[FLASH_L257]:
        fail(f"person search: flash never launched at L = {CLIP_TOKENS} "
             f"or a kernel off this path ran: {launches}")

    # one frame's rows on the card against the CPU's f32 plain path, on
    # the card's person boxes
    t0 = time.perf_counter()
    frames, _ = video_reader.VideoReader(sample_rate=1).extract_frames(
        str(path), max_frames=PERSON_FRAMES)
    pick = next((i for i in range(0, PERSON_FRAMES,
                                  settings.PERSON_FRAME_SKIP)
                 if det.detect_persons(frames[i:i + 1])[0]), None)
    if pick is None:
        fail("person search: no sampled frame has a person box")
    frame = frames[pick]
    boxes = [d["bbox"] for d in det.detect_persons(frame[None])[0]]
    norm = person_detector.normalize_lighting(frame)
    cpu_clip = ClipEngine(cfg=vit_b32(), device="cpu", seed=0)
    cpu_app = AppearanceEmbedder(state_dict={
        k: v.cpu() for k, v in det.appearance.model.state_dict().items()},
        device="cpu")
    cpu_face = AppearanceEmbedder(face_embed_config(), state_dict={
        k: v.cpu() for k, v in det.face_embedder.model.state_dict().items()},
        device="cpu")
    cpu_face_yolo = YoloService(
        cfg=det._face_yolo.cfg, class_names=["face"], device="cpu",
        state_dict={k: v.float().cpu() for k, v in
                    det._face_yolo.model.state_dict().items()})
    heads = [head_crop(frame, b) for b in boxes]
    # the face encoder's rows on the face boxes extract_features embeds,
    # or, where random face-YOLO weights give none of at least 4 px a
    # side, on the person crops
    faces, face_source = [], "face-YOLO boxes"
    for source_boxes in ([det.find_faces_scored(norm, b)[0] for b in boxes],
                         boxes):
        faces = [c for c in (person_detector.crop(frame, fb)
                             for fb in source_boxes)
                 if c.size and min(c.shape[:2]) >= 4]
        if faces:
            break
        face_source = "person crops"
    face_box_diff = []
    for b in boxes:
        region = person_detector.crop(norm, b)
        if region.size and min(region.shape[:2]) >= 8:
            got = det._face_yolo.detect(region[None], conf_threshold=0.15)[0]
            want = cpu_face_yolo.detect(region[None], conf_threshold=0.15)[0]
            if got and want and len(got) == len(want):
                face_box_diff.append(max(
                    abs(a - c) for g, w in zip(got, want)
                    for a, c in zip(g["bbox"], w["bbox"])))
    checks = {
        "frame": pick, "person_boxes": len(boxes),
        "visual_min_row_cosine": row_cosine(
            np, extract_object_embeddings(engine, norm, boxes),
            extract_object_embeddings(cpu_clip, norm, boxes)),
        "appearance_min_row_cosine": row_cosine(
            np, det.appearance.embed(heads), cpu_app.embed(heads)),
        "face_crops": len(faces), "face_crop_source": face_source,
        "face_min_row_cosine": row_cosine(
            np, det.face_embedder.embed(faces), cpu_face.embed(faces))
        if faces else None,
        "face_yolo_max_box_diff_px": max(face_box_diff, default=None),
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "card_and_cpu_s": time.perf_counter() - t0}
    if min(checks[k] for k in ("visual_min_row_cosine",
                               "appearance_min_row_cosine",
                               "face_min_row_cosine")
           if checks[k] is not None) < 0.9999 or not faces:
        fail(f"person search card vs CPU: {checks}")
    for setting in weights:
        setattr(settings, setting, None)
    for k, v in saved.items():
        setattr(settings, k, v)
    del cpu_clip, proc
    return {"source": source, "build_s": build_s,
            "person_bias": PERSON_BIAS, "max_boxes": PERSON_MAX_BOXES,
            "calls": {"a": runs_a, "b": runs_b}, "a_profiled": profiled,
            "launches": launches, **checks}


def decode_capabilities() -> dict:
    """What this machine could decode video and serve HTTP with, read
    without installing anything: ``torchvision.io``'s video backends,
    torchaudio's ffmpeg binding, ``av``, the shared libraries
    ``ctypes.util.find_library`` finds (``avcodec``, ``avformat``,
    NVIDIA's ``nvcuvid``), an ``ffmpeg`` binary, ``cv2`` and ``aiohttp``."""
    import ctypes.util
    import importlib
    import shutil

    out = {}

    def probe(name, fn):
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 — a report, not a check
            out[name] = f"unavailable: {type(exc).__name__}: {exc}"[:200]

    def version(mod):
        return getattr(importlib.import_module(mod), "__version__", "?")

    probe("torchvision", lambda: version("torchvision"))
    probe("torchvision.video_backend", lambda: importlib.import_module(
        "torchvision").get_video_backend())
    probe("torchvision.io.read_video", lambda: callable(
        importlib.import_module("torchvision.io").read_video))
    probe("torchaudio", lambda: version("torchaudio"))
    probe("torchaudio.ffmpeg", lambda: str(importlib.import_module(
        "torchaudio.utils.ffmpeg_utils").get_versions()))
    for mod in ("av", "cv2", "aiohttp", "decord"):
        probe(mod, lambda mod=mod: version(mod))
    for lib in ("avcodec", "avformat", "nvcuvid", "nvidia-encode"):
        probe(f"lib{lib}", lambda lib=lib: ctypes.util.find_library(lib))
    probe("ffmpeg_binary", lambda: shutil.which("ffmpeg"))
    return out


def unit_rows(np, seed: int, n: int, dim: int):
    x = np.random.default_rng(seed).standard_normal((n, dim),
                                                   dtype=np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def train_steps(torch, np, name, state, step, args, n_steps):
    """Phase 14: ``n_steps`` of ``step`` on one fixed batch → (state, the
    run's report): each step's ms by CUDA events (their median over
    steps 3 on), the losses and gradient norms, the peak memory. Every
    loss must be finite and the last below the first."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n_steps)]
    metrics = []
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        state, m = step(state, *args)
        end.record()
        metrics.append(m)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train {name}: losses not finite and falling: {losses}")
    return state, {
        "steps": n_steps, "step_ms_median_from_3": statistics.median(ms[2:]),
        "step_ms": ms, "first_loss": losses[0], "last_loss": losses[-1],
        "losses": losses, "first_grad_norm": norms[0],
        "last_grad_norm": norms[-1],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "wall_s": wall_s}


def first_step_vs_cpu(name, card, cpu):
    """Phase 14: one step's (loss, gradient norm) on the card and on the
    CPU, from one seed on one batch → report; loss within
    ``TRAIN_LOSS_REL``, gradient norm within ``TRAIN_NORM_REL``."""
    (lc, gc), (lr, gr) = card, cpu
    rel = {"loss_rel_diff": abs(lc - lr) / abs(lr),
           "grad_norm_rel_diff": abs(gc - gr) / gr,
           "card": {"loss": lc, "grad_norm": gc},
           "cpu": {"loss": lr, "grad_norm": gr}}
    if not (rel["loss_rel_diff"] <= TRAIN_LOSS_REL
            and rel["grad_norm_rel_diff"] <= TRAIN_NORM_REL):
        fail(f"train {name}: card vs CPU first step {rel}")
    return rel


def one_step(step, state, *args):
    """(loss, gradient norm) of one step, read back."""
    _, m = step(state, *args)
    return float(m["loss"]), float(m["grad_norm"])


def train_and_check(torch, np, name, make, args, cpu_rows, n_steps):
    """Phase 14, one trainer: ``make(device)`` → (model, state, step).
    The card's first step on the first ``cpu_rows`` rows of ``args``
    against the CPU's; then the card's state is reset to its start and
    runs ``n_steps`` on the whole batch → (model, state, report)."""
    import copy

    model, state, step = make("cuda")
    start = copy.deepcopy(state.state_dict())
    card_args = [torch.from_numpy(a).cuda() for a in args]
    card = one_step(step, state, *(a[:cpu_rows] for a in card_args))
    state.load_state_dict(start)
    del start
    t0 = time.perf_counter()
    cpu_model, cpu_state, cpu_step = make("cpu")
    cpu = one_step(cpu_step, cpu_state,
                   *(torch.from_numpy(a[:cpu_rows]) for a in args))
    cpu_s = time.perf_counter() - t0
    del cpu_model, cpu_state, cpu_step
    gc.collect()
    state, report = train_steps(torch, np, name, state, step, card_args,
                                n_steps)
    report["card_vs_cpu"] = {**first_step_vs_cpu(name, card, cpu),
                             "rows": cpu_rows, "cpu_s": cpu_s}
    report["batch"] = int(args[0].shape[0])
    return model, state, step, card_args, report


def caption_batch(np, cfg, rows: int):
    """Phase 14(b)'s fixed batch: normal pixels (BLIP-normalized) and
    ``TRAIN_CAPTION_LEN``-token ids below BOS, BOS first, row i ending in
    EOS at 10 + i and PAD after it."""
    rng = np.random.default_rng(0)
    px = rng.normal(size=(rows, cfg.image_size, cfg.image_size, 3)
                    ).astype(np.float32)
    ids = rng.integers(1, cfg.bos_token_id, size=(rows, TRAIN_CAPTION_LEN))
    ids[:, 0] = cfg.bos_token_id
    for i in range(rows):
        end = min(10 + i, TRAIN_CAPTION_LEN - 1)
        ids[i, end] = cfg.eos_token_id
        ids[i, end + 1:] = cfg.pad_token_id
    return px, ids


def train_detectors(torch, np) -> dict:
    """Phase 14(f): YOLOv8n and OWL-ViT B/32 trained at full width
    (``train_and_check``: the card's first step against the CPU's, then
    10 steps on the fixed batch); the YOLO's BatchNorm statistics must
    stay as they were, and neither trainer may launch the flash kernel."""
    from avede_tpu_torch.models.owlvit import owlvit_base_patch32
    from avede_tpu_torch.models.tokenizer import Tokenizer
    from avede_tpu_torch.models.yolo import yolov8n
    from avede_tpu_torch.ops import attention
    from avede_tpu_torch.parallel.train_det import (create_yolo_train_state,
                                                    make_yolo_train_step)
    from avede_tpu_torch.parallel.train_owl import (create_owl_train_state,
                                                    make_owl_train_step)

    out = {}
    yolo_cfg, owl_cfg = yolov8n(), owlvit_base_patch32()

    def make_yolo(dev):
        model, state = create_yolo_train_state(yolo_cfg, seed=0, device=dev)
        return model, state, make_yolo_train_step(model)

    def make_owl(dev):
        model, state = create_owl_train_state(owl_cfg, TRAIN_OWL_LR, seed=0,
                                              device=dev)
        tok = Tokenizer(vocab_size=owl_cfg.vocab_size,
                        context_len=owl_cfg.max_text_len)
        return model, state, make_owl_train_step(model,
                                                 tok(DETECTION_QUERIES))

    flash_before = attention.flash_attention_blhd.launches_by_length.total()
    model, _, _, _, out["yolo"] = train_and_check(
        torch, np, "yolo", make_yolo,
        detection_batch(np, TRAIN_YOLO[0], yolo_cfg.img_size,
                        yolo_cfg.num_classes), TRAIN_YOLO[2], TRAIN_YOLO[1])
    stats = [(n, b) for n, b in model.named_buffers() if "running" in n]
    moved = [n for n, b in stats
             if not torch.equal(b, torch.zeros_like(b) if "mean" in n
                                else torch.ones_like(b))]
    if not stats or moved:
        fail(f"train yolo: BatchNorm statistics moved: {moved[:4]}")
    out["yolo"].update(img_size=yolo_cfg.img_size,
                       num_classes=yolo_cfg.num_classes,
                       batchnorm_stats_frozen=len(stats))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    frames, boxes, labels, mask = detection_batch(
        np, TRAIN_OWL[0], owl_cfg.image_size, len(DETECTION_QUERIES))
    out["owl"] = train_and_check(
        torch, np, "owl", make_owl,
        (frames, (boxes / owl_cfg.image_size).astype(np.float32), labels,
         mask), TRAIN_OWL[2], TRAIN_OWL[1])[-1]
    out["owl"].update(image_size=owl_cfg.image_size,
                      tokens=owl_cfg.num_patches + 1,
                      queries=list(DETECTION_QUERIES))
    if attention.flash_attention_blhd.launches_by_length.total() \
            != flash_before:
        fail("a detector train step launched the flash kernel")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def detection_batch(np, rows: int, size: int, n_classes: int):
    """Phase 14's fixed detection batch: ``rows`` seeded scenes of up to
    ``TRAIN_DET_BOXES`` non-overlapping shapes (radius 12-48 px scaled
    to ``size``/640), labels folded into ``n_classes`` → (uint8 frames,
    xyxy px boxes, labels, mask)."""
    from avede_tpu_torch.utils.synthetic import draw_shape_scene

    rng = np.random.default_rng(0)
    k = size / 640
    data = [draw_shape_scene(rng, hw=(size, size), max_boxes=TRAIN_DET_BOXES,
                             min_r=int(12 * k), max_r=int(48 * k),
                             non_overlapping=True) for _ in range(rows)]
    frames, boxes, labels, mask = (np.stack([d[i] for d in data])
                                   for i in range(4))
    return frames, boxes, (labels % n_classes).astype(np.int32), mask


def drive_train(torch, np, engine, video, tmp: Path):
    """Phase 14: the port's trainers at full width in f32 (TF32 off: phase
    3 turned it off for the process, and each train step turns cuDNN's
    off itself), then the trained CLIP served through the kernels, then
    the grounding eval.

    (a) CLIP ViT-B/32 from seed 0, ``make_train_step`` (clip 1.0, adamw
    1e-4 / 0.05), one fixed seeded batch of 32 images (224 px) and
    77-token ids, 10 steps, then one more under the profiler; (b)
    BLIP-base's caption step (``use_flash=False``, 384 px, 577 tokens,
    adam 1e-4 behind clip 1.0), batch 8 of 20-token ids with pads, 5
    steps; (c) the default grounding head (512 → 256, depth 4) at B = 16,
    N = 256 and the default appearance encoder (64 px) at batch 64, 10
    steps each; (f) the detector trainers (``parallel/train_det.py``,
    ``train_owl.py``): YOLOv8n at 640 px with 80 classes (adam 2e-3
    behind clip 5.0, frozen BatchNorm statistics) on 16 scenes of up to 8
    shapes, and OWL-ViT B/32 at 768 px (577 tokens, ``use_flash=False``)
    on 4 scenes against the three ``DETECTION_QUERIES`` (adam 1e-4 behind
    clip 5.0), 10 steps each. Each trainer's first step is held to the
    CPU's at a small batch. (d) the CLIP of (a) written by
    ``save_params`` and served by a
    ``ClipEngine`` (bf16, the kernels) on phase 5's source: one cold
    ``process_video`` and two warm queries, the launches counted as path
    ``train_serve``; its embeddings of 8 frames against the trained f32
    model's own. (e) ``avede_tpu_torch.eval.eval_grounding`` on the card
    (seed 0, 3 seeds of 500 steps), held to EVAL.json's JAX spread."""
    import dataclasses

    from avede_tpu_torch import eval as port_eval
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.models.appearance import AppearanceConfig
    from avede_tpu_torch.models.blip import blip_base, init_blip
    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.models.convert import save_params
    from avede_tpu_torch.models.univtg import TemporalGroundingConfig
    from avede_tpu_torch.ops import attention, kernels, quant
    from avede_tpu_torch.ops.preprocess import clip_preprocess_i420
    from avede_tpu_torch.parallel import optim
    from avede_tpu_torch.parallel import train as T
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.parallel.train_reid import (create_reid_train_state,
                                                     make_reid_train_step)
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan
    from avede_tpu_torch.utils.platform import resolve_device

    out = {}

    # (a) CLIP
    clip_cfg = vit_b32()

    def make_clip(dev):
        model, state = T.create_train_state(clip_cfg, seed=0, device=dev)
        return model, state, T.make_train_step(model)

    clip, clip_state, clip_step, clip_args, out["clip"] = train_and_check(
        torch, np, "clip", make_clip, T.demo_batch(clip_cfg, TRAIN_CLIP[0]),
        TRAIN_CLIP[2], TRAIN_CLIP[1])
    _, out["clip"]["profiled_step"] = device_window(
        torch, lambda: clip_step(clip_state, *clip_args))
    del clip_args
    gc.collect()
    torch.cuda.empty_cache()

    # (b) BLIP-base's caption step
    blip_cfg = dataclasses.replace(blip_base(), use_flash=False)

    def make_blip(dev):
        model = init_blip(blip_cfg, seed=0).to(resolve_device(dev)).train()
        state = T.TrainState(model, optim.adam(model.parameters(), 1e-4,
                                               clip_norm=1.0))
        return model, state, T.make_caption_train_step(
            model, blip_cfg.pad_token_id)

    flash_before = attention.flash_attention_blhd.launches_by_length.total()
    res = train_and_check(torch, np, "caption", make_blip,
                          caption_batch(np, blip_cfg, TRAIN_CAPTION[0]),
                          TRAIN_CAPTION[2], TRAIN_CAPTION[1])
    out["caption"] = res[-1]
    if attention.flash_attention_blhd.launches_by_length.total() \
            != flash_before:
        fail("the caption step launched the flash kernel")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the grounding head and the appearance encoder
    ground_cfg = TemporalGroundingConfig()

    def make_ground(dev):
        model, state = T.create_grounding_train_state(ground_cfg, 1e-3,
                                                      device=dev)
        return model, state, T.make_grounding_train_step(model)

    ground_args, _ = port_eval.grounding_batch(
        np.random.default_rng(0), b=TRAIN_GROUNDING[0], n=TRAIN_GROUNDING_N,
        d=ground_cfg.input_dim)
    out["grounding"] = train_and_check(
        torch, np, "grounding", make_ground, ground_args, TRAIN_GROUNDING[2],
        TRAIN_GROUNDING[1])[-1]

    reid_cfg = AppearanceConfig()

    def make_reid(dev):
        model, state = create_reid_train_state(reid_cfg, 1e-3, device=dev)
        return model, state, make_reid_train_step(model)

    rng = np.random.default_rng(0)
    size = reid_cfg.input_size
    view_a = rng.random((TRAIN_REID[0], size, size, 3)).astype(np.float32)
    view_b = np.clip(view_a * rng.uniform(0.7, 1.3, (TRAIN_REID[0], 1, 1, 1))
                     + rng.normal(0, 0.05, view_a.shape), 0, 1
                     ).astype(np.float32)
    out["reid"] = train_and_check(torch, np, "reid", make_reid,
                                  (view_a, view_b), TRAIN_REID[2],
                                  TRAIN_REID[1])[-1]
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the detector trainers at full width, plain attention
    out.update(train_detectors(torch, np))

    # (d) train, then serve: the trained CLIP through the kernels
    weights = tmp / "clip_trained.npz"
    t0 = time.perf_counter()
    save_params(clip, str(weights))
    save_s = time.perf_counter() - t0
    served = ClipEngine(weights_path=str(weights), device="cuda")
    load_s = time.perf_counter() - t0 - save_s
    needed = (kernels.fused_patch_embed_i420, attention.flash_attention_blhd,
              kernels.cosine_window_topk)
    contracts = (kernels.fused_patch_embed, attention.flash_attention,
                 kernels.cosine_scores, kernels.cosine_scores_bf16,
                 kernels.cosine_scores_int8, quant.quantize_per_channel)
    counted = needed + contracts + (
        kernels.cosine_topk_f32, kernels.cosine_topk_bf16,
        kernels.cosine_topk_int8, quant.quantize_rows)
    scan = Phase1Scan(served, reader=video,
                      cache=EmbeddingCache(str(tmp / "train_serve")))
    path, vid = "memory://synthetic-street", "synthetic-street-trained"
    reset_launches(counted)
    t0 = time.perf_counter()
    cold = scan.process_video(path, QUERIES[0], top_k=10, threshold=-1.0,
                              video_id=vid)
    cold_s = time.perf_counter() - t0
    warm_ms = []
    for q in QUERIES[:2]:
        t0 = time.perf_counter()
        res = scan.process_video(path, q, top_k=10, threshold=-1.0,
                                 video_id=vid)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
        conf = [r["confidence"] for r in res]
        if not res or not np.all(np.isfinite(conf)) \
                or conf != sorted(conf, reverse=True):
            fail(f"train_serve: scores not finite and sorted: {conf}")
    launches = read_launches(counted)
    if any(launches[fn.__name__] <= 0 for fn in needed) \
            or launches[FLASH_L50] <= 0:
        fail(f"train_serve: a kernel of the path never launched: {launches}")
    if any(launches[fn.__name__] for fn in contracts):
        fail(f"train_serve: a contract entry ran: {launches}")
    frames = video._chunk(0, 300)[::300 // TRAIN_SERVE_FRAMES][
        :TRAIN_SERVE_FRAMES]
    got = served.embed_frames(frames)
    with torch.inference_mode():
        px = clip_preprocess_i420(torch.from_numpy(
            served._pack_transfer(frames)).cuda())
        own = clip.encode_image(px).float().cpu().numpy()
    untrained = engine.embed_frames(frames)
    serve = {"cold_s": cold_s, "warm_ms": warm_ms,
             "save_params_s": save_s, "engine_load_s": load_s,
             "weights_mib": weights.stat().st_size / 2 ** 20,
             "top_window": cold[0]["window_index"], "launches": launches,
             "frames": int(len(frames)),
             "served_vs_trained_min_cosine": row_cosine(np, got, own),
             "served_vs_untrained_max_cosine": float(max(
                 row_cosine(np, got[i:i + 1], untrained[i:i + 1])
                 for i in range(len(got))))}
    if serve["served_vs_trained_min_cosine"] < 0.99:
        fail(f"train_serve: served embeddings off the trained model: {serve}")
    if serve["served_vs_untrained_max_cosine"] \
            >= serve["served_vs_trained_min_cosine"]:
        fail(f"train_serve: served embeddings no nearer the trained model "
             f"than the untrained engine's: {serve}")
    out["train_serve"] = serve
    del clip, clip_state, clip_step, served, scan
    weights.unlink()
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the grounding eval on the card
    t0 = time.perf_counter()
    ev = port_eval.eval_grounding(seed=0, device="cuda")
    ev["wall_s"] = time.perf_counter() - t0
    ev["bar"] = {"mean_temporal_iou": GROUNDING_MIN_TIOU,
                 "tiou_at_0.5": GROUNDING_MIN_AT_05}
    if not (ev["mean_temporal_iou"] >= GROUNDING_MIN_TIOU
            and ev["tiou_at_0.5"] >= GROUNDING_MIN_AT_05):
        fail(f"grounding eval below EVAL.json's JAX spread: {ev}")
    out["eval_grounding"] = ev
    return out



def drive_convert(torch, np, video, tmp: Path):
    """Phase 15: a Hugging Face checkpoint into the port without JAX or
    ``transformers``. A random HF-named ViT-B/32 ``CLIPModel`` state dict
    (``hf_clip_state_dict``, seed 0) is written by ``torch.save``, turned
    into the JAX layout's ``.npz`` by ``python -m
    avede_tpu_torch.models.convert --model clip`` (its own process), and
    served by ``ClipEngine(weights_path=..., device="cuda")`` (bf16, the
    kernels) on phase 5's source: one cold ``process_video`` and two warm
    queries, launches zeroed before them and kept as path
    ``convert_serve``. The engine's embeddings of 8 frames must be within
    row cosine 0.9999 of the same file served on the CPU in f32."""
    from avede_tpu_torch.io.embedding_cache import EmbeddingCache
    from avede_tpu_torch.models.clip import vit_b32
    from avede_tpu_torch.ops import attention, kernels
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.pipelines.phase1 import Phase1Scan

    src, out = tmp / "clip_hf.pt", tmp / "clip_hf.npz"
    t0 = time.perf_counter()
    torch.save(hf_clip_state_dict(torch, vit_b32()), src)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "avede_tpu_torch.models.convert", "--model",
         "clip", "--src", str(src), "--out", str(out)], cwd=str(ROOT),
        capture_output=True, text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    if cli.returncode != 0 or "point settings.CLIP_WEIGHTS" not in cli.stdout:
        fail(f"convert CLI: rc {cli.returncode}\n{cli.stdout}\n{cli.stderr}")
    t0 = time.perf_counter()
    served = ClipEngine(weights_path=str(out), device="cuda")
    load_s = time.perf_counter() - t0
    needed = (kernels.fused_patch_embed_i420, attention.flash_attention_blhd,
              kernels.cosine_window_topk)
    contracts = (kernels.fused_patch_embed, attention.flash_attention,
                 kernels.cosine_scores)
    scan = Phase1Scan(served, reader=video,
                      cache=EmbeddingCache(str(tmp / "convert_serve")))
    path, vid = "memory://synthetic-street", "synthetic-street-hf"
    reset_launches(needed + contracts)
    t0 = time.perf_counter()
    cold = scan.process_video(path, QUERIES[0], top_k=10, threshold=-1.0,
                              video_id=vid)
    cold_s = time.perf_counter() - t0
    warm_ms = []
    for q in QUERIES[:2]:
        t0 = time.perf_counter()
        res = scan.process_video(path, q, top_k=10, threshold=-1.0,
                                 video_id=vid)
        warm_ms.append((time.perf_counter() - t0) * 1e3)
        conf = [r["confidence"] for r in res]
        if not res or not np.all(np.isfinite(conf)) \
                or conf != sorted(conf, reverse=True):
            fail(f"convert_serve: scores not finite and sorted: {conf}")
    launches = read_launches(needed + contracts)
    if any(launches[fn.__name__] <= 0 for fn in needed) \
            or launches[FLASH_L50] <= 0:
        fail(f"convert_serve: a kernel of the path never launched: "
             f"{launches}")
    if any(launches[fn.__name__] for fn in contracts):
        fail(f"convert_serve: a contract entry ran: {launches}")
    frames = video._chunk(0, 300)[::300 // CONVERT_FRAMES][:CONVERT_FRAMES]
    got = served.embed_frames(frames)
    cpu = ClipEngine(cfg=vit_b32(), weights_path=str(out), device="cpu")
    ref = cpu.embed_frames(frames)
    report = {"save_s": save_s, "convert_cli_s": convert_s,
              "engine_load_s": load_s, "cold_s": cold_s, "warm_ms": warm_ms,
              "checkpoint_mib": src.stat().st_size / 2 ** 20,
              "npz_mib": out.stat().st_size / 2 ** 20,
              "cli": cli.stdout.strip().splitlines()[0],
              "top_window": cold[0]["window_index"], "launches": launches,
              "frames": int(len(frames)),
              "card_vs_cpu_min_cosine": row_cosine(np, got, ref)}
    if report["card_vs_cpu_min_cosine"] < CONVERT_MIN_COSINE:
        fail(f"convert_serve: card off the CPU on the converted weights: "
             f"{report}")
    del served, cpu, scan
    src.unlink()
    out.unlink()
    gc.collect()
    torch.cuda.empty_cache()
    return report


def drive_eval(torch, np, tmp: Path):
    """Phase 16: the eval modes ``image`` (two seeds, the untrained tiny
    CLIP) and ``text`` (two seeds of 700 training steps) through
    ``avede_tpu_torch.eval.main`` on the card: the tiny towers' I420
    patch embed on its simple kernel and flash at head dim 16 (L = 17)
    must launch, ``cosine_window_topk`` too, the wgmma patch kernel and
    every contract entry not at all; each metric is held to its bar
    (``EVAL_BARS``)."""
    from avede_tpu_torch import eval as port_eval
    from avede_tpu_torch.ops import attention, kernels

    needed = (kernels.fused_patch_embed_i420, attention.flash_attention_blhd,
              kernels.cosine_window_topk)
    contracts = (kernels.fused_patch_embed, attention.flash_attention,
                 kernels.cosine_scores)
    reset_launches(needed + contracts)
    out = {}
    for mode, (section, bar) in EVAL_BARS.items():
        t0 = time.perf_counter()
        res = port_eval.main(["--mode", mode, "--device", "cuda", "--out",
                              str(tmp / f"eval_{mode}.json")])[section]
        wall = time.perf_counter() - t0
        out[mode] = {k: v for k, v in res.items() if k != "per_seed"}
        out[mode].update(per_seed=[r["precision_at_1"]
                                   for r in res["per_seed"]],
                         wall_s=wall, bar=bar)
        if res["precision_at_1"] < bar:
            fail(f"eval {mode}: p@1 {res['precision_at_1']} below its bar "
                 f"{bar}: {out[mode]}")
    launches = out["launches"] = read_launches(needed + contracts)
    if launches[SIMT_PATCH] <= 0 or launches[FLASH_L17] <= 0 \
            or launches["cosine_window_topk"] <= 0:
        fail(f"eval: a kernel of the path never launched: {launches}")
    if launches["fused_patch_embed_i420[wgmma]"] \
            or any(launches[fn.__name__] for fn in contracts):
        fail(f"eval: a kernel off the tiny path ran: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return out

def drive_eval_detection(torch, np):
    """Phase 17: the ``detection`` eval mode's OWL-ViT (64 px, patch 8,
    4 vision layers of 4 heads of 24) trained on the card
    (``avede_tpu_torch.eval._train_tiny_owl``: ``DET_EVAL_STEPS`` steps
    of 16 scenes, f32, plain attention), then served through
    ``UniversalDetector`` (bf16, flash at L = 65 with hd = 24 in every
    vision layer; the tiny CLIP's kernels for the grid and the crops) in
    its ``owlvit`` and ``hybrid`` modes on ``DET_EVAL_FRAMES`` held-out
    128 px scenes, one frame a call, launches counted as path
    ``eval_detection``: flash at L = 65 must launch 4 times a call. The
    card's logits on those frames are held to the same weights' f32
    forward on the CPU (row cosine over each frame's logits >=
    ``DET_EVAL_MIN_COSINE``). P/R at ``DET_EVAL_CONF`` are reported, not
    held (the mode's own run holds its bars)."""
    from avede_tpu_torch import eval as port_eval
    from avede_tpu_torch.models.owlvit import OwlViTDetector
    from avede_tpu_torch.ops import attention, kernels, quant
    from avede_tpu_torch.ops.preprocess import clip_preprocess
    from avede_tpu_torch.services.universal_detector import \
        UniversalDetector
    from avede_tpu_torch.utils.platform import with_compute_dtype
    from avede_tpu_torch.utils.synthetic import SHAPE_CLASSES

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg, sd, loss = port_eval._train_tiny_owl(
        DET_EVAL_STEPS, 0, scene_fn=port_eval._shape_scene128, device=dev)
    out = {"train_steps": DET_EVAL_STEPS, "final_loss": loss,
           "train_s": time.perf_counter() - t0}
    ud = UniversalDetector(port_eval.tiny_clip_engine(dev),
                           owlvit_cfg=with_compute_dtype(cfg, dev),
                           owlvit_state_dict=sd)
    rng = np.random.default_rng(7)
    scenes = [port_eval._shape_scene128(rng) for _ in range(DET_EVAL_FRAMES)]
    counted = (attention.flash_attention_blhd,
               kernels.fused_patch_embed_i420, kernels.cosine_window_topk,
               kernels.fused_patch_embed, attention.flash_attention,
               kernels.cosine_scores, quant.quantize_rows)
    reset_launches(counted)
    calls = 0
    for mode in ("owlvit", "hybrid"):
        tp = fp = fn = 0
        t0 = time.perf_counter()
        for img, gb, gl, gm in scenes:
            dets = ud.detect_unlimited_objects(
                img[None], SHAPE_CLASSES, detection_mode=mode,
                conf_threshold=DET_EVAL_CONF, adaptive=False)[0]
            calls += 1
            a, b, c = port_eval._match_detections(
                port_eval._with_query_ids(dets), gb[gm], gl[gm])
            tp, fp, fn = tp + a, fp + b, fn + c
        out[mode] = {"precision": tp / max(tp + fp, 1),
                     "recall": tp / max(tp + fn, 1), "detections": tp + fp,
                     "call_ms": (time.perf_counter() - t0) * 1e3
                     / len(scenes)}
    launches = out["launches"] = read_launches(counted)
    out["calls"] = calls
    if launches[FLASH_L65] != 4 * calls:
        fail(f"eval_detection: flash at L = {DET_OWL_TOKENS} launched "
             f"{launches[FLASH_L65]} times in {calls} calls, not 4 a call")
    if launches[FLASH_L17] <= 0:
        fail(f"eval_detection: the tiny CLIP's flash never ran: {launches}")
    if any(launches[fn.__name__] for fn in counted[3:]):
        fail(f"eval_detection: a contract entry ran: {launches}")

    # the card's logits against the same weights in f32 on the CPU
    frames = np.stack([sc[0] for sc in scenes])
    ids = ud.owl_tokenizer(list(SHAPE_CLASSES))
    logits, _ = ud.owl_forward(frames, ids)
    cpu = OwlViTDetector(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in sd.items()})
    with torch.inference_mode():
        ref, _ = cpu.eval()(clip_preprocess(torch.from_numpy(frames),
                                            size=cfg.image_size),
                            torch.from_numpy(ids))
    n = len(frames)
    out["card_vs_cpu_min_cosine"] = row_cosine(
        np, logits.float().cpu().numpy().reshape(n, -1),
        ref.numpy().reshape(n, -1))
    if out["card_vs_cpu_min_cosine"] < DET_EVAL_MIN_COSINE:
        fail(f"eval_detection: card logits off the CPU's: {out}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def drive_index(torch, np, dtype: str):
    """Phase 7: a ``DeviceLibraryIndex`` at serving size, 1000 seeded
    videos of 1000 unit rows (each made when it is added), with the
    fused search timed on the device against its bound, a search above
    the fused entry's largest k, and the top 10 of 20 searches held to
    an f32 reference."""
    from avede_tpu_torch.ops import kernels, quant
    from avede_tpu_torch.ops.similarity import topk_scores
    from avede_tpu_torch.services.library_index import DeviceLibraryIndex

    dim, k = 512, 64
    int8 = dtype == "int8"
    fused = kernels.cosine_topk_int8 if int8 else kernels.cosine_topk_bf16
    contract = (kernels.cosine_scores_int8 if int8
                else kernels.cosine_scores_bf16)
    counted = (fused, contract) + ((quant.quantize_rows,) if int8 else ())
    torch.cuda.reset_peak_memory_stats()
    reset_launches(counted)
    index = DeviceLibraryIndex(dim, dtype=dtype, device="cuda")
    grow, growth_s = index._grow_locked, []

    def timed_grow(extra_rows):
        t0 = time.perf_counter()
        grow(extra_rows)
        torch.cuda.synchronize()
        growth_s.append(time.perf_counter() - t0)

    index._grow_locked = timed_grow
    ts = [i / FPS for i in range(INDEX_VIDEO_ROWS)]
    add_ms = []
    for v in range(INDEX_VIDEOS):
        rows = unit_rows(np, v, INDEX_VIDEO_ROWS, dim)
        t0 = time.perf_counter()
        index.add(f"video-{v:04d}", rows, ts)
        torch.cuda.synchronize()
        add_ms.append((time.perf_counter() - t0) * 1e3)
    del index._grow_locked
    if (index.n_rows, index.capacity) != (INDEX_VIDEOS * INDEX_VIDEO_ROWS,
                                          INDEX_CAPACITY):
        fail(f"index ({dtype}): {index.n_rows} rows, capacity "
             f"{index.capacity}")
    queries = unit_rows(np, 1 << 20, 20, dim)
    hits, search_ms = [], []
    for q in queries:
        t0 = time.perf_counter()
        hits.append(index.search(q, k))
        search_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(counted)
    if any(v <= 0 for n, v in launches.items() if n != contract.__name__) \
            or launches[contract.__name__]:
        fail(f"index ({dtype}): a serving kernel never launched or the "
             f"contract entry ran: {launches}")
    # above the fused entry's largest k the index takes the contract
    # entry and the stable sort; its first k hits are the fused ones
    wide = index.search(queries[0], 2 * kernels.FUSED_MAX_K)
    if contract.launches != 1 or wide[:k] != hits[0]:
        fail(f"index ({dtype}): the search at k = "
             f"{2 * kernels.FUSED_MAX_K} took {contract.launches} contract "
             f"launches or differs from the fused search")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9   # adds, growth, search

    # the fused search's device time beside its bound, on the index's own
    # table, and the contract entry + stable sort it replaced
    table, valid, scales = index._table, index._valid, index._scales
    n = table.shape[0]
    qd = torch.from_numpy(queries[0]).cuda()
    tables = (table, scales) if int8 else (table,)
    nbytes = n * dim + 4 * n if int8 else 2 * n * dim
    bound, by = bound_ms(nbytes + n + 4 * dim + 12 * k, 2.0 * n * dim)
    timing = {
        "search_device_ms": time_ms(torch, lambda: fused(
            *tables, qd, valid, k)),
        "search_bound_ms": bound, "search_bound_by": by,
        "search_device_ms_k1024": time_ms(torch, lambda: fused(
            *tables, qd, valid, kernels.FUSED_MAX_K)),
        "contract_sort_device_ms": time_ms(torch, lambda: topk_scores(
            contract(*tables, qd, valid), k)),
        "wide_search_k": 2 * kernels.FUSED_MAX_K,
        "wide_search_hits": len(wide)}

    # reference: the same (dequantized) table in f32 against the query
    # as the tier sees it (rounded to bf16); only the sum order differs
    deq = table.float()
    if int8:
        deq *= scales[:, None]
    qs = torch.from_numpy(queries).cuda().to(torch.bfloat16).float()
    ref = (deq @ qs.T).masked_fill_(~valid[:, None], float("-inf")).T
    del deq
    ref_vals, ref_rows = (t.cpu().numpy() for t in torch.topk(ref, 11))
    del ref
    swapped = 0
    for i, got in enumerate(hits):
        for j in range(10):
            vid, _, frame = DeviceLibraryIndex._locate(
                int(ref_rows[i, j]), index._starts, index._spans)
            if not abs(got[j]["confidence"] - ref_vals[i, j]) <= 1e-4:
                fail(f"index ({dtype}): confidence {got[j]['confidence']} "
                     f"vs reference {ref_vals[i, j]}")
            if (got[j]["video_id"], got[j]["frame_index"]) != (vid, frame):
                gap = min(abs(ref_vals[i, j] - ref_vals[i, j + d])
                          for d in (-1, 1) if 0 <= j + d <= 10)
                if gap > 1e-4:
                    fail(f"index ({dtype}): hit {j} of query {i} is "
                         f"{got[j]['video_id']}:{got[j]['frame_index']}, "
                         f"reference {vid}:{frame}")
                swapped += 1
    out = {"rows": index.n_rows, "capacity": index.capacity,
           "add_p50_ms": statistics.median(add_ms),
           "growths": len(growth_s), "growth_total_s": sum(growth_s),
           "search_p50_ms": statistics.median(search_ms),
           "near_tie_swaps": swapped, "launches": launches, **timing,
           "peak_gb": peak_gb}
    del index, table, valid, scales, tables
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not (ROOT / "avede_tpu_torch" / "__init__.py").exists():
        fail("avede_tpu_torch/ not found beside chip_smoke.py; run from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    import numpy as np

    card = card_line()
    print(card, flush=True)

    from avede_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    print(json.dumps({"build_s": time.perf_counter() - t0,
                      "kernels": sorted(built)}), flush=True)

    print(json.dumps({"decode_capabilities": decode_capabilities()}),
          flush=True)
    video = SyntheticVideo(np, seed=0)
    rows = check_kernels(torch, np, video)
    print(json.dumps({"kernel_checks": [
        {k: r.get(k) for k in ("name", "ms", "plain_ms", "bound_ms",
                               "library_ms", "max_abs_err")}
        for r in rows]}), flush=True)

    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.utils.config import settings

    t_script = time.perf_counter()

    def phase(name, fn, *args):
        """Run one phase → its report, printed at once with its wall (a
        later phase's failure keeps the earlier reports)."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(json.dumps({"card": card, name: out,
                          "phase_s": time.perf_counter() - t0}), flush=True)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        for attr in ("DATA_DIR", "VIDEO_DIR", "CLIP_DIR", "FRAME_DIR",
                     "EMBEDDING_DIR", "IMAGE_DIR", "LOG_DIR"):
            setattr(settings, attr, str(Path(tmp) / attr.lower()))
        engine = ClipEngine(device="cuda", seed=0)   # ViT-B/32, bf16
        reference = check_against_cpu(torch, np, engine, video)
        print(json.dumps({"card": card, "reference": reference}),
              flush=True)
        main_path = phase("main_path", drive_main_path, torch, np, engine,
                          video, Path(tmp) / "embeddings")
        library = phase("library", drive_library, torch, np, engine,
                        Path(tmp))
        # phase 8 runs while the CLIP engine is loaded; phase 7 after it,
        # with the card's memory free again for its peak
        rerank = phase("rerank", drive_rerank, torch, np, engine, video,
                       Path(tmp) / "rerank")
        gc.collect()
        torch.cuda.empty_cache()
        # phase 12 after phase 8, with BLIP-base freed
        blip2 = phase("blip2", drive_blip2, torch, np, engine, video,
                      Path(tmp) / "blip2")
        gc.collect()
        det, detection = drive_detection(torch, np, engine, video)
        print(json.dumps({"card": card, "detection": detection}),
              flush=True)
        small = phase("small_objects", drive_small_objects, torch, np,
                      engine, det)
        del det
        gc.collect()
        image_query = phase("image_query", drive_image_query, torch, np,
                            engine, Path(tmp))
        gc.collect()
        person = phase("person_search", drive_person_search, torch, np,
                       engine, Path(tmp))
        gc.collect()
        train = phase("train", drive_train, torch, np, engine, video,
                      Path(tmp))
        convert = phase("convert", drive_convert, torch, np, video,
                        Path(tmp))
        evals = phase("eval", drive_eval, torch, np, Path(tmp))
        eval_det = phase("eval_detection", drive_eval_detection, torch, np)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    index = {dtype: drive_index(torch, np, dtype)
             for dtype in ("bfloat16", "int8")}
    print(json.dumps({"card": card, "index": index}), flush=True)

    # each kernel's launches on every path, each path's counts zeroed
    # just before it ran; ``launches`` is the count on the row's own path
    paths = {"mvp": main_path["launches"],
             **{m: rerank["launches"][m] for m in ("reranked", "advanced")},
             "unlimited_detection": detection["launches"],
             "small_object": small["launches"],
             "image_query": image_query["launches"],
             "reranked_blip2": blip2["launches"]["cold"],
             "person_search": person["launches"],
             "train_serve": train["train_serve"]["launches"],
             "convert_serve": convert["launches"],
             "eval": evals["launches"],
             "eval_detection": eval_det["launches"],
             **{f"library_{d}": r["launches"] for d, r in library.items()},
             **{f"index_{d}": r["launches"] for d, r in index.items()}}
    for row in rows:
        row["path"] = KERNEL_PATH.get(row["name"], "mvp")
        key = row["launch_key"] = LAUNCH_KEY.get(row["name"], row["name"])
        row["launches"] = paths[row["path"]][key]
        row["launches_by_path"] = {p: c.get(key, 0)
                                   for p, c in paths.items()}
    print(json.dumps({"script_s_after_build": time.perf_counter()
                      - t_script}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
