"""Hand-written CUDA kernels against their plain PyTorch versions, on
the card (marked ``gpu``; each test skips without CUDA).

This file imports no JAX, so it also runs on a machine without it:
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q``.
"""

import numpy as np
import pytest
import torch

from avede_tpu_torch.ops import attention as tattn
from avede_tpu_torch.ops import kernels as tk
from avede_tpu_torch.ops import quant as tq

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_patch_embed_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (5, 224, 224, 3), dtype=np.uint8)
    x = torch.from_numpy(frames).to(cuda)
    if dtype == "float32":
        x = x.float() + torch.rand(x.shape, device=cuda)
    kernel = torch.from_numpy(
        rng.normal(0, 0.02, (32, 32, 3, 768)).astype(np.float32))
    w2, b2 = (t.to(cuda) for t in tk.fold_for_uint8(kernel))
    before = tk.fused_patch_embed.launches
    got = tk.fused_patch_embed(x, w2, b2, 32)
    torch.cuda.synchronize()
    assert tk.fused_patch_embed.launches == before + 1
    ref = tk.fused_patch_embed_plain(x, w2, b2, 32)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("L", [50, 70, 130])
def test_flash_kernel_matches_plain(cuda, L):
    g = torch.Generator(device="cuda").manual_seed(L)
    q, k, v = (torch.randn(4, 12, L, 64, device=cuda, generator=g)
               for _ in range(3))
    before = tattn.flash_attention.launches
    got = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    torch.testing.assert_close(got, tattn.attention_reference(q, k, v),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [17, 50, 65, 130, 257, 577])
@pytest.mark.parametrize("D", list(tattn._HEAD_DIMS))
def test_flash_f32_kernel_at_every_head_dim(cuda, D, L):
    """The f32 entry (3xTF32 tensor cores) at each instantiated head dim,
    against f32 softmax attention: within 1e-4 of the reference's largest
    value plus 1e-5. L = 65 and 257 leave one key in the last tile, which
    a wrong P.V permutation of the keys would get wrong."""
    g = torch.Generator(device="cuda").manual_seed(D * 1000 + L)
    q, k, v = (torch.randn(2, 3, L, D, device=cuda, generator=g)
               for _ in range(3))
    before = tattn.flash_attention.launches
    got = tattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    ref = tattn.attention_reference(q, k, v)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item() + 1e-5, err


def test_flash_f32_refuses_other_head_dims(cuda):
    for d in (8, 40, 128):
        q = torch.zeros(1, 2, 4, d, device=cuda)
        with pytest.raises(ValueError, match="head dim"):
            tattn.flash_attention(q, q, q)


def test_f32_tiny_clip_tower_with_flash_on_card_matches_cpu(cuda):
    """An f32 model with ``use_flash`` on the card: every vision layer
    launches the f32 entry, and the tower agrees with the CPU's f32 plain
    path on the same weights."""
    import dataclasses

    from avede_tpu_torch.models.clip import init_clip, tiny_test_config

    cfg = dataclasses.replace(tiny_test_config(), use_flash=True)
    cpu = init_clip(cfg, seed=0).eval()
    card = init_clip(cfg, seed=0).to(cuda).eval()
    pixels = torch.from_numpy(np.random.default_rng(5).normal(
        size=(6, 32, 32, 3)).astype(np.float32))
    before = (tattn.flash_attention.launches,
              tattn.flash_attention_blhd.launches_by_length.total())
    with torch.inference_mode():
        got = card.encode_image(pixels.to(cuda))
        torch.cuda.synchronize()
        ref = cpu.encode_image(pixels)
    assert (tattn.flash_attention.launches,
            tattn.flash_attention_blhd.launches_by_length.total()) \
        == (before[0] + cfg.vision_depth, before[1])
    err = (got.cpu() - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item() + 1e-5, err


def _within_bf16_ulp(got, ref, rel=0.0):
    """bf16 ``got`` against the f32 ``ref`` rounded to bf16: every element
    within one bf16 ulp of it plus ``rel · max|ref| + 1e-5`` (the f32
    kernel's own bar where its sums carry more than rounding)."""
    want = ref.to(torch.bfloat16).float()
    _, exp = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    err = (got.float() - want).abs()
    tol = ulp + rel * ref.abs().max() + 1e-5
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("L", [50, 70, 130])
def test_flash_blhd_kernel_matches_plain(cuda, L):
    g = torch.Generator(device="cuda").manual_seed(L)
    q, k, v = (torch.randn(4, L, 12, 64, device=cuda, generator=g
                           ).to(torch.bfloat16) for _ in range(3))
    before = tattn.flash_attention_blhd.launches_by_length.total()
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length.total() \
        == before + 1
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("L", [577, 65, 1])
def test_flash_blhd_kernel_reads_fused_qkv_in_place(cuda, L):
    """BLIP's layout: q, k, v are the thirds of one [B, L, 3·H·64]
    projection, read at a row stride of 3·H·64 (L = 577: ten key
    tiles, the last holding one key)."""
    g = torch.Generator(device="cuda").manual_seed(L)
    qkv = torch.randn(3, L, 3 * 12 * 64, device=cuda, generator=g
                      ).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (12, 64)) for t in qkv.chunk(3, dim=-1))
    before = tattn.flash_attention_blhd.launches_by_length[L]
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[L] == before + 1
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)
    with pytest.raises(ValueError, match="strides"):
        tattn.flash_attention_blhd(q, k.contiguous(), v)


@pytest.mark.parametrize("bsz,L", [(30, 257), (2, 65), (3, 1), (1, 130)])
def test_flash_blhd_kernel_at_head_dim_88(cuda, bsz, L):
    """BLIP-2's ViT-g: hd = 88 (1408 = 16 × 88), q, k, v the thirds of one
    fused [B, L, 3·1408] projection read at a row stride of 4224; the
    head is padded to 96 columns only in shared memory."""
    g = torch.Generator(device="cuda").manual_seed(88 + L)
    qkv = torch.randn(bsz, L, 3 * 16 * 88, device=cuda, generator=g
                      ).to(torch.bfloat16)
    q, k, v = (t.unflatten(-1, (16, 88)) for t in qkv.chunk(3, dim=-1))
    before = tattn.flash_attention_blhd.launches_by_length[L]
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[L] == before + 1
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)
    # contiguous heads (row stride 1408) give the same answer
    again = tattn.flash_attention_blhd(*(t.contiguous() for t in (q, k, v)))
    assert torch.equal(again, got)


def _blhd_inputs(cuda, bsz, length, heads, hd, fused, seed):
    """bf16 q, k, v [bsz, length, heads, hd]: the thirds of one fused
    qkv output (row stride 3·heads·hd) or three contiguous projections."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        qkv = torch.randn(bsz, length, 3 * heads * hd, device=cuda,
                          generator=g).to(torch.bfloat16)
        return [t.unflatten(-1, (heads, hd)) for t in qkv.chunk(3, dim=-1)]
    return [torch.randn(bsz, length, heads * hd, device=cuda, generator=g
                        ).to(torch.bfloat16).view(bsz, length, heads, hd)
            for _ in range(3)]


@pytest.mark.parametrize("fused", [False, True], ids=["heads", "fused_qkv"])
@pytest.mark.parametrize("hd", [64, 88])
@pytest.mark.parametrize("L", [65, 128, 129, 257, 577, 1025])
def test_flash_wgmma_kernel_matches_plain(cuda, L, hd, fused):
    """The wgmma kernel at partial and whole 128-row tiles (L = 65: one
    partial q and K/V tile; 128: one whole; 129 and 257: one row and key
    past them; 577: 65 past four; 1025), both head dims, both layouts:
    one bf16 ulp + 1e-5 of the f32 plain version, one wgmma launch."""
    heads = 12 if hd == 64 else 16
    q, k, v = _blhd_inputs(cuda, 2, L, heads, hd, fused, L * hd)
    counts = tattn.flash_attention_blhd.launches_by_kernel
    before = (counts["wgmma"], counts["mma"])
    got = tattn.flash_attention_blhd_on("wgmma", q, k, v)
    torch.cuda.synchronize()
    assert (counts["wgmma"], counts["mma"]) == (before[0] + 1, before[1])
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("bsz,heads,L,hd", [
    (1, 1, 577, 64),     # B·H = 1: 5 items on a grid of 5 blocks
    (1, 1, 257, 88),
    (7, 19, 257, 64),    # 133 pairs x 3 q tiles: not a multiple of 132
    (5, 27, 193, 88),    # 135 pairs x 2 q tiles
])
def test_flash_wgmma_kernel_any_pair_count(cuda, bsz, heads, L, hd):
    q, k, v = _blhd_inputs(cuda, bsz, L, heads, hd, False, bsz * heads)
    got = tattn.flash_attention_blhd_on("wgmma", q, k, v)
    torch.cuda.synchronize()
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("L,hd,kernel", [
    (577, 64, "wgmma"), (257, 88, "wgmma"), (50, 64, "mma"),
    (17, 16, "mma"), (577, 16, "mma")])
def test_flash_blhd_routes_by_length_and_head_dim(cuda, L, hd, kernel):
    """The entry counts each launch under the kernel ``blhd_kernel``
    names, and that kernel's answer is the entry's."""
    assert tattn.blhd_kernel(L, hd) == kernel
    q, k, v = _blhd_inputs(cuda, 2, L, 4, hd, True, L + hd)
    counts = tattn.flash_attention_blhd.launches_by_kernel
    before = dict(counts)
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert counts[kernel] == before.get(kernel, 0) + 1
    assert sum(counts.values()) == sum(before.values()) + 1
    assert torch.equal(got, tattn.flash_attention_blhd_on(kernel, q, k, v))


def test_flash_wgmma_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 577, 4, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_attention_blhd_on("wgmma", q, q, q)


def test_flash_blhd_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 4, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_attention_blhd(q, q, q)


def test_blip_vision_layer_launches_flash(cuda):
    from avede_tpu_torch.models.blip import BlipVisionLayer, blip_base

    layer = BlipVisionLayer(blip_base()).to(cuda, torch.bfloat16)
    x = torch.randn(2, 577, 768, device=cuda, dtype=torch.bfloat16)
    before = tattn.flash_attention_blhd.launches_by_length[577]
    with torch.inference_mode():
        got = layer(x)
        ref = layer.float().cpu()(x.float().cpu())
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[577] == before + 1
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), ref, -1)
    assert float(cos.min()) >= 0.99


def test_blip2_vision_layer_launches_flash_at_hd88(cuda):
    """One ViT-g layer of BLIP-2 (1408 wide, 16 heads of 88, 257 tokens)
    in bf16 on the card: one flash launch at L = 257, against the CPU's
    f32 layer (row cosine >= 0.99)."""
    from avede_tpu_torch.models.blip import BlipVisionLayer
    from avede_tpu_torch.models.qformer import QFormerConfig

    layer = BlipVisionLayer(QFormerConfig().vision_cfg).to(cuda,
                                                           torch.bfloat16)
    x = torch.randn(2, 257, 1408, device=cuda, dtype=torch.bfloat16)
    before = tattn.flash_attention_blhd.launches_by_length[257]
    with torch.inference_mode():
        got = layer(x)
        ref = layer.float().cpu()(x.float().cpu())
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[257] == before + 1
    cos = torch.nn.functional.cosine_similarity(got.float().cpu(), ref, -1)
    assert float(cos.min()) >= 0.99


@pytest.mark.parametrize("face", [False, True], ids=["default", "face"])
def test_appearance_encoder_on_card_matches_cpu(cuda, face):
    """The person-search encoders in f32 on the card (TF32 off here)
    against the CPU on the same weights."""
    from avede_tpu_torch.models.appearance import (AppearanceEmbedder,
                                                   face_embed_config)

    cfg = face_embed_config() if face else None
    cpu = AppearanceEmbedder(cfg, seed=3, device="cpu")
    card = AppearanceEmbedder(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(0)
    crops = [rng.integers(0, 255, (int(h), int(w), 3), dtype=np.uint8)
             for h, w in rng.integers(6, 120, (33, 2))]
    got, ref = card.embed(crops), cpu.embed(crops)
    assert got.shape == ref.shape == (33, cpu.cfg.embed_dim)
    assert np.abs(got - ref).max() <= 1e-5


def test_flash_blhd_kernel_at_owlvit_shape(cuda):
    """OWL-ViT B/32's vision attention: a 16-frame batch of 577 tokens,
    q, k, v each a projection's own [B, L, 768] output viewed per head
    (contiguous heads, row stride 768)."""
    g = torch.Generator(device="cuda").manual_seed(577)
    q, k, v = (torch.randn(16, 577, 768, device=cuda, generator=g
                           ).to(torch.bfloat16).view(16, 577, 12, 64)
               for _ in range(3))
    before = tattn.flash_attention_blhd.launches_by_length[577]
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[577] == before + 1
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)


@pytest.mark.parametrize("bsz", [1024, 256, 16, 4, 1])
def test_flash_blhd_kernel_at_clip_detection_shapes(cuda, bsz):
    """CLIP's vision attention on the detection and image-query paths:
    the 8 × 8 grid of a 16-frame batch (1024 cells) and buckets of
    ``embed_pixels`` (crops; 1 is a reference image alone), 50 tokens
    each, contiguous heads."""
    g = torch.Generator(device="cuda").manual_seed(bsz)
    q, k, v = (torch.randn(bsz, 50, 768, device=cuda, generator=g
                           ).to(torch.bfloat16).view(bsz, 50, 12, 64)
               for _ in range(3))
    before = tattn.flash_attention_blhd.launches_by_length[50]
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[50] == before + 1
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)


def test_owlvit_tower_launches_flash_per_layer(cuda):
    """OWL-ViT B/32 on the card (bf16, depth 2): one flash launch at
    L = 577 per vision layer, logits and boxes against the CPU's f32
    plain path on the same weights (row cosine >= 0.99). In f32 its flash
    layers take the f32 entry, one launch a layer, and agree with the
    CPU's f32 path (row cosine >= 0.9999); with autograd recording they
    refuse, as every kernel wrapper does."""
    import dataclasses

    from avede_tpu_torch.models.owlvit import (init_owlvit,
                                               owlvit_base_patch32)

    cfg = dataclasses.replace(owlvit_base_patch32(), vision_depth=2,
                              text_depth=2, use_flash=True)
    cpu = init_owlvit(cfg, seed=0).eval()
    card = init_owlvit(dataclasses.replace(cfg, dtype="bfloat16"), seed=0
                       ).to(cuda, torch.bfloat16).eval()
    px = torch.randn(2, 768, 768, 3, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[1, 5, 9, 49407] + [0] * 12,
                        [1, 7, 49407] + [0] * 13])
    before = tattn.flash_attention_blhd.launches_by_length[577]
    with torch.inference_mode():
        logits, boxes = card(px.to(cuda), ids.to(cuda))
        ref_logits, ref_boxes = cpu(px, ids)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[577] == before + 2
    for got, ref in ((logits, ref_logits), (boxes, ref_boxes)):
        cos = torch.nn.functional.cosine_similarity(
            got.float().cpu().flatten(1), ref.flatten(1), -1)
        assert float(cos.min()) >= 0.99
    f32 = init_owlvit(cfg, seed=0).to(cuda).eval()
    before = tattn.flash_attention.launches_by_dim[64]
    with torch.inference_mode():
        logits, boxes = f32(px.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches_by_dim[64] == before + 2
    for got, ref in ((logits, ref_logits), (boxes, ref_boxes)):
        cos = torch.nn.functional.cosine_similarity(
            got.cpu().flatten(1), ref.flatten(1), -1)
        assert float(cos.min()) >= 0.9999
    with pytest.raises(RuntimeError, match="no backward"):
        f32(px[:1].to(cuda), ids[:1].to(cuda))


def test_yolo_forward_on_card_matches_cpu(cuda):
    """YOLOv8n at 640 px in bf16 on the card (``F.conv2d``) against the
    CPU's f32 forward on the same weights."""
    from avede_tpu_torch.models.yolo import init_yolo, yolov8n

    cpu = init_yolo(yolov8n(), seed=0).eval()
    card = init_yolo(yolov8n(), seed=0).to(cuda, torch.bfloat16).eval()
    x = torch.rand(1, 640, 640, 3, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got, ref = card(x.to(cuda)), cpu(x)
    for (gb, gc), (rb, rc) in zip(got, ref):
        for a, b in ((gb, rb), (gc, rc)):
            cos = torch.nn.functional.cosine_similarity(
                a.cpu().flatten(), b.flatten(), 0)
            assert float(cos) >= 0.99


def test_effnet_b0_on_card_matches_cpu(cuda):
    """EfficientNet-B0 (f32, cuDNN's TF32 off) through the extractor on
    the card against its CPU run on the same seeded weights and crops."""
    from avede_tpu_torch.services.background_independent import \
        EffNetExtractor

    rng = np.random.default_rng(0)
    crops = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
             for h, w in ((224, 224), (90, 150), (40, 33))]
    got = EffNetExtractor(device="cuda").embed_crops(crops)
    ref = EffNetExtractor(device="cpu").embed_crops(crops)
    assert got.shape == ref.shape == (3, 1280)
    assert np.abs(got - ref).max() <= 1e-4
    # random weights leave the features far below 1 before the norm's
    # 1e-9 guard, so the rows are not unit: compare directions
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                * np.linalg.norm(ref, axis=1))
    assert float(cos.min()) >= 0.99999


def test_detect_in_frame_launches_flash_at_l50(cuda):
    """``SmallObjectService.detect_in_frame`` on a 1080p frame in the
    route's default ``clip`` mode: 8 tiles of 640 px at overlap 128, all
    CLIP grid cells (8 × 64) in one tower call, so one flash launch at
    L = 50 per vision layer and none at L = 577."""
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.services.small_object import SmallObjectService
    from avede_tpu_torch.services.universal_detector import \
        UniversalDetector

    engine = ClipEngine(device="cuda", seed=0)
    so = SmallObjectService(engine, detector=UniversalDetector(engine))
    frame = np.random.default_rng(0).integers(0, 255, (1080, 1920, 3),
                                              dtype=np.uint8)
    frame[500:532, 900:932] = (220, 30, 30)
    by_len = tattn.flash_attention_blhd.launches_by_length
    l50, l577 = by_len[50], by_len[577]
    dets = so.detect_in_frame(frame, ["a red square"], conf_threshold=-1.0,
                              enable_adaptive_thresholds=False)
    torch.cuda.synchronize()
    assert by_len[50] - l50 == engine.cfg.vision_depth
    assert by_len[577] == l577
    assert dets and all(np.isfinite(d["confidence"]) for d in dets)
    for d in dets:
        x0, y0, x1, y1 = d["bbox"]
        assert 0 <= x0 < x1 <= 1920 and 0 <= y0 < y1 <= 1080


def test_batching_executor_on_card(cuda):
    """Eight threads embed their crops at once through the engine's
    batching executor on the card: fewer tower calls than requests, and
    each thread's rows equal a direct ``embed_pixels`` of its crops
    within bf16 rounding (row cosine >= 0.999)."""
    import threading

    from avede_tpu_torch.ops.preprocess import clip_preprocess
    from avede_tpu_torch.parallel.embed import ClipEngine

    engine = ClipEngine(device="cuda", seed=0)
    rng = np.random.default_rng(0)
    crops = [[rng.integers(0, 255, (int(h), int(w), 3), dtype=np.uint8)
              for h, w in rng.integers(16, 300, (int(n), 2))]
             for n in rng.integers(3, 21, 8)]
    out, start = [None] * 8, threading.Barrier(8)

    def work(i):
        start.wait()
        out[i] = engine.embed_images(crops[i])

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    stats = engine._batcher.stats
    assert stats["requests"] == 8 and stats["batches"] < 8
    for got, c in zip(out, crops):
        px = torch.cat([clip_preprocess(torch.from_numpy(x[None]).cuda(),
                                        size=224) for x in c])
        ref = engine.embed_pixels(px)
        cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                    * np.linalg.norm(ref, axis=1))
        assert got.shape == ref.shape and float(cos.min()) >= 0.999


def test_attention_layer_launches_bf16_entry_only(cuda):
    from avede_tpu_torch.models.layers import MultiHeadAttention

    layer = MultiHeadAttention(768, 12, use_flash=True).to(
        cuda, torch.bfloat16)
    x = torch.randn(8, 50, 768, device=cuda, dtype=torch.bfloat16)
    counts = tattn.flash_attention_blhd.launches_by_length
    before = (counts.total(), tattn.flash_attention.launches)
    with torch.inference_mode():
        layer(x)
    torch.cuda.synchronize()
    assert (counts.total(), tattn.flash_attention.launches) \
        == (before[0] + 1, before[1])


def test_patch_embed_i420_kernel_matches_plain(cuda):
    rng = np.random.default_rng(1)
    packed = torch.from_numpy(
        rng.integers(0, 256, (5, 336, 224), dtype=np.uint8)).to(cuda)
    kernel = torch.from_numpy(
        rng.normal(0, 0.02, (32, 32, 3, 768)).astype(np.float32))
    w2, b2 = (t.to(cuda) for t in tk.fold_for_uint8(kernel))
    split = tk.split_patch_weights(w2, 32)
    before = tk.fused_patch_embed_i420.launches
    got = tk.fused_patch_embed_i420(packed, w2, b2, 32, split)
    torch.cuda.synchronize()
    assert tk.fused_patch_embed_i420.launches == before + 1
    _within_bf16_ulp(got, tk.fused_patch_embed_i420_plain(
        packed, w2, b2, 32, torch.float32), rel=1e-4)



@pytest.mark.parametrize("bsz,L,fused", [(64, 17, False), (16, 17, True),
                                         (3, 1, False), (2, 65, True),
                                         (5, 130, False)])
def test_flash_blhd_kernel_at_head_dim_16(cuda, bsz, L, fused):
    """The tiny 32 px towers (CLIP, BLIP, OWL-ViT: 4 heads of 16, L = 17,
    one key tile with 47 masked rows): hd = 16, 32-byte rows in shared
    memory; contiguous heads (row stride 64) or the thirds of a fused
    qkv (row stride 192)."""
    g = torch.Generator(device="cuda").manual_seed(16 + L)
    if fused:
        qkv = torch.randn(bsz, L, 3 * 64, device=cuda, generator=g
                          ).to(torch.bfloat16)
        q, k, v = (t.unflatten(-1, (4, 16)) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(bsz, L, 64, device=cuda, generator=g
                               ).to(torch.bfloat16).view(bsz, L, 4, 16)
                   for _ in range(3))
    before = tattn.flash_attention_blhd.launches_by_length[L]
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[L] == before + 1
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)


def test_tiny_clip_tower_on_card_matches_cpu(cuda):
    """The tiny CLIP (32 px, patch 8, width 64, 4 heads of 16) served in
    bf16 on the card: the I420 patch embed's mma.sync kernel and flash at
    hd = 16, against the CPU's f32 plain path on the same weights."""
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.embed import ClipEngine
    from avede_tpu_torch.utils.platform import with_compute_dtype

    frames = np.random.default_rng(3).integers(0, 256, (8, 40, 48, 3),
                                               dtype=np.uint8)
    card = ClipEngine(cfg=with_compute_dtype(tiny_test_config(), cuda),
                      device=cuda, seed=0)
    cpu = ClipEngine(cfg=tiny_test_config(), device="cpu", seed=0)
    counts = (tk.fused_patch_embed_i420.launches_by_kernel["mma"],
              tattn.flash_attention_blhd.launches_by_length[17])
    got = card.embed_frames(frames)
    assert tk.fused_patch_embed_i420.launches_by_kernel["mma"] \
        == counts[0] + 1
    assert tattn.flash_attention_blhd.launches_by_length[17] \
        == counts[1] + tiny_test_config().vision_depth
    ref = cpu.embed_frames(frames)
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1)
                                * np.linalg.norm(ref, axis=1))
    assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("entry", ["i420", "uint8", "float32"])
@pytest.mark.parametrize("n,s,p,d", [(64, 32, 8, 64), (3, 64, 16, 100),
                                     (2, 28, 7, 70), (1, 224, 32, 64),
                                     (2, 56, 14, 100), (5, 36, 6, 33)])
def test_patch_embed_any_shape_kernel_matches_plain(cuda, entry, n, s, p, d):
    """Shapes the wgmma tile does not take (P != 32 or D % 96 != 0) run
    the mma.sync kernel on the same split bf16 operands: the tiny CLIP's
    [N, 48, 32] I420 -> [N, 16, 64] at P = 8, an odd P, a ragged D, K in
    several chunks (P = 16, 32 and 14: BLIP-2's patch), and 3P^2 not a
    multiple of 16 (P = 7: 147, P = 14: 588, P = 6: 108; the weights by
    2-byte loads where P % 4 != 0)."""
    rng = np.random.default_rng(p * d)
    kernel = torch.from_numpy(
        rng.normal(0, 0.05, (p, p, 3, d)).astype(np.float32))
    w2, b2 = (t.to(cuda) for t in tk.fold_for_uint8(kernel))
    split = tk.split_patch_weights(w2, p)
    before = (tk.fused_patch_embed_i420.launches_by_kernel["mma"],
              tk.fused_patch_embed.launches_by_kernel["mma"])
    if entry == "i420":
        packed = torch.from_numpy(rng.integers(
            0, 256, (n, s * 3 // 2, s), dtype=np.uint8)).to(cuda)
        got = tk.fused_patch_embed_i420(packed, w2, b2, p, split)
        torch.cuda.synchronize()
        assert tk.fused_patch_embed_i420.launches_by_kernel["mma"] \
            == before[0] + 1
        _within_bf16_ulp(got, tk.fused_patch_embed_i420_plain(
            packed, w2, b2, p, torch.float32), rel=1e-4)
        return
    x = torch.from_numpy(rng.integers(0, 256, (n, s, s, 3),
                                      dtype=np.uint8)).to(cuda)
    if entry == "float32":
        x = x.float() + torch.rand(x.shape, device=cuda)
    got = tk.fused_patch_embed(x, w2, b2, p, split)
    torch.cuda.synchronize()
    assert tk.fused_patch_embed.launches_by_kernel["mma"] == before[1] + 1
    ref = tk.fused_patch_embed_plain(x, w2, b2, p)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item() + 1e-5, err


def test_patch_embed_refuses_what_it_cannot_take(cuda):
    """A P that does not divide S, or weights not split to bf16, raise on
    the card; nothing runs the plain version there."""
    w2 = torch.zeros(192, 64, device=cuda)
    b2 = torch.zeros(64, device=cuda)
    before = tk.fused_patch_embed_i420.launches
    with pytest.raises(ValueError, match="bad shapes"):
        tk.fused_patch_embed_i420(
            torch.zeros(1, 54, 36, dtype=torch.uint8, device=cuda), w2, b2,
            8)
    with pytest.raises(ValueError, match="split weights"):
        tk.fused_patch_embed_i420(
            torch.zeros(1, 48, 32, dtype=torch.uint8, device=cuda), w2, b2,
            8, split=(w2.T.contiguous(), w2.T.contiguous()))
    assert tk.fused_patch_embed_i420.launches == before

@pytest.mark.parametrize("nq", [1, 4])
def test_cosine_kernel_matches_plain(cuda, nq):
    g = torch.Generator(device="cuda").manual_seed(nq)
    emb = torch.nn.functional.normalize(
        torch.randn(1024, 512, device=cuda, generator=g), dim=-1)
    q = torch.nn.functional.normalize(
        torch.randn(nq, 512, device=cuda, generator=g), dim=-1)
    valid = torch.arange(1024, device=cuda) < 600
    got = tk.cosine_scores(emb, q, valid)
    torch.cuda.synchronize()
    ref = tk.cosine_scores_plain(emb, q, valid)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(768, 512), (257, 512), (33, 100)])
def test_quantize_rows_kernel_equals_plain(cuda, shape):
    """Exact: the register path (D % 128 == 0) and the loop path."""
    g = torch.Generator(device="cuda").manual_seed(shape[0])
    x = torch.randn(*shape, device=cuda, generator=g)
    x[3] = 0.0                                  # a removal's zero row
    x[5, :4] = torch.tensor([127.0, 2.5, -3.5, 0.5], device=cuda)
    before = tq.quantize_rows.launches
    q, s = tq.quantize_rows(x)
    torch.cuda.synchronize()
    assert tq.quantize_rows.launches == before + 1
    pq, ps = tq.quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    assert s[3].item() == np.float32(1e-12) and not q[3].any()
    out = (torch.zeros(shape[0] + 8, shape[1], dtype=torch.int8,
                       device=cuda), torch.zeros(shape[0] + 8, device=cuda))
    tq.quantize_rows(x, out=(out[0][8:], out[1][8:]))
    assert torch.equal(out[0][8:], pq) and torch.equal(out[1][8:], ps)


@pytest.mark.parametrize("shape,n_valid", [
    ((768, 512), 700), ((768, 512), 0), ((768, 512), 768), ((256, 1024), 3),
    ((33, 100), 20), ((5, 130), 5), ((1000, 768), 999)])
def test_quantize_rows_into_equals_plain(cuda, shape, n_valid):
    """The int8 index's add write, exact: q, scales and the mask, into row
    slices of a larger table (the register path and the loop path)."""
    g = torch.Generator(device="cuda").manual_seed(shape[0] + n_valid)
    x = torch.randn(*shape, device=cuda, generator=g) * 0.05
    x[1] = 0.0
    rows = shape[0]
    q = torch.full((rows + 16, shape[1]), 7, dtype=torch.int8, device=cuda)
    s = torch.full((rows + 16,), 3.0, device=cuda)
    v = torch.ones(rows + 16, dtype=torch.bool, device=cuda)
    before = tq.quantize_rows_into.launches
    tq.quantize_rows_into(x, q[8:8 + rows], s[8:8 + rows], v[8:8 + rows],
                          n_valid)
    torch.cuda.synchronize()
    assert tq.quantize_rows_into.launches == before + 1
    pq, ps = tq.quantize_rows_plain(x)
    assert torch.equal(q[8:8 + rows], pq) and torch.equal(s[8:8 + rows], ps)
    assert torch.equal(v[8:8 + rows].cpu(), torch.arange(rows) < n_valid)
    # the rows around the slice are untouched
    assert (q[:8] == 7).all() and (q[8 + rows:] == 7).all()
    assert (s[:8] == 3.0).all() and v[:8].all() and v[8 + rows:].all()


@pytest.mark.parametrize("n,d,nq,offset", [
    (1024, 512, 1, 0), (1000, 768, 1, 0), (333, 1024, 1, 0),
    (4097, 128, 1, 0), (1024, 512, 1, 1), (500, 100, 1, 0),
    (700, 512, 3, 0), (100, 1152, 1, 0)])
def test_cosine_f32_scorer_matches_plain(cuda, n, d, nq, offset):
    """The f32 contract entry at every path of its dispatch (the fast
    kernel at 1-8 float4 chunks a lane, an unaligned table, an odd width,
    several queries, a width past the fast kernel) within the f32 bar,
    and the mvp entry bit-equal to it on the same rows."""
    from avede_tpu_torch.ops.similarity import topk_scores

    g = torch.Generator(device="cuda").manual_seed(n + d)
    base = torch.nn.functional.normalize(
        torch.randn(n * d + offset, device=cuda, generator=g)[offset:]
        .view(n, d), dim=-1)
    emb = torch.empty(n * d + offset, device=cuda)[offset:].view(n, d)
    emb.copy_(base)
    q = torch.nn.functional.normalize(
        torch.randn(nq, d, device=cuda, generator=g), dim=-1)
    valid = torch.rand(n, device=cuda, generator=g) < 0.9
    before = tk.cosine_scores.launches
    got = tk.cosine_scores(emb, q, valid)
    torch.cuda.synchronize()
    assert tk.cosine_scores.launches == before + 1
    torch.testing.assert_close(got, tk.cosine_scores_plain(emb, q, valid),
                               rtol=1e-4, atol=1e-5)
    mids = torch.randint(-1, n, (300,), device=cuda, generator=g,
                         dtype=torch.int32)
    _bit_equal(tk.cosine_window_topk(emb, valid, q, mids, 50),
               topk_scores(tk.window_scores(got, mids).T, 50))


@pytest.mark.parametrize("shape", [(3072, 768), (33, 130), (1, 40),
                                   (7, 33), (5001, 70)])
def test_quantize_per_channel_kernel_equals_plain(cuda, shape):
    """Exact, on clusters: K not a multiple of the cluster, K = 1, N not
    a multiple of the column group, K past the register slab."""
    g = torch.Generator(device="cuda").manual_seed(shape[1])
    w = torch.randn(*shape, device=cuda, generator=g) * 0.02
    w[:, 1] = 0.0
    before = tq.quantize_per_channel.launches
    q, s = tq.quantize_per_channel(w)
    torch.cuda.synchronize()
    assert tq.quantize_per_channel.launches == before + 1
    pq, ps = tq.quantize_per_channel_plain(w)
    assert torch.equal(q, pq) and torch.equal(s, ps)


def _table(cuda, n, d, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    emb = torch.nn.functional.normalize(
        torch.randn(n, d, device=cuda, generator=g), dim=-1)
    valid = torch.rand(n, device=cuda, generator=g) < 0.9
    return emb, valid, g


@pytest.mark.parametrize("n,d,nq", [(4096, 512, 1), (1000, 768, 1),
                                    (300, 100, 3)])
def test_cosine_bf16_kernel_matches_plain(cuda, n, d, nq):
    emb, valid, g = _table(cuda, n, d, n + d)
    q = torch.nn.functional.normalize(
        torch.randn(nq, d, device=cuda, generator=g), dim=-1)
    table = emb.to(torch.bfloat16)
    before = tk.cosine_scores_bf16.launches
    got = tk.cosine_scores_bf16(table, q, valid)
    torch.cuda.synchronize()
    assert tk.cosine_scores_bf16.launches == before + 1
    torch.testing.assert_close(
        got, tk.cosine_scores_bf16_plain(table, q, valid),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,d,nq", [(4096, 512, 1), (1000, 1024, 1),
                                    (300, 100, 3)])
def test_cosine_int8_kernel_matches_plain(cuda, n, d, nq):
    emb, valid, g = _table(cuda, n, d, n + d + 1)
    q = torch.nn.functional.normalize(
        torch.randn(nq, d, device=cuda, generator=g), dim=-1)
    table, scales = tq.quantize_rows(emb)
    before = tk.cosine_scores_int8.launches
    got = tk.cosine_scores_int8(table, scales, q, valid)
    torch.cuda.synchronize()
    assert tk.cosine_scores_int8.launches == before + 1
    torch.testing.assert_close(
        got, tk.cosine_scores_int8_plain(table, scales, q, valid),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_library_index_on_card_matches_cpu(cuda, dtype):
    """The same adds, removal and growth on the card and on the CPU:
    identical tables and hits; scores to 1e-5 (sum order)."""
    from avede_tpu_torch.services.library_index import DeviceLibraryIndex

    rng = np.random.default_rng(0)
    idx = {dev: DeviceLibraryIndex(512, dtype=dtype, device=dev)
           for dev in ("cuda", "cpu")}
    for i, n in enumerate((700, 300, 1200)):
        emb = rng.normal(size=(n, 512)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        for ix in idx.values():
            ix.add(f"v{i}", emb, np.arange(float(n)))
        if i == 1:
            for ix in idx.values():
                ix.remove("v0")
    assert torch.equal(idx["cuda"]._table.cpu(), idx["cpu"]._table)
    q = rng.normal(size=512).astype(np.float32)
    q /= np.linalg.norm(q)
    a, b = idx["cuda"].search(q, 20), idx["cpu"].search(q, 20)
    assert [(h["video_id"], h["frame_index"]) for h in a] \
        == [(h["video_id"], h["frame_index"]) for h in b]
    np.testing.assert_allclose([h["confidence"] for h in a],
                               [h["confidence"] for h in b], atol=1e-5)


def _bit_equal(got, ref):
    """(values, indices) pairs equal bit for bit (-0.0 is not +0.0)."""
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    assert torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
    assert torch.equal(got[1], ref[1])


def _window_case(cuda, nq, w, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    emb = torch.nn.functional.normalize(
        torch.randn(1024, 512, device=cuda, generator=g), dim=-1)
    emb[700:710] = emb[3]                       # exact ties
    valid = torch.arange(1024, device=cuda) < 900
    q = torch.nn.functional.normalize(
        torch.randn(nq, 512, device=cuda, generator=g), dim=-1)
    mids = torch.randint(-1, 1024, (w,), device=cuda, generator=g,
                         dtype=torch.int32)     # repeats: more ties
    return emb, valid, q, mids


@pytest.mark.parametrize("nq,w,k", [(1, 128, 10), (1, 128, 128),
                                    (4, 128, 5), (1, 5000, 1024),
                                    (4, 5000, 64), (1, 3, 1)])
def test_window_topk_fused_equals_contract(cuda, nq, w, k):
    """The mvp entry, bit for bit ``topk_scores`` of the contract entry's
    scores after the window gather; W = 5000 runs the running merge."""
    from avede_tpu_torch.ops.similarity import topk_scores

    emb, valid, q, mids = _window_case(cuda, nq, w, nq * w + k)
    before = tk.cosine_window_topk.launches
    got = tk.cosine_window_topk(emb, valid, q, mids, k)
    torch.cuda.synchronize()
    assert tk.cosine_window_topk.launches == before + 1
    ref = topk_scores(tk.window_scores(tk.cosine_scores(emb, q, valid),
                                       mids).T, k)
    _bit_equal(got, ref)


def _library_case(cuda, dtype, n, d, seed, ties):
    emb, valid, g = _table(cuda, n, d, seed)
    q = torch.nn.functional.normalize(
        torch.randn(d, device=cuda, generator=g), dim=-1)
    if ties == "dup":                  # 2000 equal rows on top: k lands in
        emb[1000:3000] = q             # the tie
    elif ties == "invalid":            # 132 valid rows: -inf ties past them
        valid[:] = False
        valid[::997] = True
    if dtype == "int8":
        table, scales = tq.quantize_rows(emb)
        return (table, scales), q, valid
    return (emb.to(getattr(torch, dtype)),), q, valid


_FUSED = {"float32": ("cosine_topk_f32", "cosine_scores"),
          "bfloat16": ("cosine_topk_bf16", "cosine_scores_bf16"),
          "int8": ("cosine_topk_int8", "cosine_scores_int8")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,d,k,ties", [
    (1 << 20, 512, 64, None), (1 << 20, 512, 1024, None),
    (1 << 17, 512, 1024, "dup"), (1 << 17, 512, 512, "invalid"),
    (3000, 100, 300, None), (1000, 512, 4096, None),
    (1 << 17, 512, 2048, None), (5000, 512, 1, None)])
def test_library_topk_fused_equals_contract(cuda, dtype, n, d, k, ties):
    """The library tiers' entries, bit for bit ``topk_scores`` of the
    contract entry: exact ties (duplicated rows), -inf ties past the
    valid rows, an odd width, k = 1, and k past FUSED_MAX_K (the
    contract entry plus the sort, by shape)."""
    from avede_tpu_torch.ops.similarity import topk_scores

    tables, q, valid = _library_case(cuda, dtype, n, d, n + d + k, ties)
    fused, contract = (getattr(tk, name) for name in _FUSED[dtype])
    before = (fused.launches, contract.launches)
    got = fused(*tables, q, valid, k)
    torch.cuda.synchronize()
    above = min(k, n) > tk.FUSED_MAX_K
    assert (fused.launches, contract.launches) == \
        (before[0] + (not above), before[1] + above)
    _bit_equal(got, topk_scores(contract(*tables, q, valid), k))


def _grad_cases(cuda):
    """Each kernel wrapper → (its launch counter, a call on valid card
    inputs, the float input a caller might train)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    kernel = torch.randn(32, 32, 3, 768, device=cuda, generator=g) * 0.02
    w2, b2 = tk.fold_for_uint8(kernel)
    frames = torch.randint(0, 255, (2, 224, 224, 3), device=cuda,
                           dtype=torch.uint8, generator=g)
    packed = torch.randint(0, 255, (2, 336, 224), device=cuda,
                           dtype=torch.uint8, generator=g)
    q32 = torch.randn(1, 2, 50, 64, device=cuda, generator=g)
    qbf = torch.randn(1, 50, 12, 64, device=cuda, generator=g
                      ).to(torch.bfloat16)
    emb = torch.nn.functional.normalize(
        torch.randn(256, 512, device=cuda, generator=g), dim=-1)
    query = torch.nn.functional.normalize(
        torch.randn(512, device=cuda, generator=g), dim=-1)
    table8, scales = tq.quantize_rows(emb)
    mids = torch.arange(0, 256, 4, device=cuda, dtype=torch.int32)
    blhd = tattn.flash_attention_blhd
    return {
        "fused_patch_embed": (
            lambda: tk.fused_patch_embed.launches, w2,
            lambda w: tk.fused_patch_embed(frames, w, b2, 32)),
        "fused_patch_embed_i420": (
            lambda: tk.fused_patch_embed_i420.launches, w2,
            lambda w: tk.fused_patch_embed_i420(packed, w, b2, 32)),
        "flash_attention": (
            lambda: tattn.flash_attention.launches, q32,
            lambda q: tattn.flash_attention(q, q32, q32)),
        "flash_attention_blhd": (
            lambda: blhd.launches_by_length.total(), qbf,
            lambda q: blhd(q, qbf, qbf)),
        "cosine_scores": (
            lambda: tk.cosine_scores.launches, query,
            lambda x: tk.cosine_scores(emb, x)),
        "cosine_scores_bf16": (
            lambda: tk.cosine_scores_bf16.launches, query,
            lambda x: tk.cosine_scores_bf16(emb.to(torch.bfloat16), x)),
        "cosine_scores_int8": (
            lambda: tk.cosine_scores_int8.launches, query,
            lambda x: tk.cosine_scores_int8(table8, scales, x)),
        "cosine_window_topk": (
            lambda: tk.cosine_window_topk.launches, emb,
            lambda e: tk.cosine_window_topk(e, None, query, mids, 10)),
        "cosine_topk_f32": (
            lambda: tk.cosine_topk_f32.launches, emb,
            lambda e: tk.cosine_topk_f32(e, query, None, 10)),
        "cosine_topk_bf16": (
            lambda: tk.cosine_topk_bf16.launches, query,
            lambda x: tk.cosine_topk_bf16(emb.to(torch.bfloat16), x, None,
                                          10)),
        "cosine_topk_int8": (
            lambda: tk.cosine_topk_int8.launches, query,
            lambda x: tk.cosine_topk_int8(table8, scales, x, None, 10)),
    }


@pytest.mark.parametrize("name", [
    "fused_patch_embed", "fused_patch_embed_i420", "flash_attention",
    "flash_attention_blhd", "cosine_scores", "cosine_scores_bf16",
    "cosine_scores_int8", "cosine_window_topk", "cosine_topk_f32",
    "cosine_topk_bf16", "cosine_topk_int8"])
def test_kernel_wrapper_refuses_to_drop_a_gradient(cuda, name):
    """With grad enabled and an input that requires grad, every wrapper
    raises on the card (its output would have no ``grad_fn``) and
    launches nothing; under ``inference_mode`` the same call launches."""
    count, x, call = _grad_cases(cuda)[name]
    before = count()
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call(x.clone().requires_grad_())
    assert count() == before
    with torch.inference_mode():
        call(x)
    torch.cuda.synchronize()
    assert count() == before + 1


def test_tiny_clip_train_step_on_card_matches_cpu(cuda):
    """One ``make_train_step`` step of the tiny CLIP in f32 (TF32 off) on
    the card and on the CPU from one seed and batch: loss within 1e-4
    relative, gradient norm within 1e-3, parameters within 1e-4."""
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.train import (create_train_state,
                                                demo_batch, make_train_step)

    cfg = tiny_test_config()
    images, ids = demo_batch(cfg, 8)
    out = {}
    for dev in ("cuda", "cpu"):
        model, state = create_train_state(cfg, learning_rate=1e-3,
                                          device=dev)
        state, m = make_train_step(model)(
            state, torch.from_numpy(images).to(dev),
            torch.from_numpy(ids).to(dev))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    {k: v.detach().cpu()
                     for k, v in model.named_parameters()})
    (lc, gc, pc), (lr, gr, pr) = out["cuda"], out["cpu"]
    assert abs(lc - lr) <= 1e-4 * abs(lr) and abs(gc - gr) <= 1e-3 * gr
    assert max(float((pc[k] - pr[k]).abs().max()) for k in pr) <= 1e-4


def test_blip_caption_train_step_on_card(cuda):
    """A tiny BLIP built with ``use_flash=False`` takes a caption step on
    the card (no flash launch: the plain attention trains) with the
    CPU's loss within 1e-4 relative; the same model with flash on
    refuses the step."""
    import dataclasses

    from avede_tpu_torch.models.blip import init_blip, tiny_blip_config
    from avede_tpu_torch.parallel import optim
    from avede_tpu_torch.parallel.train import (TrainState,
                                                make_caption_train_step)

    cfg = dataclasses.replace(tiny_blip_config(), use_flash=False)
    rng = np.random.default_rng(0)
    px = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(3, 90, size=(2, 8))
    ids[:, 0], ids[0, 6:] = cfg.bos_token_id, cfg.pad_token_id
    losses = {}
    for dev in ("cuda", "cpu"):
        model = init_blip(cfg, seed=0).to(dev).train()
        state = TrainState(model, optim.adamw(model.parameters(), 1e-3,
                                              clip_norm=1.0))
        before = tattn.flash_attention_blhd.launches_by_length.total()
        _, m = make_caption_train_step(model, cfg.pad_token_id)(
            state, torch.from_numpy(px).to(dev), torch.from_numpy(ids).to(dev))
        losses[dev] = float(m["loss"])
        assert tattn.flash_attention_blhd.launches_by_length.total() == before
    assert np.isfinite(losses["cuda"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * losses["cpu"]
    with pytest.raises(ValueError, match="use_flash=False"):
        make_caption_train_step(init_blip(tiny_blip_config()), 0)


@pytest.mark.parametrize("bsz,L,fused", [(1, 65, False), (16, 65, True),
                                         (3, 1, False), (2, 130, False),
                                         (5, 17, True)])
def test_flash_blhd_kernel_at_head_dim_24(cuda, bsz, L, fused):
    """The ``detection`` eval mode's OWL-ViT (64 px, patch 8, 4 heads of
    24: L = 65, one full key tile and one of a single key): hd = 24,
    padded to 32 columns (64-byte rows) in shared memory; contiguous
    heads (row stride 96) or the thirds of a fused qkv (row stride
    288)."""
    g = torch.Generator(device="cuda").manual_seed(24 + L)
    if fused:
        qkv = torch.randn(bsz, L, 3 * 96, device=cuda, generator=g
                          ).to(torch.bfloat16)
        q, k, v = (t.unflatten(-1, (4, 24)) for t in qkv.chunk(3, dim=-1))
    else:
        q, k, v = (torch.randn(bsz, L, 96, device=cuda, generator=g
                               ).to(torch.bfloat16).view(bsz, L, 4, 24)
                   for _ in range(3))
    before = tattn.flash_attention_blhd.launches_by_length[L]
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert tattn.flash_attention_blhd.launches_by_length[L] == before + 1
    ref = tattn.flash_attention_blhd_plain(q.float(), k.float(), v.float())
    _within_bf16_ulp(got, ref)


def test_detection_owlvit_on_card_matches_cpu(cuda):
    """The ``detection`` mode's OWL-ViT served as ``UniversalDetector``
    serves it (bf16, flash in each of its 4 vision layers at L = 65,
    hd = 24) against the same weights in f32 on the CPU: each frame's
    logits at cosine >= 0.999, boxes within 0.02."""
    from avede_tpu_torch.eval import DETECTION_OWL
    from avede_tpu_torch.models.owlvit import OwlViTConfig, init_owlvit
    from avede_tpu_torch.ops.preprocess import clip_preprocess

    cpu = init_owlvit(OwlViTConfig(**DETECTION_OWL), seed=0).eval()
    card = init_owlvit(OwlViTConfig(**DETECTION_OWL, use_flash=True,
                                    dtype="bfloat16"), seed=0)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda, torch.bfloat16).eval()
    frames = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 128, 128, 3), dtype=np.uint8))
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        1, 255, (4, 8)).astype(np.int64))
    before = tattn.flash_attention_blhd.launches_by_length[65]
    with torch.inference_mode():
        lg, bx = card(clip_preprocess(frames.to(cuda), size=64),
                      ids.to(cuda))
        torch.cuda.synchronize()
        rl, rb = cpu(clip_preprocess(frames, size=64), ids)
    assert tattn.flash_attention_blhd.launches_by_length[65] == before + 4
    got, ref = lg.float().cpu().reshape(3, -1), rl.reshape(3, -1)
    cos = (got * ref).sum(1) / (got.norm(dim=1) * ref.norm(dim=1))
    assert float(cos.min()) >= 0.999, float(cos.min())
    assert float((bx.float().cpu() - rb).abs().max()) <= 0.02


@pytest.mark.parametrize("name", ["yolo", "owl"])
def test_detector_train_step_on_card_matches_cpu(cuda, name, monkeypatch):
    """One step of each detector trainer on the card and on the CPU from
    one seed and batch, with cuDNN's TF32 at PyTorch's default (on): the
    step's own switch keeps its convolutions in f32. Loss within 1e-4
    relative, gradient norm within 1e-3; YOLO's BatchNorm statistics
    unchanged; the switch restored after the step."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    from avede_tpu_torch.eval import DETECTION_OWL
    from avede_tpu_torch.models.owlvit import OwlViTConfig
    from avede_tpu_torch.models.yolo import YoloConfig
    from avede_tpu_torch.parallel.train_det import (create_yolo_train_state,
                                                    make_yolo_train_step)
    from avede_tpu_torch.parallel.train_owl import (create_owl_train_state,
                                                    make_owl_train_step)
    from avede_tpu_torch.utils.synthetic import draw_shape_scene

    rng = np.random.default_rng(9)
    size = 64 if name == "yolo" else 128
    data = [draw_shape_scene(rng, hw=(size, size), max_boxes=4)
            for _ in range(4)]
    batch = [np.stack([d[i] for d in data]) for i in range(4)]
    if name == "owl":
        batch[1] = (batch[1] / size).astype(np.float32)
    ids = rng.integers(1, 255, (4, 8))
    out = {}
    for dev in ("cuda", "cpu"):
        if name == "yolo":
            model, state = create_yolo_train_state(
                YoloConfig(num_classes=4, img_size=64), device=dev)
            step = make_yolo_train_step(model)
        else:
            model, state = create_owl_train_state(
                OwlViTConfig(**DETECTION_OWL), device=dev)
            step = make_owl_train_step(model, ids)
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        _, m = step(state, *(torch.from_numpy(a).to(dev) for a in batch))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]))
        for k, v in stats.items():
            assert torch.equal(model.state_dict()[k], v), k
        assert torch.backends.cudnn.allow_tf32
    (lc, gc), (lr, gr) = out["cuda"], out["cpu"]
    assert abs(lc - lr) <= 1e-4 * abs(lr) and abs(gc - gr) <= 1e-3 * gr


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_index_on_card_matches_one_shard(cuda, dtype):
    """The index over 3 virtual shards of the card (capacity rounded up
    to a multiple of 3, spans cut at shard boundaries, growth, a
    removal, duplicated rows in every span) against one shard: the same
    hits with bit-equal scores (the kernels score a row by D alone)."""
    from avede_tpu_torch.parallel.mesh import build_mesh
    from avede_tpu_torch.services.library_index import DeviceLibraryIndex

    rng = np.random.default_rng(1)
    one = DeviceLibraryIndex(512, dtype=dtype, device="cuda")
    sharded = DeviceLibraryIndex(
        512, dtype=dtype, mesh=build_mesh([torch.device("cuda", 0)] * 3))
    dup = rng.normal(size=(4, 512)).astype(np.float32)
    dup /= np.linalg.norm(dup, axis=1, keepdims=True)
    for i, n in enumerate((700, 300, 1200, 450, 900)):
        emb = rng.normal(size=(n, 512)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        emb[:4], emb[-4:] = dup, dup
        for ix in (one, sharded):
            ix.add(f"v{i}", emb, np.arange(float(n)))
        if i == 2:
            for ix in (one, sharded):
                ix.remove("v1")
    assert sharded.capacity % 3 == 0 and sharded.capacity >= one.capacity
    assert len(sharded._shards) == 3
    for q in [dup[0]] + list(rng.normal(size=(3, 512)).astype(np.float32)):
        for k in (1, 16, 64, 1024):
            assert sharded.search(q, k) == one.search(q, k)


def test_kernel_launches_under_its_tensors_device(cuda, monkeypatch):
    """A wrapper makes its tensor's device current for the launch (the
    entry launches on the current device): called with another device
    current, where there is one, it still launches on its tensor's."""
    from avede_tpu_torch.ops import _build

    seen = []
    entry = _build.entry

    def spy(lib, symbol, argtypes):
        fn = entry(lib, symbol, argtypes)

        def call(*args):
            seen.append(torch.cuda.current_device())
            return fn(*args)
        return call

    monkeypatch.setattr(_build, "entry", spy)
    x = torch.randn(300, 512, device=cuda)
    other = 1 if torch.cuda.device_count() > 1 else 0
    with torch.cuda.device(other):
        q, s = tq.quantize_rows(x)
    torch.cuda.synchronize()
    assert seen == [x.device.index]
    assert torch.equal(q.cpu(), tq.quantize_rows_plain(x.cpu())[0])
    assert torch.equal(s.cpu(), tq.quantize_rows_plain(x.cpu())[1])
