"""Kimi-VL's kernels against their plain PyTorch versions on the card
(marked ``gpu``; each test skips without CUDA): the grouped expert GEMM
at a prefill's and a decode's loads, and flash attention at MoonViT's
head dim 72.

This file imports no JAX, so it also runs on a machine without it:
``python -m pytest tests/test_torch_kimi_gpu.py -m gpu --noconftest -q``.
"""

import pytest
import torch

from avede_tpu_torch.ops import attention as tattn
from avede_tpu_torch.ops import moe

pytestmark = pytest.mark.gpu

D, F = 2048, 1408          # Kimi-VL's hidden and expert widths
E, K, S = 64, 6, 2         # routed experts, chosen a token, shared


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _experts(cuda, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = E + S
    wg, wu = (torch.randn(n, F, D, device=cuda, generator=g) * D ** -0.5
              for _ in range(2))
    wd = torch.randn(n, D, F, device=cuda, generator=g) * F ** -0.5
    gate = torch.randn(E, D, device=cuda, generator=g) * D ** -0.5
    bias = torch.randn(E, device=cuda, generator=g) * 0.02
    return [t.to(torch.bfloat16) for t in (wg, wu, wd)] + [gate, bias]


def _f32_layer(x, r, wg, wu, wd):
    """The layer in f32 on the same bf16 values, token by token slot."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    xf = x.float()
    for e in r.slots.unique().tolist():
        tok, j = (r.slots == e).nonzero(as_tuple=True)
        y = moe.expert_swiglu(xf[tok], wg[e].float(), wu[e].float(),
                              wd[e].float())
        out.index_add_(0, tok, y * r.weights[tok, j, None])
    return out


@pytest.mark.parametrize("tokens,shape", [(2048, "prefill"), (30, "decode"),
                                          (3, "decode")])
def test_grouped_kernel_matches_plain(cuda, tokens, shape):
    """At a prefill's load (~190 rows an expert, 128-row tiles) and a
    decode step's (1-5 rows, 16-row tiles): the kernel within 1.25 times
    the plain bf16 version's own distance from the f32 layer (the kernel
    rounds SiLU(gate)·up once from f32, the plain version at each op),
    two grouped launches of the named shape."""
    wg, wu, wd, gate, bias = _experts(cuda, tokens)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(tokens, D, device=cuda, generator=g).to(torch.bfloat16)
    with torch.inference_mode():
        r = moe.route(x, gate, bias, K, 2.446, S)
        d = moe.dispatch(r.slots, E + S)
        before = dict(moe.grouped_swiglu.launches_by_shape)
        got = moe.grouped_swiglu(x, r, d, wg, wu, wd)
        torch.cuda.synchronize()
        plain = moe.grouped_swiglu_plain(x, r, d, wg, wu, wd)
        ref = _f32_layer(x, r, wg, wu, wd)
    assert moe.grouped_swiglu.launches_by_shape[shape] \
        == before.get(shape, 0) + 2
    err = (got.float() - ref).abs().max()
    bar = (plain.float() - ref).abs().max()
    assert float(err) <= 1.25 * float(bar) + 1e-6, (float(err), float(bar))


def test_grouped_kernel_uneven_loads(cuda):
    """An expert with no row, one with every token, the shared two with
    every token: no row dropped, the same answer as the plain version."""
    wg, wu, wd, gate, bias = _experts(cuda, 7)
    t = 300
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(t, D, device=cuda, generator=g).to(torch.bfloat16)
    choice = torch.stack([torch.full((t,), 5, device=cuda),
                          torch.arange(t, device=cuda) % 7 + 10,
                          torch.arange(t, device=cuda) % 3 + 20], 1)
    slots = torch.cat([choice, torch.tensor([E, E + 1], device=cuda)
                       .expand(t, -1)], 1)
    w = torch.rand(t, 5, device=cuda, generator=g)
    r = moe.Routing(slots, w)
    with torch.inference_mode():
        d = moe.dispatch(slots, E + S)
        assert int(d.counts[0]) == 0 and int(d.counts[5]) == t
        got = moe.grouped_swiglu(x, r, d, wg, wu, wd)
        torch.cuda.synchronize()
        plain = moe.grouped_swiglu_plain(x, r, d, wg, wu, wd)
        ref = _f32_layer(x, r, wg, wu, wd)
    err = (got.float() - ref).abs().max()
    bar = (plain.float() - ref).abs().max()
    assert float(err) <= 1.25 * float(bar) + 1e-6, (float(err), float(bar))


def test_grouped_kernel_refuses_other_shapes(cuda):
    x = torch.zeros(4, 96, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 64, 96, device=cuda, dtype=torch.bfloat16)
    slots = torch.zeros(4, 2, dtype=torch.long, device=cuda)
    r = moe.Routing(slots, torch.ones(4, 2, device=cuda))
    d = moe.dispatch(slots, 3)
    with pytest.raises(ValueError, match="multiple"):
        moe.grouped_swiglu(x, r, d, w, w, w.transpose(1, 2).contiguous())


def _within_bf16_ulp(got, ref):
    want = ref.to(torch.bfloat16).float()
    _, exp = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), exp - 8)
    err = (got.float() - want).abs()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert bool((err <= ulp + 1e-5).all()), float((err - ulp - 1e-5).max())


def _qkv(cuda, bsz, length, heads, hd, fused, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        qkv = torch.randn(bsz, length, 3 * heads * hd, device=cuda,
                          generator=g).to(torch.bfloat16)
        return [t.unflatten(-1, (heads, hd)) for t in qkv.chunk(3, dim=-1)]
    return [torch.randn(bsz, length, heads, hd, device=cuda, generator=g
                        ).to(torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("fused", [False, True], ids=["heads", "fused_qkv"])
@pytest.mark.parametrize("L,kernel", [(2304, "wgmma"), (257, "wgmma"),
                                      (65, "wgmma"), (64, "mma"),
                                      (50, "mma")])
def test_flash_hd72_matches_plain(cuda, L, kernel, fused):
    """hd 72 (MoonViT's 1152 / 16) on the kernel its route names, at
    MoonViT's L = 2304 and at partial tiles: one bf16 ulp + 1e-5 of the
    f32 plain version."""
    assert tattn.blhd_kernel(L, 72) == kernel
    q, k, v = _qkv(cuda, 2, L, 16, 72, fused, L)
    counts = tattn.flash_attention_blhd.launches_by_kernel
    before = counts[kernel]
    got = tattn.flash_attention_blhd(q, k, v)
    torch.cuda.synchronize()
    assert counts[kernel] == before + 1
    _within_bf16_ulp(got, tattn.flash_attention_blhd_plain(
        q.float(), k.float(), v.float()))


def test_moonvit_block_runs_wgmma_at_hd72(cuda):
    """A MoonViT block at its published widths over one 896×504 frame's
    2304 patches: one wgmma launch, close to the block in f32."""
    from avede_tpu_torch.models.kimi_vl import (KimiVLConfig, MoonViTBlock,
                                                vision_rope)

    cfg = KimiVLConfig()
    torch.manual_seed(0)
    blk = MoonViTBlock(cfg).to(cuda)
    x = torch.randn(1, 2304, 1152, device=cuda)
    cos, sin = vision_rope(72, 36, 64, 10000.0, cuda)
    counts = tattn.flash_attention_blhd.launches_by_kernel
    before = counts["wgmma"]
    with torch.inference_mode():
        blk16 = MoonViTBlock(cfg).to(cuda, torch.bfloat16)
        blk16.load_state_dict({k: v.to(torch.bfloat16)
                               for k, v in blk.state_dict().items()})
        got = blk16(x.to(torch.bfloat16), cos, sin)
        torch.cuda.synchronize()
        assert counts["wgmma"] == before + 1
        ref = blk.cpu()(x.cpu(), cos.cpu(), sin.cpu())
    c = torch.nn.functional.cosine_similarity(got.float().cpu(), ref, -1)
    assert float(c.min()) >= 0.99
