"""The bf16 flash entry at long sequences: its two kernels and the route
between them, on the CPU.

``flash_attention_blhd`` sends hd = 64 and 88 from ``WGMMA_MIN_LENGTH``
up to ``csrc/flash_attention_wgmma.cu`` and everything else to
``csrc/flash_attention.cu``'s ``mma.sync`` kernel. Here: the head dims
the new source dispatches against the set the route sends it, the route
as a function of (L, hd), the plain version (what both kernels are held
to on the card, by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``)
against the JAX package's Pallas kernel in interpret mode at the long
shapes, and the layers' calls, which the route does not change.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.ops import attention as jattn
from avede_tpu_torch.models import blip as tblip
from avede_tpu_torch.models import layers as tlayers
from avede_tpu_torch.ops import attention as tattn

CSRC = Path(tattn.__file__).resolve().parent.parent / "csrc"


def _dispatched(source: str, entry: str, launcher: str) -> set:
    """Head dims that ``entry``'s dispatch in ``csrc/<source>.cu`` hands
    to an instantiation of ``launcher``."""
    src = (CSRC / f"{source}.cu").read_text()
    body = src[src.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    return {int(d) for d in re.findall(rf"{launcher}<(\d+)[,>]", body)}


def test_wgmma_source_dispatches_the_routed_head_dims():
    source, entry = tattn._BLHD_KERNELS["wgmma"]
    assert set(tattn._WGMMA_HEAD_DIMS) == _dispatched(source, entry,
                                                      "launch_wgmma")
    # the short sequences of those head dims stay on the mma.sync kernel
    source, entry = tattn._BLHD_KERNELS["mma"]
    assert set(tattn._WGMMA_HEAD_DIMS) <= _dispatched(source, entry,
                                                      "launch_bf16")


@pytest.mark.parametrize("length,d,kernel", [
    (577, 64, "wgmma"),     # BLIP-base, OWL-ViT B/32: rows 2c, 2d
    (257, 88, "wgmma"),     # BLIP-2's ViT-g: row 2i
    (1025, 64, "wgmma"),
    (50, 64, "mma"),        # CLIP ViT-B/32: rows 2, 2e-2h
    (17, 16, "mma"),        # the tiny towers: row 2j
    (65, 24, "mma"),        # the detection eval's OWL-ViT: row 2k
    (577, 16, "mma"),       # hd 16 and 24 never leave the mma.sync kernel
    (577, 24, "mma"),
])
def test_route_by_length_and_head_dim(length, d, kernel):
    assert tattn.blhd_kernel(length, d) == kernel


@pytest.mark.parametrize("d", [64, 88])
def test_route_turns_at_the_crossover(d):
    at = tattn.WGMMA_MIN_LENGTH
    assert tattn.blhd_kernel(at - 1, d) == "mma"
    assert tattn.blhd_kernel(at, d) == "wgmma"


@pytest.mark.parametrize("kernel,d,what", [
    ("wgmma", 16, "head dim"), ("wgmma", 24, "head dim"),
    ("mma", 32, "head dim"), ("tma", 64, "no kernel")])
def test_named_kernel_refuses_what_it_lacks(kernel, d, what):
    """The check runs before any launch: meta tensors reach it, and no
    count moves."""
    q = torch.empty(2, 130, 4, d, device="meta", dtype=torch.bfloat16)
    before = dict(tattn.flash_attention_blhd.launches_by_kernel)
    with pytest.raises(ValueError, match=what):
        tattn.flash_attention_blhd_on(kernel, q, q, q)
    assert dict(tattn.flash_attention_blhd.launches_by_kernel) == before


@pytest.mark.parametrize("bh,length,d", [
    ((1, 2), 577, 64),      # ten 64-row, five 128-row tiles, one key over
    ((2, 1), 257, 88),      # BLIP-2: one key past two 128-key tiles
    ((1, 2), 129, 64),      # one key past one tile
    ((1, 2), 193, 88),      # 65 keys past one tile
])
def test_long_plain_matches_pallas(bh, length, d):
    """The plain version, on bf16-rounded inputs (the card's inputs are
    bf16), against the Pallas kernel in interpret mode on the same
    values in f32; both compute f32 attention, so the bar is f32
    rounding over L keys: 2e-5 absolute on outputs of size ~1."""
    b, h = bh
    rng = np.random.default_rng(length * 100 + d)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, length, h, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    got = tattn.flash_attention_blhd(q.float(), k.float(), v.float())
    assert got.shape == (b, length, h * d) and got.dtype == torch.float32
    ref = jattn.flash_attention(
        *(jnp.asarray(t.float().transpose(1, 2).numpy())
          for t in (q, k, v)), interpret=True)
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(b, length, h * d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    # the bf16 entry on the CPU is the same plain version, rounded once
    bf = tattn.flash_attention_blhd(q, k, v)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got.to(torch.bfloat16))


@pytest.fixture()
def blhd_calls(monkeypatch):
    """The bf16 entry, as the layers see it, replaced by a recorder."""
    calls = []

    def blhd(q, k, v):
        calls.append((tuple(q.shape), q.dtype, q.stride(1)))
        b, length, h, d = q.shape
        return torch.empty(b, length, h * d, dtype=q.dtype, device=q.device)

    monkeypatch.setattr(tlayers, "flash_attention_blhd", blhd)
    monkeypatch.setattr(tblip, "flash_attention_blhd", blhd)
    return calls


def test_layers_call_the_routed_entry(blhd_calls):
    """``MultiHeadAttention`` (contiguous heads) and BLIP's vision layer
    (the fused qkv's thirds, row stride 3·D) call the entry once a
    forward with ``[B, L, H, hd]`` in bf16 at every L: the kernel is
    chosen inside it, not by the layers."""
    layer = tlayers.MultiHeadAttention(128, 2, use_flash=True).to(
        "meta", torch.bfloat16)
    vision = tblip.BlipVisionLayer(tblip.tiny_blip_config()).to(
        "meta", torch.bfloat16)
    d, heads = vision.qkv.in_features, vision.heads
    for length in (50, 577):
        layer(torch.empty(3, length, 128, device="meta",
                          dtype=torch.bfloat16))
        vision(torch.empty(3, length, d, device="meta",
                           dtype=torch.bfloat16))
    assert blhd_calls == [
        ((3, 50, 2, 64), torch.bfloat16, 128),
        ((3, 50, heads, d // heads), torch.bfloat16, 3 * d),
        ((3, 577, 2, 64), torch.bfloat16, 128),
        ((3, 577, heads, d // heads), torch.bfloat16, 3 * d)]


@pytest.mark.parametrize("length", [50, 577])
def test_cpu_layer_runs_the_plain_version(length):
    """On the CPU a bf16 ``use_flash`` layer gives the plain path's
    answer at a length on either side of the crossover, and no kernel
    count moves."""
    torch.manual_seed(length)
    flash = tlayers.MultiHeadAttention(128, 2, use_flash=True)
    plain = tlayers.MultiHeadAttention(128, 2, use_flash=False)
    plain.load_state_dict(flash.state_dict())
    flash, plain = flash.to(torch.bfloat16), plain.to(torch.bfloat16)
    x = torch.randn(2, length, 128).to(torch.bfloat16)
    counts = tattn.flash_attention_blhd.launches_by_kernel
    before = dict(counts)
    with torch.no_grad():
        got, ref = flash(x), plain(x)
    assert dict(counts) == before
    torch.testing.assert_close(got.float(), ref.float(), rtol=0,
                               atol=2e-2)
