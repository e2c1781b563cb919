"""The flash and patch-embed kernels at every shape the models give them:
the port's plain versions against the JAX package's Pallas kernels
(interpret mode on the CPU) on the same numpy-seeded inputs, the head
dims each wrapper admits against the instantiations its CUDA source
dispatches, and the attention layer's choice of flash entry by dtype.

The CUDA kernels themselves are held to these plain versions on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from avede_tpu.models import layers as jlayers
from avede_tpu.ops import attention as jattn
from avede_tpu.ops import pallas_kernels as jpk
from avede_tpu.ops.preprocess import clip_preprocess_i420 as j_i420
from avede_tpu_torch.models import layers as tlayers
from avede_tpu_torch.models.convert import params_from_jax
from avede_tpu_torch.ops import attention as tattn
from avede_tpu_torch.ops import kernels as tk

FLASH_SRC = (Path(tattn.__file__).resolve().parent.parent / "csrc"
             / "flash_attention.cu")


@pytest.mark.parametrize("L", [17, 50, 65, 257])
@pytest.mark.parametrize("D", [16, 24, 32, 64, 88])
def test_f32_flash_plain_matches_pallas(D, L):
    """The f32 entry's plain version at each instantiated head dim,
    across one key tile (17, 50), one key past it (65) and one key past
    four (257), against the Pallas kernel."""
    rng = np.random.default_rng(D * 1000 + L)
    q, k, v = (rng.normal(size=(1, 2, L, D)).astype(np.float32)
               for _ in range(3))
    ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v))
    assert got.shape == (1, 2, L, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


def _dispatched(entry: str, launcher: str) -> set:
    """Head dims that ``entry``'s dispatch in the CUDA source hands to an
    instantiation of ``launcher``."""
    src = FLASH_SRC.read_text()
    body = src[src.index(f'extern "C" int {entry}('):]
    body = body[:body.index("\n}\n")]
    return {int(d) for d in re.findall(rf"{launcher}<(\d+)[,>]", body)}


def test_wrapper_head_dims_match_the_instantiations():
    assert set(tattn._HEAD_DIMS) == _dispatched(
        "avede_flash_attention_f32", "launch_f32")
    assert set(tattn._BLHD_HEAD_DIMS) == _dispatched(
        "avede_flash_attention_bf16", "launch_bf16")
    # every head dim the models run, in both entries
    assert {16, 24, 64, 88} <= set(tattn._HEAD_DIMS) \
        & set(tattn._BLHD_HEAD_DIMS)


@pytest.mark.parametrize("dim,heads,L", [(64, 4, 65), (96, 4, 65),
                                         (96, 4, 17)])
def test_f32_flash_layer_matches_jax(dim, heads, L):
    """``MultiHeadAttention(use_flash=True)`` in f32 (the f32 entry's
    plain version on the CPU) against the JAX layer with its Pallas
    flash kernel (interpret) on the same weights: hd = 16 and hd = 24
    (the ``detection`` eval mode's OWL-ViT width)."""
    rng = np.random.default_rng(dim + L)
    x = rng.normal(size=(2, L, dim)).astype(np.float32)
    jl = jlayers.MultiHeadAttention(dim, heads, use_flash=True)
    params = jl.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    ref = jl.apply({"params": params}, jnp.asarray(x))
    layer = tlayers.MultiHeadAttention(dim, heads, use_flash=True)
    layer.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


@pytest.fixture()
def flash_calls(monkeypatch):
    """Both flash entries, as the layer sees them, replaced by recorders
    that return an output of the entry's shape on the input's device."""
    calls = []

    def contract(q, k, v):
        calls.append(("flash_attention", tuple(q.shape), q.dtype))
        return torch.empty_like(q)

    def blhd(q, k, v):
        calls.append(("flash_attention_blhd", tuple(q.shape), q.dtype))
        b, length, h, d = q.shape
        return torch.empty(b, length, h * d, dtype=q.dtype, device=q.device)

    monkeypatch.setattr(tlayers, "flash_attention", contract)
    monkeypatch.setattr(tlayers, "flash_attention_blhd", blhd)
    return calls


@pytest.mark.parametrize("dtype,entry,shape", [
    (torch.float32, "flash_attention", (3, 4, 50, 16)),
    (torch.bfloat16, "flash_attention_blhd", (3, 50, 4, 16))])
def test_flash_layer_picks_the_entry_by_dtype(flash_calls, dtype, entry,
                                              shape):
    """On tensors that are on no device's kernel path (meta): f32 q, k, v
    go to the contract entry as ``[B, H, L, hd]``, bf16 ones to the
    ``[B, L, H, hd]`` entry, one call a forward."""
    layer = tlayers.MultiHeadAttention(64, 4, use_flash=True).to(
        "meta", dtype)
    out = layer(torch.empty(3, 50, 64, device="meta", dtype=dtype))
    assert out.shape == (3, 50, 64) and out.dtype == dtype
    assert flash_calls == [(entry, shape, dtype)]


def test_flash_layer_refuses_other_dtypes(flash_calls):
    layer = tlayers.MultiHeadAttention(64, 4, use_flash=True).to(
        "meta", torch.float16)
    with pytest.raises(ValueError, match="float16"):
        layer(torch.empty(3, 50, 64, device="meta", dtype=torch.float16))
    assert flash_calls == []


@pytest.mark.parametrize("s,patch,dim", [(32, 8, 64), (28, 7, 70)])
def test_i420_plain_matches_pallas_at_any_patch(s, patch, dim):
    """The I420 entry's plain version at the shapes the any-shape kernel
    takes: the tiny CLIP (32 px, P = 8, D = 64) and an odd P with a
    ragged D (28 px, P = 7: K = 147; D = 70), against the JAX package's
    device unpack into its Pallas kernel."""
    rng = np.random.default_rng(s * patch)
    packed = rng.integers(0, 256, (3, s * 3 // 2, s), dtype=np.uint8)
    kernel = rng.normal(0, 0.02, (patch, patch, 3, dim)).astype(np.float32)
    bias = rng.normal(0, 0.01, (dim,)).astype(np.float32)
    px = j_i420(jnp.asarray(packed), normalize=False) * 255.0
    ref = jpk.fused_patch_embed(px, jnp.asarray(kernel), jnp.asarray(bias),
                                interpret=True)
    w2, delta = tk.fold_for_uint8(torch.from_numpy(kernel))
    got = tk.fused_patch_embed_i420(torch.from_numpy(packed), w2,
                                    delta + torch.from_numpy(bias), patch,
                                    out_dtype=torch.float32)
    g = s // patch
    assert got.shape == (3, g * g, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
