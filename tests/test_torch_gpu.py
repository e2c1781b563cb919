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
