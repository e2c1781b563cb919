"""Port scoring + top-k against the JAX package's, on distinct scores
(``lax.top_k`` and the port's stable sort agree on ties too, which the
tie test pins)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.ops import similarity as jsim
from avede_tpu_torch.ops import similarity as tsim


def _table(seed, n, d, n_valid):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    valid = np.arange(n) < n_valid
    return rng, emb, valid


def _t(x):
    return torch.from_numpy(np.asarray(x))


class TestWindowTopk:
    @pytest.mark.parametrize("k", [1, 5, 40])
    def test_window_topk(self, k):
        rng, emb, valid = _table(0, 128, 32, 100)
        q = rng.normal(size=(32,)).astype(np.float32)
        q /= np.linalg.norm(q)
        mids = np.full((32,), -1, np.int32)
        mids[:12] = np.arange(4, 100, 8)
        rv, ri = jsim.window_topk(jnp.asarray(emb), jnp.asarray(valid),
                                  jnp.asarray(q), jnp.asarray(mids), k=k)
        gv, gi = tsim.window_topk(_t(emb), _t(valid), _t(q), _t(mids), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5)

    def test_window_topk_multi(self):
        rng, emb, valid = _table(1, 256, 32, 200)
        q = rng.normal(size=(4, 32)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        mids = np.full((32,), -1, np.int32)
        mids[:24] = np.arange(4, 196, 8)
        rv, ri = jsim.window_topk_multi(jnp.asarray(emb), jnp.asarray(valid),
                                        jnp.asarray(q), jnp.asarray(mids),
                                        k=6)
        gv, gi = tsim.window_topk_multi(_t(emb), _t(valid), _t(q), _t(mids),
                                        6)
        assert gi.shape == (4, 6)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-5)

    def test_masked_topk(self):
        rng = np.random.default_rng(2)
        scores = rng.normal(size=(64,)).astype(np.float32)
        valid = rng.random(64) > 0.3
        rv, ri = jsim.masked_topk(jnp.asarray(scores), jnp.asarray(valid),
                                  k=10)
        gv, gi = tsim.masked_topk(_t(scores), _t(valid), 10)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv))

    def test_ties_take_lower_index_first(self):
        scores = np.array([0.5, 0.9, 0.5, 0.9, 0.1, 0.5], np.float32)
        _, ri = jsim.topk_scores(jnp.asarray(scores), 5)
        _, gi = tsim.topk_scores(_t(scores), 5)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))

    def test_cosine_scores_normalize(self):
        rng = np.random.default_rng(3)
        f = rng.normal(size=(20, 16)).astype(np.float32)
        q = rng.normal(size=(3, 16)).astype(np.float32)
        ref = jsim.cosine_scores(jnp.asarray(f), jnp.asarray(q),
                                 normalize=True)
        got = tsim.cosine_scores(_t(f), _t(q), normalize=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


class TestPadTable:
    @pytest.mark.parametrize("n,w", [(10, 3), (64, 8), (70, 0), (2000, 300)])
    def test_pad_table_matches(self, n, w):
        emb = np.random.default_rng(n).normal(size=(n, 8)).astype(np.float32)
        mids = np.arange(w, dtype=np.int32)
        buckets = [32, 64, 128, 256, 512, 1024]
        for a, b in zip(jsim.pad_table(emb, mids, buckets),
                        tsim.pad_table(emb, mids, buckets)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
