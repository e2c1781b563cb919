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


def _windows(seed, n, n_valid, w_real, wb):
    """Window middles: ``w_real`` rows of an ``n``-row table (some past
    ``n_valid``, so invalid), padded with -1 to ``wb``."""
    rng = np.random.default_rng(seed)
    mids = np.full((wb,), -1, np.int32)
    mids[:w_real] = rng.choice(n, size=w_real, replace=False)
    mids[1] = n - 1                           # an invalid row (n_valid < n)
    return mids


class TestFusedWindowTopkMatchesJax:
    """The fused entry (its plain composition on the CPU) against JAX's
    ``window_topk`` / ``window_topk_multi``: indices exactly equal,
    values within 1e-6 (f32 dots summed in another order), on inputs
    whose finite window scores are at least 1e-5 apart."""

    @pytest.mark.parametrize("nq,w_real,wb,k", [
        (1, 20, 32, 1),        # k = 1
        (1, 20, 32, 32),       # k = W: every padded window, -inf last
        (1, 20, 32, 25),       # k > finite windows
        (4, 20, 32, 6),        # Q = 4
        (4, 24, 24, 24),       # Q = 4, no padding, k = W
        (4, 12, 64, 40)])      # Q = 4, k > finite windows
    def test_matches_jax(self, nq, w_real, wb, k):
        from avede_tpu_torch.ops import kernels as tk

        rng, emb, valid = _table(10 + nq + k, 128, 32, 100)
        q = rng.normal(size=(nq, 32)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        mids = _windows(k, 128, 100, w_real, wb)
        finite = np.sort((emb[mids[(mids >= 0) & (mids < 100)]] @ q.T).T,
                         axis=1)
        assert np.diff(finite, axis=1).min() > 1e-5       # no near ties
        if nq == 1:
            rv, ri = jsim.window_topk(jnp.asarray(emb), jnp.asarray(valid),
                                      jnp.asarray(q[0]), jnp.asarray(mids),
                                      k=k)
            gv, gi = tk.cosine_window_topk(_t(emb), _t(valid), _t(q[0]),
                                           _t(mids), k)
        else:
            rv, ri = jsim.window_topk_multi(
                jnp.asarray(emb), jnp.asarray(valid), jnp.asarray(q),
                jnp.asarray(mids), k=k)
            gv, gi = tk.cosine_window_topk(_t(emb), _t(valid), _t(q),
                                           _t(mids), k)
        assert gi.shape == np.asarray(ri).shape
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=0,
                                   atol=1e-6)
        assert np.isneginf(gv.numpy()).sum() \
            == max(0, k - (finite.shape[1])) * nq

    def test_serving_functions_take_the_fused_entry(self):
        """``window_topk`` and ``window_topk_multi`` are the fused entry
        (on the CPU its plain composition; no launch counted)."""
        from avede_tpu_torch.ops import kernels as tk

        rng, emb, valid = _table(5, 64, 32, 50)
        q = rng.normal(size=(3, 32)).astype(np.float32)
        mids = _windows(5, 64, 50, 10, 16)
        before = (tk.cosine_window_topk.launches, tk.cosine_scores.launches)
        for got, want in (
                (tsim.window_topk(_t(emb), _t(valid), _t(q[0]), _t(mids), 5),
                 tk.cosine_window_topk_plain(_t(emb), _t(valid), _t(q[0]),
                                             _t(mids), 5)),
                (tsim.window_topk_multi(_t(emb), _t(valid), _t(q), _t(mids),
                                        5),
                 tk.cosine_window_topk_plain(_t(emb), _t(valid), _t(q),
                                             _t(mids), 5))):
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
        assert (tk.cosine_window_topk.launches,
                tk.cosine_scores.launches) == before


def _kernel_order(scores, k):
    """The CUDA select's order in numpy: each score's order key (bits,
    negatives inverted, -0.0 folded onto +0.0) above the row's
    complement, one unique 64-bit composite a row, sorted descending;
    values come from the scores themselves."""
    bits = scores.astype(np.float32).view(np.uint32).copy()
    bits[(bits << np.uint32(1)) == 0] = 0                 # -0.0 → +0.0
    neg = (bits & np.uint32(0x80000000)) != 0
    key = np.where(neg, ~bits, bits | np.uint32(0x80000000))
    comp = (key.astype(np.uint64) << np.uint64(32)) \
        | (np.uint64(0xFFFFFFFF) - np.arange(len(scores), dtype=np.uint64))
    idx = np.argsort(comp)[::-1][:k]
    return scores[idx], idx


def _adversarial(case, n=3000):
    rng = np.random.default_rng(len(case))
    if case == "ties":
        return rng.choice(np.float32([0.5, 0.25, -0.125, 0.0, 0.75]), n)
    if case == "signed_zeros":
        s = rng.choice(np.float32([0.0, -0.0, 1e-30, -1e-30]), n)
        s[::7] = -0.0
        return s
    if case == "all_neg_inf":
        return np.full(n, -np.inf, np.float32)
    if case == "one_finite":
        s = np.full(n, -np.inf, np.float32)
        s[1234] = -3.5
        return s
    # ties, -inf rows and signed zeros together
    s = rng.choice(np.float32([0.1, 0.2, 0.0, -0.0, -np.inf]), n)
    s[:500] = rng.normal(size=500).astype(np.float32)
    return s


class TestSelectOrder:
    """The select's order (the composite-key model of the kernels, and
    the fused entries' plain versions) equals ``torch.sort(stable=True)``
    exactly, values bit for bit, on adversarial vectors."""

    @pytest.mark.parametrize("case", ["ties", "signed_zeros", "all_neg_inf",
                                      "one_finite", "mixed"])
    @pytest.mark.parametrize("k", [1, 64, 1024, 1025])
    def test_key_order_equals_stable_sort(self, case, k):
        from avede_tpu_torch.ops import kernels as tk

        scores = _adversarial(case)
        assert k <= tk.FUSED_MAX_K or k == tk.FUSED_MAX_K + 1
        want_v, want_i = tsim.topk_scores(_t(scores), k)
        got_v, got_i = _kernel_order(scores, k)
        np.testing.assert_array_equal(got_i, want_i.numpy())
        np.testing.assert_array_equal(got_v.view(np.int32),
                                      want_v.numpy().view(np.int32))

    @pytest.mark.parametrize("case", ["ties", "signed_zeros", "one_finite",
                                      "mixed"])
    @pytest.mark.parametrize("k", [1024, 1025])
    def test_fused_plain_equals_stable_sort(self, case, k):
        """Rows whose f32 dot with a one-hot query is the adversarial
        score (a dot turns -0.0 into +0.0; -inf rows are masked): the
        f32 entry (every row, and through windows) against
        ``topk_scores`` of the contract entry's scores, at the largest
        fused k and above it."""
        from avede_tpu_torch.ops import kernels as tk

        scores = _adversarial(case)
        emb = np.zeros((len(scores), 4), np.float32)
        emb[:, 0] = np.where(np.isfinite(scores), scores, 0.0)
        valid = _t(np.isfinite(scores))
        emb, q = _t(emb), _t(np.float32([1.0, 0.0, 0.0, 0.0]))
        contract = tk.cosine_scores(emb, q, valid)
        mids = _t(np.arange(len(scores), dtype=np.int32)[::-1].copy())
        for got, want in (
                (tk.cosine_topk_f32(emb, q, valid, k),
                 tsim.topk_scores(contract, k)),
                (tk.cosine_window_topk(emb, valid, q, mids, k),
                 tsim.topk_scores(contract[mids.long()], k))):
            np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
            np.testing.assert_array_equal(got[0].numpy().view(np.int32),
                                          want[0].numpy().view(np.int32))
