"""The port's int8 quantization against the JAX package's: the plain
versions of the ``csrc/quantize.cu`` kernels against
``quantize_kernel_pallas`` (interpret mode on the CPU),
``quantize_per_channel`` and ``quantize_rows_np``, on numpy-seeded
inputs. The bar is exact equality of ``q`` and the scales: all compute
in f32 and round half to even."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.ops import quant as jq
from avede_tpu_torch.ops import quant as tq


def _half_steps() -> np.ndarray:
    """[8, 4] columns: one with amax 127 (scale 1) holding ±2.5 and
    ±3.5 exactly on half steps, one all zero, two random."""
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.1, (8, 4)).astype(np.float32)
    w[:, 0] = [127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -1.5, 126.5]
    w[:, 1] = 0.0
    return w


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.normal(0, 0.05, (64, 32)).astype(np.float32),
        "wide": rng.normal(0, 1.0, (33, 130)).astype(np.float32),
        "half_steps": _half_steps(),
    }


@pytest.mark.parametrize("name", ["normal", "wide", "half_steps"])
def test_per_channel_equals_pallas_and_reference(name):
    w = _inputs()[name]
    q, s = tq.quantize_per_channel(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    rq, rs = jq.quantize_per_channel(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    pq, ps = jq.quantize_kernel_pallas(jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(pq))
    # Under jit, XLA rewrites amax / 127 as amax * f32(1/127), so the
    # Pallas kernel's scales can sit one ulp off the division that
    # numpy, eager JAX and the port compute; that is the only rounding
    # that differs.
    amax = np.abs(w).max(axis=0)
    recip = np.maximum(amax * np.float32(1 / 127.0), np.float32(1e-12))
    np.testing.assert_array_equal(np.asarray(ps), recip)
    assert np.all(np.abs(s.numpy() - np.asarray(ps))
                  <= np.spacing(np.asarray(ps)))


@pytest.mark.parametrize("name", ["normal", "wide", "half_steps"])
def test_rows_equal_numpy_twin(name):
    x = np.ascontiguousarray(_inputs()[name].T)     # rows = the columns
    q, s = tq.quantize_rows(torch.from_numpy(x))
    jq_, js = jq.quantize_rows_np(x)
    np.testing.assert_array_equal(q.numpy(), jq_)
    np.testing.assert_array_equal(s.numpy(), js)
    pq, ps = tq.quantize_rows_np(x)
    np.testing.assert_array_equal(pq, jq_)
    np.testing.assert_array_equal(ps, js)


def test_half_steps_round_to_even_and_zero_floor():
    q, s = tq.quantize_per_channel(torch.from_numpy(_half_steps()))
    assert s[0].item() == 1.0
    assert q[:, 0].tolist() == [127, 2, -2, 4, -4, 0, -2, 126]
    assert q[:, 1].tolist() == [0] * 8
    assert s[1].item() == np.float32(1e-12)


def test_rows_write_into_out_slices():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 16)).astype(np.float32)
    table = torch.zeros(10, 16, dtype=torch.int8)
    scales = torch.zeros(10)
    tq.quantize_rows(torch.from_numpy(x), out=(table[2:8], scales[2:8]))
    jq_, js = jq.quantize_rows_np(x)
    np.testing.assert_array_equal(table[2:8].numpy(), jq_)
    np.testing.assert_array_equal(scales[2:8].numpy(), js)
    assert not table[:2].any() and not table[8:].any()
    with pytest.raises(ValueError, match="out must be"):
        tq.quantize_rows(torch.from_numpy(x), out=(table[:5], scales[:5]))


@pytest.mark.parametrize("width", [32, 130, 33])
@pytest.mark.parametrize("which", ["none", "rows", "padded"])
def test_rows_into_equals_numpy_twin_and_mask(width, which):
    """The int8 index's add write on the CPU: a bucket-padded block (its
    padding rows zero) quantized into row slices of the table as
    ``quantize_rows_np`` does, with ``valid[r] = r < n_valid`` for
    ``n_valid`` 0 (a remove), the rows added and the padded size."""
    rng = np.random.default_rng(width)
    n, padded = 11, 16
    block = np.zeros((padded, width), np.float32)
    block[:n] = rng.normal(0, 0.05, (n, width))
    n_valid = {"none": 0, "rows": n, "padded": padded}[which]
    table = torch.full((padded + 4, width), 9, dtype=torch.int8)
    scales = torch.full((padded + 4,), 2.0)
    valid = torch.ones(padded + 4, dtype=torch.bool)
    before = tq.quantize_rows_into.launches
    tq.quantize_rows_into(torch.from_numpy(block), table[2:-2], scales[2:-2],
                          valid[2:-2], n_valid)
    assert tq.quantize_rows_into.launches == before
    jq_, js = jq.quantize_rows_np(block)
    np.testing.assert_array_equal(table[2:-2].numpy(), jq_)
    np.testing.assert_array_equal(scales[2:-2].numpy(), js)
    np.testing.assert_array_equal(valid[2:-2].numpy(),
                                  np.arange(padded) < n_valid)
    assert (table[:2] == 9).all() and (table[-2:] == 9).all()
    assert (scales[:2] == 2.0).all() and valid[:2].all() and valid[-2:].all()


def test_rows_into_refuses_bad_outputs():
    x = torch.zeros(4, 8)
    q, s = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(4)
    with pytest.raises(ValueError, match="out must be"):
        tq.quantize_rows_into(x, q[:3], s, torch.zeros(4, dtype=torch.bool),
                              4)
    with pytest.raises(ValueError, match="valid_out must be"):
        tq.quantize_rows_into(x, q, s, torch.zeros(4, dtype=torch.uint8), 4)
    with pytest.raises(ValueError, match="no kernel"):
        meta = torch.device("meta")
        tq.quantize_rows_into(
            torch.empty(4, 8, device=meta),
            torch.empty(4, 8, dtype=torch.int8, device=meta),
            torch.empty(4, device=meta),
            torch.empty(4, dtype=torch.bool, device=meta), 4)


def test_dequantize_and_quantized_matmul_match_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.1, (48, 24)).astype(np.float32)
    x = rng.normal(size=(5, 48)).astype(np.float32)
    q, s = tq.quantize_per_channel(torch.from_numpy(w))
    jq_, js = jq.quantize_per_channel(jnp.asarray(w))
    np.testing.assert_allclose(tq.dequantize(q, s).numpy(),
                               np.asarray(jq.dequantize(jq_, js)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tq.quantized_matmul(torch.from_numpy(x), q, s).numpy(),
        np.asarray(jq.quantized_matmul(jnp.asarray(x), jq_, js)),
        rtol=1e-6, atol=1e-6)


def test_quantize_dense_tree_matches_jax_on_tiny_clip():
    from avede_tpu.models.clip import init_clip, tiny_test_config

    _, params = init_clip(tiny_test_config(), seed=0)
    tree = jax.tree.map(np.asarray, params)
    jq_tree, js_tree, jreport = jq.quantize_dense_tree(tree)
    q_tree, s_tree, report = tq.quantize_dense_tree(tree)
    assert report == jreport and report["kernels_quantized"] > 0
    for ref, got in ((jq_tree, q_tree), (js_tree, s_tree)):
        ref_leaves, ref_def = jax.tree.flatten(ref)
        got_leaves, got_def = jax.tree.flatten(got)
        assert got_def == ref_def
        for a, b in zip(got_leaves, ref_leaves):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


class TestWrapperDispatch:
    def test_non_cpu_tensors_never_fall_back(self):
        meta = torch.device("meta")
        with pytest.raises(ValueError, match="no kernel"):
            tq.quantize_rows(torch.empty(4, 8, device=meta))
        with pytest.raises(ValueError, match="no kernel"):
            tq.quantize_per_channel(torch.empty(4, 8, device=meta))

    def test_cpu_path_counts_no_launch(self):
        before = (tq.quantize_rows.launches,
                  tq.quantize_per_channel.launches)
        tq.quantize_rows(torch.ones(3, 8))
        tq.quantize_per_channel(torch.ones(3, 8))
        assert (tq.quantize_rows.launches,
                tq.quantize_per_channel.launches) == before
