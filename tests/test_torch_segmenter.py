"""The port's U-Net segmenter against the JAX package's, on the CPU.

The weights are JAX's own init, carried across by
``models.convert.params_from_jax`` (Conv ``kernel`` HWIO → OIHW, flax
GroupNorm ``scale`` → ``weight``). Bars, all f32 (the two frameworks sum
in other orders: convolutions, GroupNorm's statistics, the losses):

- forward logits within ``1e-4 · max|JAX| + 1e-5``;
- ``segmentation_loss`` (BCE + soft Dice) within 1e-6 relative;
- the gradient of the loss with respect to every parameter leaf within
  ``1e-4 · max|JAX leaf| + 1e-6``;
- ``render_box_prior`` byte-equal.

Two configs: the tiny one (base 8, depth 2, 32 px) at batch 2 and the
default one (base 32, depth 3, 128 px) at batch 1. A 25-step run of the
port's Adam at 3e-3 learns the box mask, as ``tests/
test_models_extra.py`` asks of JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avede_tpu.models import segmenter as jseg
from avede_tpu_torch.models import segmenter as tseg
from avede_tpu_torch.models.convert import params_from_jax
from avede_tpu_torch.parallel.optim import adam

OUT_REL, OUT_ABS = 1e-4, 1e-5
LOSS_REL = 1e-6
GRAD_REL, GRAD_ABS = 1e-4, 1e-6

CONFIGS = {"tiny": (jseg.tiny_segmenter_config(),
                    tseg.tiny_segmenter_config(), 2),
           "default": (jseg.SegmenterConfig(), tseg.SegmenterConfig(), 1)}


def _batch(size, n, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.random((n, size, size, 3)).astype(np.float32)
    prior = np.stack([jseg.render_box_prior((100, 120),
                                            [10 + 7 * i, 15, 70, 80 - i],
                                            size) for i in range(n)])
    masks = np.zeros_like(prior)
    masks[:, size // 4: 3 * size // 4, size // 5: 2 * size // 3] = 1.0
    return px, prior, masks


@pytest.fixture(scope="module", params=list(CONFIGS))
def carried(request):
    """(name, JAX model, JAX params, port model on JAX's weights)."""
    jcfg, tcfg, _ = CONFIGS[request.param]
    jmodel, params = jseg.init_segmenter(jcfg, seed=0)
    params = jax.tree.map(np.asarray, params)
    tmodel = tseg.init_segmenter(tcfg, seed=0, device="cpu")
    tmodel.load_state_dict(params_from_jax(params))
    return request.param, jmodel, params, tmodel


def test_configs_match():
    for jcfg, tcfg, _ in CONFIGS.values():
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tseg.SegmenterConfig().torch_dtype == torch.float32


def test_state_dict_covers_every_jax_leaf(carried):
    _, _, params, tmodel = carried
    sd = params_from_jax(params)
    own = tmodel.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k


def test_forward_and_loss_match_jax(carried):
    name, jmodel, params, tmodel = carried
    size = CONFIGS[name][1].image_size
    px, prior, masks = _batch(size, CONFIGS[name][2])
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(px),
                                  jnp.asarray(prior)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(px), torch.from_numpy(prior))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= OUT_REL * np.abs(ref).max() + OUT_ABS, err
    jl = float(jseg.segmentation_loss(jnp.asarray(ref), jnp.asarray(masks)))
    tl = float(tseg.segmentation_loss(torch.from_numpy(ref.copy()),
                                      torch.from_numpy(masks)))
    assert abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)


def test_loss_is_stable_at_large_logits():
    logits = np.array([[[80.0, -80.0], [30.0, -200.0]]], np.float32)
    masks = np.array([[[0.0, 1.0], [1.0, 0.0]]], np.float32)
    jl = float(jseg.segmentation_loss(jnp.asarray(logits),
                                      jnp.asarray(masks)))
    tl = float(tseg.segmentation_loss(torch.from_numpy(logits),
                                      torch.from_numpy(masks)))
    assert np.isfinite(tl) and abs(tl - jl) <= LOSS_REL * abs(jl), (tl, jl)


def test_gradients_match_jax_per_leaf(carried):
    name, jmodel, params, tmodel = carried
    size = CONFIGS[name][1].image_size
    px, prior, masks = _batch(size, CONFIGS[name][2], seed=1)

    def loss_fn(p):
        return jseg.segmentation_loss(
            jmodel.apply({"params": p}, jnp.asarray(px), jnp.asarray(prior)),
            jnp.asarray(masks))

    jl, jgrads = jax.value_and_grad(loss_fn)(params)
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads))
    tmodel.zero_grad()
    tl = tseg.segmentation_loss(
        tmodel(torch.from_numpy(px), torch.from_numpy(prior)),
        torch.from_numpy(masks))
    tl.backward()
    assert abs(tl.item() - float(jl)) <= LOSS_REL * abs(float(jl)) + 1e-7
    grads = dict(tmodel.named_parameters())
    assert set(grads) == set(ref)
    for k, g in ref.items():
        got = grads[k].grad
        err = (got - g).abs().max().item()
        assert err <= GRAD_REL * g.abs().max().item() + GRAD_ABS, (k, err)
    tmodel.zero_grad()


@pytest.mark.parametrize("bbox,shape,size", [
    ([20, 20, 60, 60], (100, 100), 32), ([0, 0, 50, 50], (100, 100), 32),
    ([5.5, 3.2, 6.0, 3.3], (480, 640), 128),
    ([600, 400, 640, 480], (480, 640), 128)])
def test_render_box_prior_equals_jax(bbox, shape, size):
    got = tseg.render_box_prior(shape, bbox, size)
    ref = jseg.render_box_prior(shape, bbox, size)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_training_learns_box_mask():
    """25 steps of the port's Adam at 3e-3 on 'mask = box prior' (JAX's
    own check in ``tests/test_models_extra.py``) from JAX's weights, the
    first loss equal to JAX's. (Parameters after Adam are not compared:
    an element whose gradient sits near eps moves by about lr on
    rounding noise; the gradients are held above, the optimizer against
    optax in ``tests/test_torch_train.py``.)"""
    cfg = tseg.tiny_segmenter_config()
    jmodel, params = jseg.init_segmenter(jseg.tiny_segmenter_config())
    params = jax.tree.map(np.asarray, params)
    model = tseg.init_segmenter(cfg, device="cpu")
    model.load_state_dict(params_from_jax(params))
    rng = np.random.default_rng(0)
    px = rng.random((4, 32, 32, 3)).astype(np.float32)
    prior = np.zeros((4, 32, 32), np.float32)
    prior[:, 8:24, 8:24] = 1.0
    tpx, tprior = torch.from_numpy(px), torch.from_numpy(prior)
    opt = adam(model.parameters(), 3e-3)
    losses = []
    for _ in range(25):
        opt.zero_grad()
        loss = tseg.segmentation_loss(model(tpx, tprior), tprior)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]

    jl = jseg.segmentation_loss(
        jmodel.apply({"params": params}, jnp.asarray(px), jnp.asarray(prior)),
        jnp.asarray(prior))
    assert abs(losses[0] - float(jl)) <= LOSS_REL * abs(float(jl))


def test_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from avede_tpu_torch.utils.errors import ConfigurationError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ConfigurationError):
        tseg.init_segmenter(tseg.tiny_segmenter_config())
    model = tseg.init_segmenter(tseg.tiny_segmenter_config(), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
