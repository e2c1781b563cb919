"""The port's trainers, optimizer, losses, checkpoints and grounding eval
against the JAX package on the CPU: the same numpy-seeded inputs, the
JAX weights carried across with ``params_from_jax``, f32.

Bars: the optimizer's parameters within 1e-6 relative of optax's and
its gradient norm within 1e-6; the losses within 1e-6 of JAX's; each
train step's loss within 1e-5 relative and, after five steps at lr 1e-3
(Adam moves a parameter by about lr a step), every parameter within 1e-4
absolute; a restored checkpoint bit-equal to the run it came from.
"""

import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avede_tpu_torch.models.convert import (params_from_jax,
                                            train_state_from_jax)
from avede_tpu_torch.parallel import optim
from avede_tpu_torch.parallel import train as ttrain

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOSS_REL, PARAM_ABS, GRAD_REL = 1e-5, 1e-4, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(model, params):
    model.load_state_dict(params_from_jax(_np(params)))
    return model


def _shift_invariant(name, value):
    """Bool mask of the elements of parameter ``name`` whose gradient is
    0 in exact arithmetic: the key projection's bias (softmax is
    invariant to a shift of every key's score by q·b), in BLIP's fused
    qkv bias its middle third. Both packages hand Adam only rounding
    noise there, which it scales up to steps of about lr in either
    direction, so those elements agree only within lr per step."""
    mask = torch.zeros(value.shape, dtype=torch.bool)
    if name.endswith(("k_proj.bias", "attn.key.bias")):
        mask[:] = True
    elif name.endswith("qkv.bias"):
        d = value.shape[0] // 3
        mask[d:2 * d] = True
    return mask


def _assert_params_close(module, params, steps=1, lr=1e-3, atol=PARAM_ABS):
    """Every port parameter against the JAX tree: within ``atol``, except
    the shift-invariant elements (``_shift_invariant``), within
    ``2 · steps · lr``, whose gradient must be rounding noise (≤ 1e-5 of
    the largest gradient element of the last step) → the largest |diff|
    of the rest."""
    ref = params_from_jax(_np(params))
    got = dict(module.named_parameters())
    assert set(got) == set(ref)
    gmax = max(float(p.grad.abs().max()) for p in got.values()
               if p.grad is not None)
    worst = 0.0
    for k in ref:
        diff = (got[k].detach() - ref[k]).abs()
        free = _shift_invariant(k, diff)
        worst = max(worst, float(diff[~free].max()) if (~free).any() else 0.0)
        if free.any():
            assert float(diff[free].max()) <= 2 * steps * lr, k
            assert float(got[k].grad[free].abs().max()) <= 1e-5 * gmax, k
    assert worst <= atol, worst
    return worst


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

_SHAPES = {"dense": {"kernel": (6, 5), "bias": (5,)},
           "ln": {"scale": (5,)}, "embedding": (7, 4), "logit_scale": ()}


def _tree(rng, scale=1.0):
    return jax.tree.map(
        lambda s: jnp.asarray(rng.normal(size=s) * scale, jnp.float32),
        _SHAPES,
        is_leaf=lambda x: isinstance(x, tuple))


def _schedule():
    return (optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup_steps=2,
                                               decay_steps=6),
            optim.warmup_cosine_decay_schedule(0.0, 3e-3, warmup_steps=2,
                                               decay_steps=6))


_OPTIMIZERS = {
    "chain_clip_adamw": lambda: (
        optax.chain(optax.clip_by_global_norm(1.0),
                    optax.adamw(1e-3, weight_decay=0.05)),
        lambda ps: optim.adamw(ps, 1e-3, weight_decay=0.05, clip_norm=1.0)),
    "adamw": lambda: (optax.adamw(1e-3, weight_decay=0.01),
                      lambda ps: optim.adamw(ps, 1e-3, weight_decay=0.01)),
    "adam": lambda: (optax.adam(1e-3), lambda ps: optim.adam(ps, 1e-3)),
    "adamw_warmup_cosine": lambda: (
        optax.adamw(_schedule()[0], weight_decay=0.01),
        lambda ps: optim.adamw(ps, _schedule()[1], weight_decay=0.01)),
    "chain_clip_adam_warmup_cosine": lambda: (
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(_schedule()[0])),
        lambda ps: optim.adam(ps, _schedule()[1], clip_norm=1.0)),
}


@pytest.mark.parametrize("name", list(_OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Six updates on one tree; the gradient's global norm alternates
    above (3.0) and below (0.3) the clip's max_norm 1.0."""
    tx, make = _OPTIMIZERS[name]()
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.5)
    leaves = [torch.tensor(np.asarray(x)).requires_grad_()
              for x in jax.tree.leaves(params)]
    opt = make(leaves)
    state = tx.init(params)
    for i in range(6):
        grads = _tree(rng)
        gn = float(optax.global_norm(grads))
        grads = jax.tree.map(lambda g: g * ((3.0 if i % 2 == 0 else 0.3)
                                            / gn), grads)
        for p, g in zip(leaves, jax.tree.leaves(grads)):
            p.grad = torch.tensor(np.asarray(g))
        want_norm = float(optax.global_norm(grads))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        got_norm = float(opt.step())
        assert abs(got_norm - want_norm) <= 1e-6 * want_norm
        for p, ref in zip(leaves, jax.tree.leaves(params)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-9)
    assert opt.count == 6


def test_schedule_matches_optax_and_starts_at_zero():
    ref, got = _schedule()
    vals = [got(c) for c in range(9)]
    assert vals[0] == 0.0
    np.testing.assert_allclose(vals, [float(ref(c)) for c in range(9)],
                               rtol=1e-6, atol=1e-12)
    # the first update of a warmup from 0 moves nothing but the decay
    p = torch.ones(3, requires_grad=True)
    opt = optim.adam([p], got)
    p.grad = torch.ones(3)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))
    assert opt.lr() == pytest.approx(float(ref(1)), rel=1e-6)


def test_clip_has_no_epsilon_and_reports_the_norm_before_clipping():
    p = torch.zeros(2, requires_grad=True)
    opt = optim.Adam([p], 1.0, clip_norm=1.0)
    p.grad = torch.tensor([3.0, 4.0])
    assert float(opt.step()) == 5.0
    # clipped to [0.6, 0.8] exactly; Adam's first moment holds 0.1 · that
    np.testing.assert_array_equal(opt.mu[0].numpy(),
                                  np.float32(0.1) * np.array([0.6, 0.8],
                                                             np.float32))
    assert float(optim.global_norm([torch.tensor([3.0]),
                                    torch.tensor([4.0])])) == 5.0


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_clip_contrastive_loss_matches_jax():
    from avede_tpu.parallel.train import clip_contrastive_loss as jloss

    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    scale = np.float32(np.exp(2.6592))
    ref = float(jloss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(scale)))
    got = float(ttrain.clip_contrastive_loss(
        torch.from_numpy(a), torch.from_numpy(b), torch.tensor(scale)))
    assert abs(got - ref) <= 1e-6 * abs(ref)


def _grounding_inputs(rng, b=3, n=12):
    sal = rng.normal(size=(b, n)).astype(np.float32) * 3
    off = np.abs(rng.normal(size=(b, n, 2))).astype(np.float32) * 4
    sal_labels = (rng.random((b, n)) > 0.6).astype(np.float32)
    off_labels = np.abs(rng.normal(size=(b, n, 2))).astype(np.float32) * 4
    valid = np.ones((b, n), bool)
    valid[0, 9:] = False
    valid[2, 5:] = False
    sal_labels[0, 10] = 1.0          # a label under the mask
    # the head writes finfo.min at masked saliency
    sal = np.where(valid, sal, np.finfo(np.float32).min).astype(np.float32)
    return sal, off, sal_labels, off_labels, valid


def test_grounding_loss_matches_jax_with_masked_rows():
    from avede_tpu.models.univtg import grounding_loss as jloss

    from avede_tpu_torch.models.univtg import grounding_loss

    args = _grounding_inputs(np.random.default_rng(2))
    ref = float(jloss(*(jnp.asarray(x) for x in args)))
    sal, off, *rest = (torch.from_numpy(x) for x in args)
    sal.requires_grad_()
    off.requires_grad_()
    got = grounding_loss(sal, off, *rest)
    assert abs(got.item() - ref) <= 1e-6 * abs(ref)
    # the masked branch puts no NaN into the gradient
    got.backward()
    assert torch.isfinite(sal.grad).all() and torch.isfinite(off.grad).all()
    valid = torch.from_numpy(args[-1])
    assert float(sal.grad[~valid].abs().max()) == 0.0
    # ... and the gradient is JAX's
    jg = jax.grad(lambda s, o: jloss(s, o, *(jnp.asarray(x)
                                             for x in args[2:])),
                  argnums=(0, 1))(jnp.asarray(args[0]), jnp.asarray(args[1]))
    for g, r in zip((sal.grad, off.grad), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-8)


def test_nt_xent_loss_matches_jax():
    from avede_tpu.models.appearance import nt_xent_loss as jloss

    from avede_tpu_torch.models.appearance import nt_xent_loss

    rng = np.random.default_rng(3)
    a, b = (rng.normal(size=(8, 16)).astype(np.float32) for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    ref = float(jloss(jnp.asarray(a), jnp.asarray(b), 0.1))
    got = float(nt_xent_loss(torch.from_numpy(a), torch.from_numpy(b), 0.1))
    assert abs(got - ref) <= 1e-6 * abs(ref)


class _LogitsModel:
    """A stand-in Flax model whose ``apply`` returns its one parameter,
    so JAX's own caption step computes its loss on given logits."""

    def apply(self, variables, pixels, ids):
        return variables["params"]["logits"]


def test_caption_loss_with_pads_matches_jax():
    from avede_tpu.parallel.train import TrainState, make_caption_train_step

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 2
    ids = rng.integers(1, 11, size=(3, 7)).astype(np.int32)
    ids[0, 4:] = 0
    ids[2, 2:] = 0
    state = TrainState.create(apply_fn=None,
                              params={"logits": jnp.asarray(logits)},
                              tx=optax.sgd(0.0))
    _, metrics = make_caption_train_step(_LogitsModel(), 0)(
        state, jnp.zeros((3, 1)), jnp.asarray(ids))
    ref = float(metrics["loss"])
    got = float(ttrain.caption_loss(torch.from_numpy(logits),
                                    torch.from_numpy(ids), 0))
    assert abs(got - ref) <= 1e-6 * abs(ref)


# ---------------------------------------------------------------------------
# train steps against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    from avede_tpu.parallel.mesh import build_mesh

    return build_mesh(jax.devices()[:1])


def _clip_case(mesh, cfg_jax, cfg_port, batch, lr=1e-3):
    from avede_tpu.parallel.train import create_train_state, make_train_step

    jmodel, jstate = create_train_state(cfg_jax, mesh, learning_rate=lr)
    jstep = make_train_step(jmodel, mesh)
    model, state = ttrain.create_train_state(cfg_port, learning_rate=lr,
                                             device="cpu")
    _load(model, jstate.params)
    step = ttrain.make_train_step(model)
    rng = np.random.default_rng(5)

    def batches():
        while True:
            px = rng.normal(size=(batch, cfg_port.image_size,
                                  cfg_port.image_size, 3)).astype(np.float32)
            ids = rng.integers(1, cfg_port.vocab_size - 2,
                               size=(batch, cfg_port.max_text_len)
                               ).astype(np.int32)
            ids[:, -1] = cfg_port.vocab_size - 1
            yield px, ids

    return jstep, jstate, step, state, batches()


def _reid_case(mesh):
    from avede_tpu.models.appearance import tiny_appearance_config as jcfg
    from avede_tpu.parallel.train_reid import (create_reid_train_state,
                                               make_reid_train_step)

    from avede_tpu_torch.models.appearance import tiny_appearance_config
    from avede_tpu_torch.parallel.train_reid import (
        create_reid_train_state as tcreate, make_reid_train_step as tmake)

    jmodel, jstate = create_reid_train_state(jcfg(), learning_rate=1e-3)
    model, state = tcreate(tiny_appearance_config(), learning_rate=1e-3,
                           device="cpu")
    _load(model, jstate.params)
    rng = np.random.default_rng(6)

    def batches():
        while True:
            a = rng.random((6, 64, 64, 3)).astype(np.float32)
            yield a, np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1
                             ).astype(np.float32)

    return (make_reid_train_step(jmodel, mesh), jstate, tmake(model), state,
            batches())


def _grounding_case(mesh):
    from avede_tpu.models.univtg import tiny_grounding_config as jcfg
    from avede_tpu.parallel.train import (create_grounding_train_state,
                                          make_grounding_train_step)

    from avede_tpu_torch.models.univtg import tiny_grounding_config

    jmodel, jstate = create_grounding_train_state(jcfg(16),
                                                  learning_rate=1e-3)
    model, state = ttrain.create_grounding_train_state(
        tiny_grounding_config(16), learning_rate=1e-3, device="cpu")
    _load(model, jstate.params)
    rng = np.random.default_rng(7)

    def batches():
        b, n, d = 4, 32, 16
        while True:
            text = rng.normal(size=(b, d)).astype(np.float32)
            frames = rng.normal(size=(b, n, d)).astype(np.float32) * 0.1
            sal = np.zeros((b, n), np.float32)
            off = np.zeros((b, n, 2), np.float32)
            valid = np.ones((b, n), bool)
            valid[1, 24:] = False                 # padded frames
            for i in range(b):
                s = int(rng.integers(2, 14))
                frames[i, s:s + 6] += text[i] * 0.5
                sal[i, s:s + 6] = 1.0
                off[i, s:s + 6] = np.stack([np.arange(6), 6 - np.arange(6)],
                                           1)
            yield frames, text, sal, off, valid

    return (make_grounding_train_step(jmodel, mesh), jstate,
            ttrain.make_grounding_train_step(model), state, batches())


def _caption_case(mesh, jcfg=None, tcfg=None, batch=2, length=8):
    from avede_tpu.models.blip import BlipCaptioner as JBlip
    from avede_tpu.models.blip import tiny_blip_config as jtiny
    from avede_tpu.parallel.train import TrainState, make_caption_train_step

    from avede_tpu_torch.models.blip import BlipCaptioner, tiny_blip_config

    jcfg = jcfg or jtiny()
    tcfg = dataclasses.replace(tcfg or tiny_blip_config(), use_flash=False)
    rng = np.random.default_rng(8)

    def batches():
        while True:
            px = rng.normal(size=(batch, tcfg.image_size, tcfg.image_size, 3)
                            ).astype(np.float32)
            ids = rng.integers(3, 90, size=(batch, length)).astype(np.int32)
            ids[:, 0] = tcfg.bos_token_id
            ids[0, length - 3] = tcfg.eos_token_id
            ids[0, length - 2:] = tcfg.pad_token_id            # pads
            yield px, ids

    it = batches()
    px, ids = next(it)
    jmodel = JBlip(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), px, ids)["params"]
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(1e-3, weight_decay=1e-4))
    jstate = TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    model = _load(BlipCaptioner(tcfg), params).train()
    state = ttrain.TrainState(model, optim.adamw(
        model.parameters(), 1e-3, weight_decay=1e-4, clip_norm=1.0))
    return (make_caption_train_step(jmodel, tcfg.pad_token_id, mesh), jstate,
            ttrain.make_caption_train_step(model, tcfg.pad_token_id), state,
            it)


def _tiny_clip_case(mesh):
    from avede_tpu.models.clip import tiny_test_config as jtiny

    from avede_tpu_torch.models.clip import tiny_test_config

    return _clip_case(mesh, jtiny(), tiny_test_config(), batch=4)


_CASES = {"clip": _tiny_clip_case, "grounding": _grounding_case,
          "caption": _caption_case, "reid": _reid_case}


def _run(jstep, jstate, step, state, batches, n):
    """``n`` steps of both → per-step (jax loss, port loss) and the last
    JAX state."""
    losses = []
    for _ in range(n):
        args = next(batches)
        jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in args))
        state, m = step(state, *(torch.from_numpy(a) for a in args))
        losses.append((float(jm["loss"]), float(m["loss"])))
        if "grad_norm" in jm:
            ref = float(jm["grad_norm"])
            assert abs(float(m["grad_norm"]) - ref) <= LOSS_REL * ref
    return losses, jstate


@pytest.mark.parametrize("name", list(_CASES))
def test_five_steps_match_jax(mesh, name):
    jstep, jstate, step, state, batches = _CASES[name](mesh)
    losses, jstate = _run(jstep, jstate, step, state, batches, 5)
    for ref, got in losses:
        assert np.isfinite(got) and abs(got - ref) <= LOSS_REL * abs(ref), \
            losses
    assert state.step == 5 and state.optimizer.count == 5
    _assert_params_close(state.module, jstate.params, steps=5)


def _grad_capture():
    """An optax transformation that updates nothing and keeps the
    gradient in its state: JAX's own step hands its gradient out."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), {"g": u}))


def _full_width_step(jstep, jstate, step, state, batches):
    """One step of both; JAX's through ``_grad_capture`` → the largest
    per-tensor |port grad - JAX grad| / max |JAX grad| outside the
    shift-invariant key biases."""
    tx = _grad_capture()
    jstate = jstate.replace(tx=tx, opt_state=tx.init(jstate.params))
    losses, jstate = _run(jstep, jstate, step, state, batches, 1)
    (ref, got), = losses
    assert abs(got - ref) <= LOSS_REL * abs(ref)
    grads = params_from_jax(_np(jstate.opt_state["g"]))
    worst = 0.0
    for k, p in state.module.named_parameters():
        keep = ~_shift_invariant(k, p)
        if keep.any():
            diff = float((p.grad - grads[k]).abs()[keep].max())
            worst = max(worst, diff / float(grads[k].abs().max()))
    print(f"largest gradient difference / max |grad|: {worst:.3g}")
    assert worst <= GRAD_REL, worst


def test_full_width_clip_step_matches_jax(mesh):
    """ViT-B/32 widths (vision 768 / 12 heads / patch 32 / 224 px, text
    512 / 8 heads / vocab 49408 / 77 tokens) at depth 1, batch 2: loss,
    gradient norm and every gradient against JAX's step."""
    from avede_tpu.models.clip import vit_b32 as jvit

    from avede_tpu_torch.models.clip import vit_b32

    jcfg = dataclasses.replace(jvit(), vision_depth=1, text_depth=1)
    tcfg = dataclasses.replace(vit_b32(), vision_depth=1, text_depth=1)
    _full_width_step(*_clip_case(mesh, jcfg, tcfg, 2))


def test_full_width_caption_step_matches_jax(mesh):
    """BLIP-base widths (384 px, patch 16 → 577 tokens, 768 wide, 12
    vision heads, 8 text heads, vocab 30524) at depth 1, one image of 8
    tokens with pads: loss and every gradient against JAX's step."""
    from avede_tpu.models.blip import blip_base as jbase

    from avede_tpu_torch.models.blip import blip_base

    jcfg = dataclasses.replace(jbase(), vision_depth=1, text_depth=1)
    tcfg = dataclasses.replace(blip_base(), vision_depth=1, text_depth=1)
    _full_width_step(*_caption_case(mesh, jcfg, tcfg, batch=1))


def test_state_carried_from_jax_continues_the_run(mesh):
    """Two JAX steps, ``train_state_from_jax``, one port step = three
    JAX steps."""
    jstep, jstate, step, state, batches = _tiny_clip_case(mesh)
    data = [next(batches) for _ in range(3)]
    for args in data[:2]:
        jstate, _ = jstep(jstate, *(jnp.asarray(a) for a in args))
    state.load_state_dict(train_state_from_jax(
        _np(jstate.params), _np(jstate.opt_state), _np(jstate.step)))
    assert state.step == 2 and state.optimizer.count == 2
    jstate, jm = jstep(jstate, *(jnp.asarray(a) for a in data[2]))
    state, m = step(state, *(torch.from_numpy(a) for a in data[2]))
    ref = float(jm["loss"])
    assert abs(float(m["loss"]) - ref) <= LOSS_REL * ref
    _assert_params_close(state.module, jstate.params, steps=3)


# ---------------------------------------------------------------------------
# checkpoints, the demo loop
# ---------------------------------------------------------------------------

def _ckpt_batches():
    rng = np.random.default_rng(9)
    while True:
        yield tuple(torch.from_numpy(a) for a in (
            rng.normal(size=(2, 8, 16)).astype(np.float32),
            rng.normal(size=(2, 16)).astype(np.float32),
            (rng.random((2, 8)) > 0.5).astype(np.float32),
            rng.random((2, 8, 2)).astype(np.float32),
            np.ones((2, 8), bool)))


def _grounding_run(n, path=None):
    """``n`` steps of the tiny grounding head, each checkpointed under
    ``path`` when given → (state, step function)."""
    from avede_tpu_torch.models.univtg import tiny_grounding_config

    model, state = ttrain.create_grounding_train_state(
        tiny_grounding_config(16), device="cpu")
    step = ttrain.make_grounding_train_step(model)
    batches = _ckpt_batches()
    for i in range(n):
        state, _ = step(state, *next(batches))
        if path is not None:
            ttrain.save_checkpoint(state, path, step=i + 1)
    return state, step


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """2 steps, saved; restored into a fresh state, 1 more step =
    3 straight steps, bit for bit; ``step=None`` takes the latest."""
    path = str(tmp_path / "ckpt")
    straight, _ = _grounding_run(3)
    _grounding_run(2, path=path)
    fresh, step = _grounding_run(0)
    restored = ttrain.restore_checkpoint(fresh, path)
    assert restored.step == 2 and restored.optimizer.count == 2
    batches = _ckpt_batches()
    third = [next(batches) for _ in range(3)][-1]
    step(restored, *third)
    a, b = straight.state_dict(), restored.state_dict()
    assert a["step"] == b["step"] == 3
    assert a["opt_state"]["count"] == b["opt_state"]["count"] == 3
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for m in ("mu", "nu"):
        for k in a["opt_state"][m]:
            assert torch.equal(a["opt_state"][m][k], b["opt_state"][m][k])
    one = ttrain.restore_checkpoint(_grounding_run(0)[0], path, step=1)
    assert one.step == 1 and one.optimizer.count == 1


def test_train_demo_overfits_and_starts_at_jax_loss(mesh, monkeypatch):
    from avede_tpu.models.clip import init_clip as jinit
    from avede_tpu.models.clip import tiny_test_config as jtiny
    from avede_tpu.parallel.train import train_demo as jdemo

    from avede_tpu_torch.models.clip import init_clip

    _, jparams = jinit(jtiny(), seed=0)
    monkeypatch.setattr(ttrain, "init_clip",
                        lambda cfg, seed=0: _load(init_clip(cfg, seed),
                                                  jparams))
    got = ttrain.train_demo(n_steps=4, batch=8, device="cpu")
    ref = jdemo(n_steps=4, batch=8, mesh=mesh)
    assert got["last_loss"] < got["first_loss"]
    assert abs(got["first_loss"] - ref["first_loss"]) \
        <= LOSS_REL * ref["first_loss"]


# ---------------------------------------------------------------------------
# the grounding eval, guards
# ---------------------------------------------------------------------------

def test_eval_grounding_returns_jax_keys():
    from avede_tpu_torch import eval as teval

    out = teval.eval_grounding(steps=60, n_seeds=1, device="cpu")
    ref = json.loads((ROOT / "EVAL.json").read_text())["temporal_grounding"]
    assert set(out) == set(ref)
    assert out["train_steps"] == 60 and out["n_seeds"] == 1
    for k in ("mean_temporal_iou", "mean_temporal_iou_min",
              "mean_temporal_iou_std", "tiou_at_0.5", "tiou_at_0.7",
              "final_loss"):
        assert np.isfinite(out[k]), k
    assert 0.0 <= out["mean_temporal_iou"] <= 1.0


def test_eval_main_writes_its_own_file(tmp_path, monkeypatch):
    from avede_tpu_torch import eval as teval

    real = teval.eval_grounding
    monkeypatch.setattr(teval, "eval_grounding",
                        lambda seed, device: real(seed, steps=20, n_seeds=1,
                                                  device=device))
    out_file = tmp_path / "grounding.json"
    out = teval.main(["--mode", "grounding", "--device", "cpu",
                      "--out", str(out_file)])
    saved = json.loads(out_file.read_text())
    assert saved["meta"]["device"] == "cpu" and saved["meta"]["seed"] == 0
    assert saved["temporal_grounding"] == out["temporal_grounding"]
    with pytest.raises(SystemExit):
        teval.main(["--mode", "segmentation", "--device", "cpu"])


def _tiny_models():
    from avede_tpu_torch.models.appearance import tiny_appearance_config
    from avede_tpu_torch.models.blip import BlipCaptioner, tiny_blip_config
    from avede_tpu_torch.models.clip import init_clip, tiny_test_config
    from avede_tpu_torch.models.univtg import (init_grounding,
                                               tiny_grounding_config)
    from avede_tpu_torch.parallel.train_reid import create_reid_train_state

    return {"clip": init_clip(tiny_test_config()),
            "grounding": init_grounding(tiny_grounding_config()),
            "caption": BlipCaptioner(dataclasses.replace(
                tiny_blip_config(), use_flash=False)),
            "reid": create_reid_train_state(tiny_appearance_config(),
                                            device="cpu")[0]}


@pytest.mark.parametrize("what", ["create_train_state", "make_train_step",
                                  "make_grounding_train_step",
                                  "make_caption_train_step",
                                  "make_reid_train_step", "train_demo"])
def test_a_mesh_is_refused(what):
    from avede_tpu_torch.models.clip import tiny_test_config
    from avede_tpu_torch.parallel.train_reid import make_reid_train_step

    models = _tiny_models()
    calls = {
        "create_train_state": lambda m: ttrain.create_train_state(
            tiny_test_config(), mesh=m, device="cpu"),
        "make_train_step": lambda m: ttrain.make_train_step(models["clip"],
                                                            mesh=m),
        "make_grounding_train_step": lambda m: ttrain.make_grounding_train_step(
            models["grounding"], mesh=m),
        "make_caption_train_step": lambda m: ttrain.make_caption_train_step(
            models["caption"], 0, mesh=m),
        "make_reid_train_step": lambda m: make_reid_train_step(
            models["reid"], mesh=m),
        "train_demo": lambda m: ttrain.train_demo(mesh=m, device="cpu"),
    }
    calls[what](None)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        calls[what](object())


def test_flash_configs_are_refused():
    from avede_tpu_torch.models.blip import BlipCaptioner, tiny_blip_config
    from avede_tpu_torch.models.clip import tiny_test_config

    with pytest.raises(ValueError, match="use_flash=False"):
        ttrain.create_train_state(dataclasses.replace(
            tiny_test_config(), use_flash=True), device="cpu")
    with pytest.raises(ValueError, match="use_flash=False"):
        ttrain.make_caption_train_step(BlipCaptioner(tiny_blip_config()), 0)


def test_blip_plain_attention_equals_the_flash_path_on_cpu():
    from avede_tpu_torch.models.blip import (BlipCaptioner, init_blip,
                                             tiny_blip_config)

    flash = init_blip(tiny_blip_config(), seed=0).eval()
    plain = BlipCaptioner(dataclasses.replace(tiny_blip_config(),
                                              use_flash=False)).eval()
    plain.load_state_dict(flash.state_dict())
    rng = np.random.default_rng(10)
    px = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(1, 90, (2, 6)))
    with torch.no_grad():
        a, b = flash(px, ids), plain(px, ids)
    assert float((a - b).abs().max()) <= 1e-6


def test_kernel_guard_refuses_grad_and_spares_the_cpu():
    """The card-side guard raises for an input that requires grad with
    grad enabled, not under no_grad / inference_mode; on the CPU the
    wrappers take their plain, differentiable versions."""
    from avede_tpu_torch.ops import attention, kernels

    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention_blhd has no "
                                           "backward"):
        kernels._refuse_grad("flash_attention_blhd", x)
    kernels._refuse_grad("cosine_scores", x.detach())
    with torch.no_grad():
        kernels._refuse_grad("cosine_scores", x)
    with torch.inference_mode():
        kernels._refuse_grad("cosine_scores", x)
    q = torch.randn(1, 5, 2, 8, requires_grad=True)
    out = attention.flash_attention_blhd(q, q, q)
    out.sum().backward()
    assert out.grad_fn is not None and torch.isfinite(q.grad).all()
    emb = torch.randn(6, 4, requires_grad=True)
    kernels.cosine_scores(emb, torch.randn(4)).sum().backward()
    assert emb.grad is not None
