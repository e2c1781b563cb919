"""The port's sharded training under ``torch.distributed`` (gloo, CPU
processes spawned by ``avede_tpu_torch.parallel.dryrun.run_ranks``: the
children import the port only, no JAX and no conftest).

- The CLIP step at dp × tp = 1 × 2, 2 × 1 and 2 × 2 against the port's
  one-process step from the same weights (JAX's init) on the same
  global batches: the loss within 1e-5 relative for 3 steps, every
  parameter within ``PARAM_ABS``; the first 2 × 2 step against JAX's
  ``make_train_step`` on a 2 × 2 mesh of virtual devices.
- The grounding, caption, re-id and YOLO steps data-parallel at dp = 2
  against one process: their batch-wide normalisers (valid and
  foreground frames, caption tokens) differ between the two shards of
  these batches, so a mean of per-shard losses would miss.
- A checkpoint saved at tp = 2 restores in one process.
- ``dryrun_multichip`` at 2 and 4 ranks.

Adam moves a parameter whose gradient is rounding noise by about lr a
step either way (the key projection's bias: softmax ignores a shift of
every key's score), so those elements are held to ``2 · steps · lr``,
as in ``tests/test_torch_train.py``; every other element to
``PARAM_ABS``.
"""

import time

import numpy as np
import pytest

from avede_tpu_torch.parallel import dryrun
from avede_tpu_torch.parallel import train as ttrain

LOSS_REL, PARAM_ABS = 1e-5, 1e-4
LR = {"clip": 1e-3, "grounding": 1e-3, "caption": 1e-3, "reid": 1e-3,
      "yolo": 2e-3}
STEPS = 3
RANKS_TIMEOUT = 120.0


def _clip_batches(rng, n=STEPS, b=8):
    out = []
    for _ in range(n):
        px = rng.normal(size=(b, 32, 32, 3)).astype(np.float32)
        ids = rng.integers(1, 254, size=(b, 16)).astype(np.int32)
        ids[:, -1] = 255
        out.append((px, ids))
    return out


def _grounding_batches(rng, b=4, n=32, d=16):
    out = []
    for _ in range(STEPS):
        text = rng.normal(size=(b, d)).astype(np.float32)
        frames = rng.normal(size=(b, n, d)).astype(np.float32) * 0.1
        sal = np.zeros((b, n), np.float32)
        off = np.zeros((b, n, 2), np.float32)
        valid = np.ones((b, n), bool)
        valid[1, 20:] = False             # the first shard's padded frames
        for i in range(b):
            s = int(rng.integers(2, 14))
            w = 3 + 3 * (i >= 2)          # more foreground in the second
            frames[i, s:s + w] += text[i] * 0.5
            sal[i, s:s + w] = 1.0
            off[i, s:s + w] = np.stack([np.arange(w), w - np.arange(w)], 1)
        out.append((frames, text, sal, off, valid))
    return out


def _caption_batches(rng, b=4, length=8):
    from avede_tpu_torch.models.blip import tiny_blip_config

    cfg = tiny_blip_config()
    out = []
    for _ in range(STEPS):
        px = rng.normal(size=(b, cfg.image_size, cfg.image_size, 3)
                        ).astype(np.float32)
        ids = rng.integers(3, 90, size=(b, length)).astype(np.int32)
        ids[:, 0] = cfg.bos_token_id
        ids[0, length - 4] = cfg.eos_token_id
        ids[0, length - 3:] = cfg.pad_token_id   # pads in the first shard
        out.append((px, ids))
    return out


def _reid_batches(rng, b=6):
    out = []
    for _ in range(STEPS):
        a = rng.random((b, 64, 64, 3)).astype(np.float32)
        out.append((a, np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1
                               ).astype(np.float32)))
    return out


def _yolo_batches(rng, b=4):
    from avede_tpu_torch.utils.synthetic import draw_shape_scene

    out = []
    for _ in range(STEPS):
        data = [draw_shape_scene(rng, hw=(64, 64), max_boxes=3)
                for _ in range(b)]
        out.append(tuple(np.stack([d[i] for d in data]) for i in range(4)))
    return out


_BATCHES = {"grounding": _grounding_batches, "caption": _caption_batches,
            "reid": _reid_batches, "yolo": _yolo_batches}


def _assert_params_close(got, ref, lr, steps=STEPS):
    assert set(got) == set(ref)
    worst = 0.0
    for k in ref:
        diff = float(np.abs(got[k] - ref[k]).max())
        if k.endswith("k_proj.bias"):
            assert diff <= 2 * steps * lr, k
        else:
            worst = max(worst, diff)
    assert worst <= PARAM_ABS, worst


def _assert_losses_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert np.isfinite(g) and abs(g - r) <= LOSS_REL * abs(r), (got, ref)


@pytest.fixture(scope="module")
def clip_jax(tmp_path_factory):
    """JAX's tiny CLIP state on a 2 × 2 mesh of virtual devices (lr 1e-3,
    the port's trainer's), its first step, and the port checkpoint of its
    initial weights (``restore`` for every port run)."""
    import jax
    import jax.numpy as jnp

    from avede_tpu.models.clip import tiny_test_config as jtiny
    from avede_tpu.parallel.mesh import build_mesh as jbuild
    from avede_tpu.parallel.train import create_train_state, make_train_step
    from avede_tpu_torch.models.convert import params_from_jax

    batches = _clip_batches(np.random.default_rng(0))
    jmesh = jbuild(jax.devices()[:4], shape=[2, 2])
    jmodel, jstate = create_train_state(jtiny(), jmesh, learning_rate=1e-3)
    init = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    jstate, metrics = make_train_step(jmodel, jmesh)(
        jstate, *(jnp.asarray(a) for a in batches[0]))
    after = params_from_jax(jax.tree.map(np.asarray, jstate.params))

    state, _ = dryrun.tiny_trainer("clip", device="cpu")
    state.module.load_state_dict(init)
    ckpt = str(tmp_path_factory.mktemp("clip_init"))
    ttrain.save_checkpoint(state, ckpt, 0)
    return {"batches": batches, "restore": ckpt,
            "loss": float(metrics["loss"]),
            "params": {k: v.numpy() for k, v in after.items()}}


@pytest.fixture(scope="module")
def one_process(clip_jax):
    """Every trainer's run in this process: the reference."""
    out = {"clip": dryrun.run_trainer("clip", clip_jax["batches"],
                                      device="cpu",
                                      restore=clip_jax["restore"])}
    for kind, make in _BATCHES.items():
        out[kind] = dryrun.run_trainer(kind, make(np.random.default_rng(1)),
                                       device="cpu")
    return out


@pytest.fixture(scope="module")
def sharded(clip_jax, tmp_path_factory):
    """The sharded runs, spawned once per mesh shape at first use."""
    saved = str(tmp_path_factory.mktemp("clip_tp2"))
    clip = {"kind": "clip", "batches": clip_jax["batches"],
            "restore": clip_jax["restore"]}
    plans = {
        (1, 2): {"clip": dict(clip, save=saved)},
        (2, 1): {"clip": clip, **{k: {"kind": k, "batches": make(
            np.random.default_rng(1))} for k, make in _BATCHES.items()}},
        (2, 2): {"clip": clip,
                 "clip_first": dict(clip, batches=clip["batches"][:1])}}
    cache = {}

    def get(shape):
        if shape not in cache:
            names, runs = zip(*plans[shape].items())
            out = dryrun.run_ranks(dryrun.train_ranks, shape[0] * shape[1],
                                   (list(runs), list(shape)),
                                   timeout=RANKS_TIMEOUT)[0]
            cache[shape] = dict(zip(names, out))
        return cache[shape]
    get.saved = saved
    return get


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)],
                         ids=["1x2", "2x1", "2x2"])
def test_clip_step_matches_one_process(sharded, one_process, shape):
    got, ref = sharded(shape)["clip"], one_process["clip"]
    _assert_losses_close(got["loss"], ref["loss"])
    _assert_losses_close(got["grad_norm"], ref["grad_norm"])
    _assert_params_close(got["params"], ref["params"], LR["clip"])


def test_first_2x2_step_matches_jax(sharded, clip_jax):
    """The port's 2 × 2 step against JAX's SPMD step on a 2 × 2 mesh:
    the same weights, batch and optimizer, one step."""
    got = sharded((2, 2))["clip_first"]
    _assert_losses_close(got["loss"], [clip_jax["loss"]])
    _assert_params_close(got["params"], clip_jax["params"], LR["clip"],
                         steps=1)


@pytest.mark.parametrize("kind", list(_BATCHES))
def test_data_parallel_step_matches_one_process(sharded, one_process,
                                                kind):
    got, ref = sharded((2, 1))[kind], one_process[kind]
    _assert_losses_close(got["loss"], ref["loss"])
    # Adam's update hardly moves when every gradient is scaled alike, so
    # the gradient's norm is held too (a rank's whole loss instead of its
    # share, or a second all-reduce, scales it by n_data)
    _assert_losses_close(got["grad_norm"], ref["grad_norm"])
    _assert_params_close(got["params"], ref["params"], LR[kind])


def test_tp2_checkpoint_restores_in_one_process(sharded, one_process):
    """A state saved by the 1 × 2 run (sharded over ``model``) is whole on
    disk: one process restores it and holds the sharded run's weights."""
    got = sharded((1, 2))["clip"]
    state, _ = dryrun.tiny_trainer("clip", device="cpu")
    ttrain.restore_checkpoint(state, sharded.saved)
    assert state.step == STEPS and state.optimizer.count == STEPS
    for k, v in state.module.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), got["params"][k])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    line = dryrun.run_ranks(dryrun._dryrun_rank, n,
                            timeout=RANKS_TIMEOUT)[0]
    assert line.startswith(f"dryrun_multichip: {n} devices")
    assert f"backend gloo, rank 0 on cpu, serving on cpu ×{n}," in line
    assert "sharded-library top-5 identical" in line


@pytest.mark.parametrize("argv, env, error", [
    (["--n", "1"], {}, "ConfigurationError"),
    (["--n", "2", "--backend", "nccl"], {}, "SystemExit"),
    (["--backend", "gloo"], {"WORLD_SIZE": "2"}, "SystemExit")],
    ids=["nccl_by_default", "nccl_n2_needs_torchrun", "gloo_not_under_torchrun"])
def test_dryrun_cli_takes_the_card_unless_asked(argv, env, error,
                                                monkeypatch):
    """``python -m avede_tpu_torch.parallel.dryrun`` runs NCCL unless
    ``--backend gloo`` is given: without a card it raises instead of
    passing on CPU processes, and gloo refuses to run under torchrun."""
    from avede_tpu_torch.utils.errors import ConfigurationError

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("RANK", raising=False)
    expected = {"ConfigurationError": ConfigurationError,
                "SystemExit": SystemExit}[error]
    with pytest.raises(expected):
        dryrun.main(argv)


def test_a_hung_rank_fails_within_its_deadline():
    """A rank that never reaches the collective makes the run raise at
    its deadline, well before the ranks' own collective timeout
    (``COLLECTIVE_TIMEOUT_S``), instead of blocking the suite."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 5.0 s"):
        dryrun.run_ranks(_stall, 2, timeout=5.0)
    assert time.monotonic() - t0 < dryrun.COLLECTIVE_TIMEOUT_S / 2


def _stall(rank):
    import torch.distributed as dist

    if rank == 0:
        time.sleep(60)
    dist.barrier()
