"""The ported EfficientNet-B0 feature extractor against the JAX package:
the model at the tiny config (64 px) and at B0's full width (224 px) on
the same weights (carried across with ``params_from_jax``), the HF key
converter, ``imagenet_preprocess`` and the extractor reading a ``.npz``
the JAX package saved. Features within 1e-4 absolute with row cosines
>= 0.99999 (the extractor's, 1e-5); the converter exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_detection import _filled, _np

FEAT_TOL = 1e-5


def _effnet_variables(jcfg, size: int, seed: int = 0):
    from avede_tpu.models.effnet import EfficientNet as JEffNet

    model = JEffNet(jcfg)
    x = jnp.zeros((1, size, size, 3))
    return model, _np(_filled(lambda: model.init(jax.random.PRNGKey(0), x),
                              seed))


def _row_cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))).min())


@pytest.mark.parametrize("scale,size,batch", [("tiny", 64, 3),
                                              ("b0", 224, 2)])
def test_effnet_matches_jax(scale, size, batch):
    """The tiny config at 64 px, and B0 whole at 224 px: the stride-2
    TF-SAME padding, flax's BatchNorm epsilon with running statistics
    away from the identity, and the squeeze-excite widths."""
    from avede_tpu.models import effnet as jeffnet

    from avede_tpu_torch.models import effnet
    from avede_tpu_torch.models.convert import params_from_jax

    jcfg, cfg = ((jeffnet.tiny_effnet_config(), effnet.tiny_effnet_config())
                 if scale == "tiny" else (jeffnet.effnet_b0(),
                                          effnet.effnet_b0()))
    jm, variables = _effnet_variables(jcfg, size)
    model = effnet.EfficientNet(cfg)
    model.load_state_dict(params_from_jax(variables))
    x = np.random.default_rng(1).normal(size=(batch, size, size, 3)
                                        ).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (batch, cfg.feature_dim) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4
    assert _row_cosine(got, ref) >= 0.99999


def test_convert_effnet_state_dict_matches_jax(tmp_path):
    """A randomly initialised HF ``EfficientNetModel`` gives a state dict
    with HF's key names: the port's converter equals the JAX converter
    carried across by ``params_from_jax``, and a ``.npz`` the JAX
    package saves loads into the port's extractor."""
    transformers = pytest.importorskip("transformers")
    from avede_tpu.models import effnet as jeffnet
    from avede_tpu.models.convert import save_params
    from avede_tpu.services.background_independent import \
        EffNetExtractor as JExtractor

    from avede_tpu_torch.models import effnet
    from avede_tpu_torch.models.convert import params_from_jax
    from avede_tpu_torch.services.background_independent import \
        EffNetExtractor

    torch.manual_seed(0)
    hf = transformers.EfficientNetModel(transformers.EfficientNetConfig(
        width_coefficient=0.25, depth_coefficient=0.34, hidden_dim=320,
        image_size=64))
    sd = {k: v for k, v in hf.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    got = effnet.convert_effnet_state_dict(sd, effnet.tiny_effnet_config())
    jvars = jeffnet.convert_effnet_state_dict(sd,
                                              jeffnet.tiny_effnet_config())
    want = params_from_jax(_np(jvars))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    cfg = dataclasses.replace(effnet.tiny_effnet_config(), feature_dim=320)
    jcfg = dataclasses.replace(jeffnet.tiny_effnet_config(), feature_dim=320)
    effnet.EfficientNet(cfg).load_state_dict(got)       # strict: every key

    path = str(tmp_path / "effnet.npz")
    save_params(_np(jvars), path)
    rng = np.random.default_rng(4)
    crops = [rng.integers(0, 255, (60, 85, 3), dtype=np.uint8),
             rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)]
    ref = JExtractor(weights_path=path, cfg=jcfg,
                     image_size=64).embed_crops(crops)
    mine = EffNetExtractor(weights_path=path, cfg=cfg, image_size=64,
                           device="cpu").embed_crops(crops)
    assert mine.shape == (2, 320)
    assert np.abs(mine - ref).max() <= FEAT_TOL


@pytest.mark.parametrize("shape", [(1, 224, 224), (2, 96, 128),
                                   (1, 300, 180)])
def test_imagenet_preprocess_matches_jax(shape):
    from avede_tpu.ops.preprocess import imagenet_preprocess as jprep

    from avede_tpu_torch.ops.preprocess import imagenet_preprocess

    x = np.random.default_rng(sum(shape)).integers(0, 255, (*shape, 3),
                                                   dtype=np.uint8)
    ref = np.asarray(jprep(jnp.asarray(x), size=224))
    got = imagenet_preprocess(torch.from_numpy(x), size=224).numpy()
    assert got.shape == ref.shape == (shape[0], 224, 224, 3)
    assert np.abs(got - ref).max() <= 1e-4
