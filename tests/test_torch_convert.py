"""The port's Hugging Face weight converters and their command line,
against the JAX package's (``tools/convert_weights.py``,
``avede_tpu/models/convert.py``, ``owlvit.py``, ``yolo.py``).

Random ``transformers`` models are built from tiny configs and saved to
``tmp_path`` (nothing is downloaded). Both packages convert the same
checkpoint: the flat ``.npz`` archives must hold the same keys and
bit-equal arrays. The port's model on the loaded weights must then give
the JAX model's outputs within 1e-5 relative (f32, the same arithmetic
in another framework) and the HF model's within the tolerances of the
JAX package's own HF parity tests (``tests/test_convert_cli.py``,
``test_blip_parity.py``, ``test_detection_models.py``), which the port
inherits through the JAX model.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

REL = 1e-5


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_archives(a, b) -> None:
    fa, fb = _npz(a), _npz(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k], fb[k]), k


def _convert_both(kind, src, tmp_path):
    import convert_weights

    from avede_tpu_torch.models import convert as tconvert

    jax_out, port_out = tmp_path / f"{kind}_jax.npz", tmp_path / f"{kind}.npz"
    assert convert_weights.main(["--model", kind, "--src", str(src),
                                 "--out", str(jax_out)]) == 0
    assert tconvert.main(["--model", kind, "--src", str(src),
                          "--out", str(port_out)]) == 0
    return jax_out, port_out


# ---------------------------------------------------------------------------
# tiny random HF models
# ---------------------------------------------------------------------------

_CLIP_KW = dict(hidden_size=64, intermediate_size=256, num_hidden_layers=2,
                num_attention_heads=4)


def _hf_clip():
    from transformers import CLIPConfig as HFConfig
    from transformers import CLIPModel as HFModel

    cfg = HFConfig(
        text_config=dict(**_CLIP_KW, vocab_size=256,
                         max_position_embeddings=16,
                         hidden_act="quick_gelu", eos_token_id=255),
        vision_config=dict(**_CLIP_KW, image_size=32, patch_size=8,
                           hidden_act="quick_gelu"),
        projection_dim=32)
    torch.manual_seed(0)
    return HFModel(cfg).eval()


def _hf_blip():
    from transformers import BlipConfig as HFConfig
    from transformers import BlipForConditionalGeneration as HFModel

    cfg = HFConfig(
        vision_config=dict(hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8),
        text_config=dict(hidden_size=64, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=4,
                         vocab_size=100, max_position_embeddings=32,
                         encoder_hidden_size=64, bos_token_id=98,
                         sep_token_id=99, pad_token_id=0))
    torch.manual_seed(0)
    return HFModel(cfg).eval()


def _hf_owlvit():
    from transformers import OwlViTConfig as HFConfig
    from transformers import OwlViTForObjectDetection as HFModel

    cfg = HFConfig(
        vision_config=dict(hidden_size=64, intermediate_size=256,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8),
        text_config=dict(hidden_size=64, intermediate_size=256,
                         num_hidden_layers=2, num_attention_heads=4,
                         vocab_size=100, max_position_embeddings=8),
        projection_dim=64)
    torch.manual_seed(0)
    return HFModel(cfg).eval()


_HF = {"clip": _hf_clip, "blip": _hf_blip, "owlvit": _hf_owlvit}


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """kind → (HF model, snapshot directory)."""
    root = tmp_path_factory.mktemp("hf")
    out = {}
    for kind, make in _HF.items():
        hf = make()
        hf.save_pretrained(root / kind, safe_serialization=False)
        out[kind] = (hf, root / kind)
    return out


# ---------------------------------------------------------------------------
# the archives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["clip", "blip", "owlvit"])
def test_archive_equals_the_jax_tools(kind, snapshots, tmp_path):
    """``python -m avede_tpu_torch.models.convert`` writes, key for key,
    the arrays ``tools/convert_weights.py`` writes."""
    _same_archives(*_convert_both(kind, snapshots[kind][1], tmp_path))


@pytest.mark.parametrize("kind", ["clip", "blip", "owlvit"])
def test_converter_trees_equal_jax(kind, snapshots):
    """The converter functions themselves return JAX's nested trees."""
    from avede_tpu.models import convert as jconvert
    from avede_tpu.models import owlvit as jowl

    from avede_tpu_torch.models import convert as tconvert
    from avede_tpu_torch.models import owlvit as towl

    sd = snapshots[kind][0].state_dict()
    fns = {"clip": (jconvert.convert_clip_state_dict,
                    tconvert.convert_clip_state_dict),
           "blip": (jconvert.convert_blip_state_dict,
                    tconvert.convert_blip_state_dict),
           "owlvit": (jowl.convert_owlvit_state_dict,
                      towl.convert_owlvit_state_dict)}[kind]
    ref = jconvert.flatten_params(fns[0](sd, 2, 2))
    got = tconvert.flatten_params(fns[1](sd, 2, 2))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], ref[k])


# ---------------------------------------------------------------------------
# models on the converted weights
# ---------------------------------------------------------------------------

def test_clip_on_converted_weights(snapshots, tmp_path):
    from avede_tpu.models.clip import CLIPModel as JaxCLIP
    from avede_tpu.models.clip import tiny_test_config as jax_tiny
    from avede_tpu.models.convert import load_params as jax_load

    from avede_tpu_torch.models.clip import CLIPModel, tiny_test_config
    from avede_tpu_torch.models.convert import load_params

    hf, src = snapshots["clip"]
    jax_file, port_file = _convert_both("clip", src, tmp_path)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 200, size=(3, 16)).astype(np.int64)
    ids[:, 9] = 255                       # the EOS (largest id) pools here

    model = CLIPModel(tiny_test_config()).eval()
    model.load_state_dict(load_params(str(port_file)))
    with torch.no_grad():
        img = model.encode_image(torch.from_numpy(x)).numpy()
        txt = model.encode_text(torch.from_numpy(ids)).numpy()
        ref_img = hf.get_image_features(
            torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        ref_txt = hf.get_text_features(torch.from_numpy(ids)).numpy()
    jm = JaxCLIP(jax_tiny())
    jp = {"params": jax_load(str(jax_file))}
    jimg = np.asarray(jm.apply(jp, x, method=jm.encode_image))
    jtxt = np.asarray(jm.apply(jp, ids.astype(np.int32),
                               method=jm.encode_text))
    assert _rel(img, jimg) <= REL and _rel(txt, jtxt) <= REL
    # HF returns unnormalised features; both packages unit-normalise
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa
    assert _rel(img, unit(ref_img)) <= REL
    assert _rel(txt, unit(ref_txt)) <= REL


def test_blip_on_converted_weights(snapshots, tmp_path):
    from avede_tpu.models.blip import BlipCaptioner as JaxBlip
    from avede_tpu.models.blip import tiny_blip_config as jax_tiny
    from avede_tpu.models.convert import load_params as jax_load

    from avede_tpu_torch.models.blip import BlipCaptioner, tiny_blip_config
    from avede_tpu_torch.models.convert import load_params

    hf, src = snapshots["blip"]
    jax_file, port_file = _convert_both("blip", src, tmp_path)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 90, size=(2, 6)).astype(np.int64)
    ids[:, 0] = 98

    model = BlipCaptioner(tiny_blip_config()).eval()
    model.load_state_dict(load_params(str(port_file)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(ids)).numpy()
        ref = hf(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2)),
                 input_ids=torch.from_numpy(ids)).logits.numpy()
    jm = JaxBlip(jax_tiny())
    jgot = np.asarray(jm.apply({"params": jax_load(str(jax_file))}, x,
                               ids.astype(np.int32)))
    assert _rel(got, jgot) <= REL
    # the JAX package's HF bar (tests/test_blip_parity.py)
    np.testing.assert_allclose(got, ref, atol=3e-4)


def test_owlvit_on_converted_weights(snapshots, tmp_path):
    from avede_tpu.models.convert import load_params as jax_load
    from avede_tpu.models.owlvit import OwlViTDetector as JaxOwl
    from avede_tpu.models.owlvit import tiny_owlvit_config as jax_tiny

    from avede_tpu_torch.models.convert import load_params
    from avede_tpu_torch.models.owlvit import (OwlViTDetector,
                                               tiny_owlvit_config)

    hf, src = snapshots["owlvit"]
    jax_file, port_file = _convert_both("owlvit", src, tmp_path)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 90, size=(3, 8)).astype(np.int64)
    ids[:, -1] = 99

    model = OwlViTDetector(tiny_owlvit_config()).eval()
    model.load_state_dict(load_params(str(port_file)))
    with torch.no_grad():
        logits, boxes = model(torch.from_numpy(x), torch.from_numpy(ids))
        out = hf(input_ids=torch.from_numpy(ids),
                 pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2)),
                 attention_mask=torch.ones(3, 8, dtype=torch.long))
    jm = JaxOwl(jax_tiny())
    jl, jb = jm.apply({"params": jax_load(str(jax_file))}, x,
                      ids.astype(np.int32))
    assert _rel(logits.numpy(), jl) <= REL and _rel(boxes.numpy(), jb) <= REL
    # the JAX package's HF bars (tests/test_detection_models.py)
    np.testing.assert_allclose(boxes.numpy(), out.pred_boxes.numpy(),
                               atol=3e-4)
    np.testing.assert_allclose(logits.numpy(), out.logits.numpy(),
                               atol=3e-3)


# ---------------------------------------------------------------------------
# YOLOv8 from an ultralytics-named state dict
# ---------------------------------------------------------------------------

def _ultralytics_state_dict(seed: int = 0):
    """A random state dict under ultralytics' YOLOv8 names (``model.<i>.
    ...``), shaped as the tiny config's layers: the port's module names
    mapped back (ultralytics is not installed)."""
    from avede_tpu_torch.models.yolo import (_UL_BACKBONE, init_yolo,
                                             tiny_yolo_config)

    back = {v: k for k, v in _UL_BACKBONE.items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for key, t in init_yolo(tiny_yolo_config()).state_dict().items():
        parts = key.split(".")
        head = parts[0]
        if head.startswith("head_"):
            _, kind, lvl, j = head.split("_")
            parts[:1] = ["model", "22", "cv2" if kind == "box" else "cv3",
                         lvl, j]
        else:
            parts[:1] = ["model", str(back[head])]
        parts = [p.replace("m_", "m.") if p.startswith("m_") else p
                 for p in parts]
        v = rng.normal(0, 0.1, t.shape).astype(np.float32)
        if parts[-1] == "running_var":
            v = np.abs(v) + 0.5
        sd[".".join(".".join(parts).split("."))] = v
    return sd


def test_yolov8_conversion_equals_jax():
    from avede_tpu.models.yolo import YoloV8 as JaxYolo
    from avede_tpu.models.yolo import convert_yolov8_state_dict as jconvert
    from avede_tpu.models.yolo import tiny_yolo_config as jax_tiny

    from avede_tpu_torch.models.convert import (flatten_params,
                                                params_from_jax)
    from avede_tpu_torch.models.yolo import (YoloV8,
                                             convert_yolov8_state_dict,
                                             tiny_yolo_config)

    sd = _ultralytics_state_dict()
    params, stats = convert_yolov8_state_dict(sd, tiny_yolo_config())
    jparams, jstats = jconvert(sd, jax_tiny())
    for got, ref in ((params, jparams), (stats, jstats)):
        got, ref = flatten_params(got), flatten_params(ref)
        assert sorted(got) == sorted(ref)
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    # torch tensors convert to the same trees
    tparams, _ = convert_yolov8_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, tiny_yolo_config())
    assert all(np.array_equal(a, b) for a, b in zip(
        flatten_params(tparams).values(), flatten_params(params).values()))

    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)
                                         ).astype(np.float32)
    model = YoloV8(tiny_yolo_config()).eval()
    model.load_state_dict(params_from_jax({"params": params,
                                           "batch_stats": stats}))
    with torch.no_grad():
        outs = model(torch.from_numpy(x))
    jouts = JaxYolo(jax_tiny()).apply({"params": jparams,
                                       "batch_stats": jstats}, x)
    for (box, cls), (jbox, jcls) in zip(outs, jouts):
        assert _rel(box.numpy(), jbox) <= REL
        assert _rel(cls.numpy(), jcls) <= REL


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def test_cli_torch_save_file_without_transformers(snapshots, tmp_path,
                                                  monkeypatch):
    """A ``torch.save`` state dict needs torch only: the CLI converts it
    with ``transformers`` unimportable, in process and as
    ``python -m avede_tpu_torch.models.convert``, to the JAX tool's
    archive."""
    import convert_weights

    from avede_tpu_torch.models import convert as tconvert

    hf, _ = snapshots["clip"]
    src = tmp_path / "clip.pt"
    torch.save({"state_dict": hf.state_dict()}, src)
    ref = tmp_path / "ref.npz"
    assert convert_weights.main(["--model", "clip", "--src", str(src),
                                 "--out", str(ref)]) == 0

    monkeypatch.setitem(sys.modules, "transformers", None)
    out = tmp_path / "in_process.npz"
    assert tconvert.main(["--model", "clip", "--src", str(src),
                          "--out", str(out)]) == 0
    _same_archives(out, ref)

    block = tmp_path / "block"
    block.mkdir()
    (block / "transformers.py").write_text(
        "raise ImportError('transformers is not installed here')\n")
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(block), str(ROOT)])}
    out = tmp_path / "cli.npz"
    res = subprocess.run(
        [sys.executable, "-m", "avede_tpu_torch.models.convert", "--model",
         "clip", "--src", str(src), "--out", str(out)], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "point settings.CLIP_WEIGHTS (env var CLIP_WEIGHTS) at it" \
        in res.stdout
    assert res.stdout.startswith(f"wrote {out} (")
    _same_archives(out, ref)


def test_convert_torch_checkpoint_equals_jax(snapshots, tmp_path):
    from avede_tpu.models import convert as jconvert

    from avede_tpu_torch.models import convert as tconvert

    src = tmp_path / "clip.pt"
    torch.save(snapshots["clip"][0].state_dict(), src)
    got = tconvert.flatten_params(tconvert.convert_torch_checkpoint(str(src)))
    ref = jconvert.flatten_params(jconvert.convert_torch_checkpoint(str(src)))
    assert sorted(got) == sorted(ref)
    assert all(np.array_equal(got[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="unknown checkpoint kind"):
        tconvert.convert_torch_checkpoint(str(src), kind="blip")


def test_cli_kinds_and_unknown_kind():
    import convert_weights

    from avede_tpu_torch.models import convert as tconvert

    assert tconvert.KNOBS == convert_weights.KNOBS
    assert tconvert.HF_CLASSES == convert_weights.HF_CLASSES
    with pytest.raises(SystemExit):
        tconvert.main(["--model", "nope", "--src", "x", "--out", "y"])
    with pytest.raises(ValueError, match="unknown model kind"):
        tconvert.convert("yolo", {})
    with pytest.raises(ValueError, match="no layers matching"):
        tconvert.convert("clip", {"logit_scale": np.zeros(())})


def test_cli_efficientnet_file_equals_jax(tmp_path):
    """EfficientNet-B0's HF state dict through both CLIs (the port's
    converter renames into its own model; the archive is written in the
    JAX layout, ``params/`` and ``batch_stats/``)."""
    from transformers import EfficientNetConfig, EfficientNetModel

    from avede_tpu_torch.models.convert import load_params
    from avede_tpu_torch.models.effnet import EfficientNet, effnet_b0

    torch.manual_seed(0)
    hf = EfficientNetModel(EfficientNetConfig(   # B0 (the default is B7)
        width_coefficient=1.0, depth_coefficient=1.0, hidden_dim=1280,
        image_size=224))
    src = tmp_path / "effnet.pt"
    torch.save(hf.state_dict(), src)
    jax_out, port_out = _convert_both("efficientnet", src, tmp_path)
    _same_archives(jax_out, port_out)
    EfficientNet(effnet_b0()).load_state_dict(load_params(str(port_out)))


def test_cli_blip2_file_equals_jax(tmp_path, monkeypatch):
    """BLIP-2's HF state dict through both CLIs at the default widths,
    depth cut to one vision and one Q-Former layer (a random state dict
    under HF's names and shapes: ``Blip2ForImageTextRetrieval`` at
    ViT-g width is too large to build here)."""
    from avede_tpu_torch.models.qformer import QFormerConfig

    cfg = QFormerConfig(vision_depth=1, depth=1)
    sd = _hf_blip2_state_dict(cfg)
    src = tmp_path / "blip2.pt"
    torch.save(sd, src)
    _same_archives(*_convert_both("blip2", src, tmp_path))


def _hf_blip2_state_dict(cfg):
    """HF ``Blip2ForImageTextRetrieval`` key names and shapes for
    ``cfg``, random values (the inverse of ``convert_blip2_state_dict``'s
    renaming, over the port model's own shapes)."""
    from avede_tpu_torch.models.qformer import Blip2Retrieval

    with torch.device("meta"):
        model = Blip2Retrieval(cfg)
    rng = np.random.default_rng(0)
    sd = {}

    def put(src, dst):
        for leaf in ("weight", "bias"):
            shape = model.state_dict()[f"{dst}.{leaf}"].shape
            sd[f"{src}.{leaf}"] = torch.from_numpy(
                rng.normal(0, 0.02, shape).astype(np.float32))

    emb = "vision_model.embeddings"
    put(f"{emb}.patch_embedding", "vision.patch_embedding")
    msd = model.state_dict()
    sd[f"{emb}.class_embedding"] = torch.zeros(
        (1, 1) + tuple(msd["vision.class_embedding"].shape))
    sd[f"{emb}.position_embedding"] = torch.zeros(
        (1,) + tuple(msd["vision.position_embedding"].shape))
    for i in range(cfg.vision_depth):
        s, d = f"vision_model.encoder.layers.{i}", f"vision.layers.{i}"
        put(f"{s}.self_attn.qkv", f"{d}.qkv")
        put(f"{s}.self_attn.projection", f"{d}.projection")
        for ln in ("layer_norm1", "layer_norm2"):
            put(f"{s}.{ln}", f"{d}.{ln}")
        for fc in ("fc1", "fc2"):
            put(f"{s}.mlp.{fc}", f"{d}.{fc}")
    put("vision_model.post_layernorm", "vision.post_layernorm")
    sd["query_tokens"] = torch.zeros((1,) + tuple(msd["query_tokens"].shape))
    sd["embeddings.word_embeddings.weight"] = torch.zeros(
        msd["word_embeddings"].shape)
    sd["embeddings.position_embeddings.weight"] = torch.zeros(
        msd["position_embeddings"].shape)
    put("qformer.layernorm", "qformer.input_ln")
    for i in range(cfg.depth):
        s, d = f"qformer.encoder.layer.{i}", f"qformer.layers.{i}"
        for proj in ("query", "key", "value"):
            put(f"{s}.attention.attention.{proj}", f"{d}.self_attn.{proj}")
            put(f"{s}.crossattention.attention.{proj}",
                f"{d}.cross_attn.{proj}")
        put(f"{s}.attention.output.dense", f"{d}.self_output")
        put(f"{s}.attention.output.LayerNorm", f"{d}.self_ln")
        put(f"{s}.crossattention.output.dense", f"{d}.cross_output")
        put(f"{s}.crossattention.output.LayerNorm", f"{d}.cross_ln")
        for part in ("intermediate_query", "intermediate"):
            put(f"{s}.{part}.dense", f"{d}.{part}")
        for part in ("output_query", "output"):
            put(f"{s}.{part}.dense", f"{d}.{part}")
            put(f"{s}.{part}.LayerNorm", f"{d}.{part}_ln")
    for name in ("vision_projection", "text_projection", "itm_head"):
        put(name, name)
    return sd


def test_hf_clip_generator_matches_transformers():
    """``chip_smoke.hf_clip_state_dict`` (the card's random HF-named
    ViT-B/32, made without ``transformers``) has ``CLIPModel``'s key set
    and shapes, here at a tiny width."""
    import chip_smoke
    from transformers import CLIPConfig as HFConfig
    from transformers import CLIPModel as HFModel

    from avede_tpu_torch.models.clip import CLIPConfig

    cfg = CLIPConfig(image_size=32, patch_size=8, vision_dim=64,
                     vision_depth=2, vision_heads=4, text_dim=48,
                     text_depth=3, text_heads=4, vocab_size=256,
                     max_text_len=16, projection_dim=32)
    hf = HFModel(HFConfig(
        text_config=dict(hidden_size=48, intermediate_size=192,
                         num_hidden_layers=3, num_attention_heads=4,
                         vocab_size=256, max_position_embeddings=16),
        vision_config=dict(hidden_size=64, intermediate_size=256,
                           num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8),
        projection_dim=32))
    ref = {k: tuple(v.shape) for k, v in hf.state_dict().items()}
    got = {k: tuple(v.shape)
           for k, v in chip_smoke.hf_clip_state_dict(torch, cfg).items()}
    assert got == ref
