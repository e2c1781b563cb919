"""Weight bridge from the JAX package's parameters (counterpart of
``avede_tpu/models/convert.py``).

``params_from_jax`` turns a Flax parameter tree (nested mappings of
arrays) into a state dict for the port's models (``models/clip.py``,
``models/blip.py``, ``models/univtg.py``, ``models/owlvit.py``,
``models/yolo.py``); given a whole Flax variables dict (``{"params":
..., "batch_stats": ...}``, as YOLO's BatchNorm has) it carries the
running statistics too. ``load_params`` reads
the flat slash-joined ``.npz`` that ``avede_tpu.models.convert.
save_params`` writes, so both packages can serve one weight file;
``save_params`` writes a port model's weights in that layout;
``train_state_from_jax`` carries an optax Adam state across with them.

Mapping, per leaf: path parts join with ``.`` and ``layers_<i>``
becomes ``layers.<i>``; a 2-D Dense ``kernel [in, out]`` becomes
``weight [out, in]``; a 4-D conv ``kernel`` in HWIO becomes OIHW;
LayerNorm and BatchNorm ``scale`` and Embed ``embedding`` become
``weight``; BatchNorm statistics ``mean`` and ``var`` (``batch_stats``)
become ``running_mean`` and ``running_var``; every other leaf keeps its
name.

Hugging Face checkpoints come in without JAX: ``convert_clip_state_dict``
and ``convert_blip_state_dict`` (here), ``convert_owlvit_state_dict``
(``models/owlvit.py``) and ``convert_yolov8_state_dict``
(``models/yolo.py``) return the JAX package's nested numpy trees, array
for array, and ``save_param_tree`` writes one as its flat ``.npz``, so
either package's ``load_params`` reads the file. The command line twin
of ``tools/convert_weights.py`` (same kinds, settings knobs and
messages)::

    python -m avede_tpu_torch.models.convert --model clip \
        --src <HF snapshot dir or torch state-dict file> --out clip.npz

A snapshot directory needs ``transformers``; a ``torch.save`` file needs
torch alone (a ``.safetensors`` file, ``safetensors``).
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn


def flatten_params(tree: Mapping[str, Any], prefix: str = ""
                   ) -> Dict[str, np.ndarray]:
    """Nested mappings → {slash-joined path: array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_params(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_params(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """{slash-joined path: array} → nested mappings."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        _set(tree, path, np.asarray(v))
    return tree


_STATS = {"mean": "running_mean", "var": "running_var"}


def _key_and_value(path: str, value: np.ndarray, stats: bool = False):
    parts = [re.sub(r"^layers_(\d+)$", r"layers.\1", p)
             for p in path.split("/")]
    leaf = parts[-1]
    if stats:
        parts[-1] = _STATS.get(leaf, leaf)
        return ".".join(parts), value
    if leaf == "kernel":
        parts[-1] = "weight"
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
    elif leaf in ("scale", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts), value


def params_from_flat(flat: Mapping[str, np.ndarray], stats: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """{slash-joined path: array} → port state dict (f32 tensors);
    ``stats``: the paths are a ``batch_stats`` collection's."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key, v = _key_and_value(path, np.asarray(value, np.float32), stats)
        sd[key] = torch.from_numpy(np.array(v, np.float32, order="C"))
    return sd


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree of arrays, or a variables dict holding
    ``params`` and ``batch_stats``, → port state dict."""
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        sd = params_from_flat(flatten_params(tree["params"]))
        sd.update(params_from_flat(
            flatten_params(tree.get("batch_stats", {})), stats=True))
        return sd
    return params_from_flat(flatten_params(tree))


def _adam_state(node: Any):
    """The ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) inside an
    optax state: a tuple of transformation states, nested by ``chain``."""
    if all(hasattr(node, a) for a in ("count", "mu", "nu")):
        return node
    for child in node if isinstance(node, tuple) else ():
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def train_state_from_jax(params: Mapping[str, Any], opt_state: Any,
                         step: int) -> Dict[str, Any]:
    """A JAX train state (a Flax parameter tree and an optax ``adamw``
    or ``chain(clip_by_global_norm, adamw)`` state, as numpy trees) →
    the port's ``TrainState.state_dict()`` layout (``parallel/train.py``):
    ``{"params", "opt_state": {"count", "mu", "nu"}, "step"}``. The
    moments take the parameters' key mapping and transposes; optax's
    update count becomes ``count``."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    return {"params": params_from_jax(params),
            "opt_state": {"count": int(np.asarray(adam.count)),
                          "mu": params_from_jax(adam.mu),
                          "nu": params_from_jax(adam.nu)},
            "step": int(np.asarray(step))}


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read a flat slash-joined ``.npz`` (the JAX package's format); a
    file of a whole variables dict (every path under ``params/`` or
    ``batch_stats/``) carries the running statistics too."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    cols: Dict[str, Dict[str, np.ndarray]] = {"params": {},
                                              "batch_stats": {}}
    for key, value in flat.items():
        head, _, rest = key.partition("/")
        if head not in cols or not rest:
            return params_from_flat(flat)
        cols[head][rest] = value
    sd = params_from_flat(cols["params"])
    sd.update(params_from_flat(cols["batch_stats"], stats=True))
    return sd


def _jax_parts(key: str) -> List[str]:
    """``a.layers.3.b`` → ``["a", "layers_3", "b"]``."""
    parts, out = key.split("."), []
    i = 0
    while i < len(parts):
        if parts[i] == "layers" and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            out.append(f"layers_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    return out


def _flax_flat(model: nn.Module,
               state_dict: Optional[Mapping[str, torch.Tensor]] = None
               ) -> Dict[str, np.ndarray]:
    """A port model's weights (``state_dict``, else the model's own) in
    the JAX package's flat layout; ``model`` gives only the module types
    (it may live on the meta device)."""
    owners = dict(model.named_modules())
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    sd = model.state_dict() if state_dict is None else state_dict
    for key, t in sd.items():
        owner_name, _, leaf = key.rpartition(".")
        v = t.detach().float().cpu().numpy()
        parts = _jax_parts(owner_name) if owner_name else []
        if leaf in ("running_mean", "running_var"):
            stats["/".join(parts + [leaf[len("running_"):]])] = v
            continue
        if leaf == "num_batches_tracked":
            continue
        if leaf == "weight":
            if isinstance(owners.get(owner_name), nn.Embedding):
                leaf = "embedding"
            elif v.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                v = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        params["/".join(parts + [leaf])] = np.ascontiguousarray(v)
    if stats:
        params = {**{f"params/{k}": v for k, v in params.items()},
                  **{f"batch_stats/{k}": v for k, v in stats.items()}}
    return params


def save_params(model: nn.Module, path: str) -> None:
    """Write a port model's weights as the JAX package's flat ``.npz``,
    which both packages' ``load_params`` read (its inverse): Dense and
    conv ``weight`` → ``kernel`` ([in, out], HWIO), norm ``weight`` →
    ``scale``, ``nn.Embedding``'s → ``embedding``; BatchNorm
    ``running_mean`` / ``running_var`` → ``batch_stats/…/mean`` / ``var``
    beside ``params/…`` (the layout of a saved Flax variables dict).
    The archive is stored, not deflated (the JAX package deflates):
    trained f32 weights hardly compress, and deflating ViT-B/32's
    600 MB takes about half a minute."""
    np.savez(path, **_flax_flat(model))


def save_param_tree(tree: Mapping[str, Any], path: str) -> None:
    """Write a nested tree of arrays (a converter's output, or a Flax
    variables dict) as the JAX package's flat slash-joined ``.npz`` (the
    tree writer of ``avede_tpu/models/convert.py:237``; stored, not
    deflated, as ``save_params``)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    np.savez(path, **flatten_params(tree))


# ---------------------------------------------------------------------------
# Hugging Face checkpoints → the JAX package's parameter trees
# ---------------------------------------------------------------------------

def _set(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _np(t: Any) -> np.ndarray:
    """A checkpoint tensor (or array) as f32 numpy."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        t = t.float() if t.is_floating_point() else t
        t = t.numpy()
    return np.asarray(t, dtype=np.float32)


def _convert_encoder_layers(sd: Mapping[str, Any], tree: Dict[str, Any],
                            src_prefix: str, dst_prefix: str,
                            depth: int) -> None:
    """HF CLIP-style encoder layers → the ``Transformer`` tree naming."""
    for i in range(depth):
        s = f"{src_prefix}.layers.{i}"
        d = f"{dst_prefix}/layers_{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _set(tree, f"{d}/self_attn/{proj}/kernel",
                 _np(sd[f"{s}.self_attn.{proj}.weight"]).T)
            _set(tree, f"{d}/self_attn/{proj}/bias",
                 _np(sd[f"{s}.self_attn.{proj}.bias"]))
        for ln in ("layer_norm1", "layer_norm2"):
            _set(tree, f"{d}/{ln}/scale", _np(sd[f"{s}.{ln}.weight"]))
            _set(tree, f"{d}/{ln}/bias", _np(sd[f"{s}.{ln}.bias"]))
        for fc in ("fc1", "fc2"):
            _set(tree, f"{d}/mlp/{fc}/kernel",
                 _np(sd[f"{s}.mlp.{fc}.weight"]).T)
            _set(tree, f"{d}/mlp/{fc}/bias", _np(sd[f"{s}.mlp.{fc}.bias"]))


def convert_clip_state_dict(sd: Mapping[str, Any], vision_depth: int = 12,
                            text_depth: int = 12) -> Dict[str, Any]:
    """HF ``CLIPModel`` state dict → the CLIP parameter tree
    (``avede_tpu/models/convert.py:67``); the pre-layernorm key takes
    HF's historic ``pre_layrnorm`` spelling and the fixed one."""
    p: Dict[str, Any] = {}
    _set(p, "vision/patch_embedding/kernel",
         _np(sd["vision_model.embeddings.patch_embedding.weight"]
             ).transpose(2, 3, 1, 0))
    _set(p, "vision/class_embedding",
         _np(sd["vision_model.embeddings.class_embedding"]).reshape(-1))
    _set(p, "vision/position_embedding",
         _np(sd["vision_model.embeddings.position_embedding.weight"]))
    pre_key = ("vision_model.pre_layrnorm.weight"
               if "vision_model.pre_layrnorm.weight" in sd
               else "vision_model.pre_layernorm.weight")
    _set(p, "vision/pre_layernorm/scale", _np(sd[pre_key]))
    _set(p, "vision/pre_layernorm/bias",
         _np(sd[pre_key.replace("weight", "bias")]))
    _convert_encoder_layers(sd, p, "vision_model.encoder", "vision/encoder",
                            vision_depth)
    _set(p, "vision/post_layernorm/scale",
         _np(sd["vision_model.post_layernorm.weight"]))
    _set(p, "vision/post_layernorm/bias",
         _np(sd["vision_model.post_layernorm.bias"]))
    _set(p, "vision/projection/kernel", _np(sd["visual_projection.weight"]).T)

    _set(p, "text/token_embedding/embedding",
         _np(sd["text_model.embeddings.token_embedding.weight"]))
    _set(p, "text/position_embedding",
         _np(sd["text_model.embeddings.position_embedding.weight"]))
    _convert_encoder_layers(sd, p, "text_model.encoder", "text/encoder",
                            text_depth)
    _set(p, "text/final_layer_norm/scale",
         _np(sd["text_model.final_layer_norm.weight"]))
    _set(p, "text/final_layer_norm/bias",
         _np(sd["text_model.final_layer_norm.bias"]))
    _set(p, "text/projection/kernel", _np(sd["text_projection.weight"]).T)

    _set(p, "logit_scale", _np(sd["logit_scale"]).reshape(()))
    return p


def convert_blip_state_dict(sd: Mapping[str, Any], vision_depth: int = 12,
                            text_depth: int = 12) -> Dict[str, Any]:
    """HF ``BlipForConditionalGeneration`` state dict → the BLIP
    captioner's parameter tree (``avede_tpu/models/convert.py:121``)."""
    p: Dict[str, Any] = {}
    _set(p, "vision/patch_embedding/kernel",
         _np(sd["vision_model.embeddings.patch_embedding.weight"]
             ).transpose(2, 3, 1, 0))
    _set(p, "vision/patch_embedding/bias",
         _np(sd["vision_model.embeddings.patch_embedding.bias"]))
    _set(p, "vision/class_embedding",
         _np(sd["vision_model.embeddings.class_embedding"]).reshape(-1))
    _set(p, "vision/position_embedding",
         _np(sd["vision_model.embeddings.position_embedding"])[0])
    for i in range(vision_depth):
        s = f"vision_model.encoder.layers.{i}"
        d = f"vision/layers_{i}"
        _set(p, f"{d}/qkv/kernel", _np(sd[f"{s}.self_attn.qkv.weight"]).T)
        _set(p, f"{d}/qkv/bias", _np(sd[f"{s}.self_attn.qkv.bias"]))
        _set(p, f"{d}/projection/kernel",
             _np(sd[f"{s}.self_attn.projection.weight"]).T)
        _set(p, f"{d}/projection/bias",
             _np(sd[f"{s}.self_attn.projection.bias"]))
        for ln in ("layer_norm1", "layer_norm2"):
            _set(p, f"{d}/{ln}/scale", _np(sd[f"{s}.{ln}.weight"]))
            _set(p, f"{d}/{ln}/bias", _np(sd[f"{s}.{ln}.bias"]))
        for fc in ("fc1", "fc2"):
            _set(p, f"{d}/{fc}/kernel", _np(sd[f"{s}.mlp.{fc}.weight"]).T)
            _set(p, f"{d}/{fc}/bias", _np(sd[f"{s}.mlp.{fc}.bias"]))
    _set(p, "vision/post_layernorm/scale",
         _np(sd["vision_model.post_layernorm.weight"]))
    _set(p, "vision/post_layernorm/bias",
         _np(sd["vision_model.post_layernorm.bias"]))

    tb = "text_decoder.bert"
    _set(p, "text/word_embeddings",
         _np(sd[f"{tb}.embeddings.word_embeddings.weight"]))
    _set(p, "text/position_embeddings",
         _np(sd[f"{tb}.embeddings.position_embeddings.weight"]))
    _set(p, "text/embed_ln/scale",
         _np(sd[f"{tb}.embeddings.LayerNorm.weight"]))
    _set(p, "text/embed_ln/bias", _np(sd[f"{tb}.embeddings.LayerNorm.bias"]))
    for i in range(text_depth):
        s = f"{tb}.encoder.layer.{i}"
        d = f"text/layers_{i}"
        for src, dst in (("attention", "self_attn"),
                         ("crossattention", "cross_attn")):
            for proj in ("query", "key", "value"):
                _set(p, f"{d}/{dst}/{proj}/kernel",
                     _np(sd[f"{s}.{src}.self.{proj}.weight"]).T)
                _set(p, f"{d}/{dst}/{proj}/bias",
                     _np(sd[f"{s}.{src}.self.{proj}.bias"]))
        for src, dst in (("attention.output.dense", "self_output"),
                         ("crossattention.output.dense", "cross_output"),
                         ("intermediate.dense", "intermediate"),
                         ("output.dense", "output")):
            _set(p, f"{d}/{dst}/kernel", _np(sd[f"{s}.{src}.weight"]).T)
            _set(p, f"{d}/{dst}/bias", _np(sd[f"{s}.{src}.bias"]))
        for src, dst in (("attention.output.LayerNorm", "self_ln"),
                         ("crossattention.output.LayerNorm", "cross_ln"),
                         ("output.LayerNorm", "output_ln")):
            _set(p, f"{d}/{dst}/scale", _np(sd[f"{s}.{src}.weight"]))
            _set(p, f"{d}/{dst}/bias", _np(sd[f"{s}.{src}.bias"]))
    cls = "text_decoder.cls.predictions"
    _set(p, "text/transform/kernel", _np(sd[f"{cls}.transform.dense.weight"]).T)
    _set(p, "text/transform/bias", _np(sd[f"{cls}.transform.dense.bias"]))
    _set(p, "text/transform_ln/scale",
         _np(sd[f"{cls}.transform.LayerNorm.weight"]))
    _set(p, "text/transform_ln/bias",
         _np(sd[f"{cls}.transform.LayerNorm.bias"]))
    _set(p, "text/decoder/kernel", _np(sd[f"{cls}.decoder.weight"]).T)
    _set(p, "text/decoder/bias", _np(sd[f"{cls}.decoder.bias"]))
    return p


def _depth(sd: Mapping[str, Any], pattern: str) -> int:
    """Layers in a checkpoint: 1 + the largest index ``pattern``'s group
    matches."""
    idx = [int(m.group(1)) for k in sd if (m := re.match(pattern, k))]
    if not idx:
        raise ValueError(f"no layers matching {pattern!r} in checkpoint")
    return 1 + max(idx)


def convert_torch_checkpoint(path: str, kind: str = "clip"
                             ) -> Dict[str, Any]:
    """Load a torch checkpoint file and convert it by model kind
    (``avede_tpu/models/convert.py:248``; ``clip`` only, as there)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if kind == "clip":
        return convert_clip_state_dict(
            sd, _depth(sd, r"vision_model\.encoder\.layers\.(\d+)\."),
            _depth(sd, r"text_model\.encoder\.layers\.(\d+)\."))
    raise ValueError(f"unknown checkpoint kind: {kind}")


# ---------------------------------------------------------------------------
# command line: the twin of tools/convert_weights.py
# ---------------------------------------------------------------------------

KNOBS = {
    "clip": "CLIP_WEIGHTS",
    "blip": "BLIP_WEIGHTS",
    "blip2": "BLIP_WEIGHTS",
    "owlvit": "OWLVIT_WEIGHTS",
    "efficientnet": "FEATURE_EXTRACTOR_WEIGHTS",
}

HF_CLASSES = {
    "clip": "CLIPModel",
    "blip": "BlipForConditionalGeneration",
    "blip2": "Blip2ForImageTextRetrieval",
    "owlvit": "OwlViTForObjectDetection",
    "efficientnet": "EfficientNetModel",
}


def load_state_dict(src: str, model: str) -> Mapping[str, Any]:
    """A HF snapshot directory (``from_pretrained``: needs
    ``transformers``), a ``.safetensors`` file or a ``torch.save`` state
    dict (a ``{"state_dict": ...}`` wrapper is opened)."""
    if os.path.isdir(src):
        import transformers

        cls = getattr(transformers, HF_CLASSES[model])
        return cls.from_pretrained(src).state_dict()
    if src.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(src)
    sd = torch.load(src, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd


def _port_tree(model_cls, cfg, state_dict) -> Dict[str, Any]:
    """A port state dict → the JAX tree, the module types read from the
    model built on the meta device (no memory for its weights)."""
    with torch.device("meta"):
        model = model_cls(cfg)
    return unflatten_params(_flax_flat(model, state_dict))


def convert(model: str, sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A checkpoint's state dict → the JAX package's tree for ``model``
    (``tools/convert_weights.py``'s ``convert``): layer counts from the
    keys, every other width the kind's default."""
    vision = r"vision_model\.encoder\.layers\.(\d+)\."
    if model == "clip":
        return convert_clip_state_dict(
            sd, _depth(sd, vision),
            _depth(sd, r"text_model\.encoder\.layers\.(\d+)\."))
    if model == "blip":
        return convert_blip_state_dict(
            sd, _depth(sd, vision),
            _depth(sd, r"text_decoder\.bert\.encoder\.layer\.(\d+)\."))
    if model == "blip2":
        from .qformer import (Blip2Retrieval, QFormerConfig,
                              convert_blip2_state_dict)

        cfg = QFormerConfig(
            vision_depth=_depth(sd, vision),
            depth=_depth(sd, r"qformer\.encoder\.layer\.(\d+)\."))
        return _port_tree(Blip2Retrieval, cfg,
                          convert_blip2_state_dict(sd, cfg))
    if model == "owlvit":
        from .owlvit import convert_owlvit_state_dict

        pre = r"owlvit\."
        return convert_owlvit_state_dict(
            sd, _depth(sd, pre + vision),
            _depth(sd, pre + r"text_model\.encoder\.layers\.(\d+)\."))
    if model == "efficientnet":
        from .effnet import EfficientNet, convert_effnet_state_dict, effnet_b0

        return _port_tree(EfficientNet, effnet_b0(),
                          convert_effnet_state_dict(sd))
    raise ValueError(f"unknown model kind: {model}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert public HF checkpoints to avede_tpu .npz "
                    "weights.")
    ap.add_argument("--model", required=True, choices=sorted(KNOBS))
    ap.add_argument("--src", required=True,
                    help="HF snapshot dir or torch state-dict file")
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)

    sd = load_state_dict(args.src, args.model)
    params = convert(args.model, sd)
    save_param_tree(params, args.out)
    n = len(flatten_params(params))
    print(f"wrote {args.out} ({n} arrays)")
    print(f"point settings.{KNOBS[args.model]} (env var "
          f"{KNOBS[args.model]}) at it")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

