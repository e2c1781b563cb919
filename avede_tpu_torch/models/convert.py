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
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping

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
    owners = dict(model.named_modules())
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
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
    np.savez(path, **params)

