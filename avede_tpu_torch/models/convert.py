"""Weight bridge from the JAX package's parameters (counterpart of
``avede_tpu/models/convert.py``).

``params_from_jax`` turns a Flax parameter tree (nested mappings of
arrays) into a state dict for the port's models (``models/clip.py``,
``models/blip.py``, ``models/univtg.py``); ``load_params`` reads
the flat slash-joined ``.npz`` that ``avede_tpu.models.convert.
save_params`` writes, so both packages can serve one weight file.

Mapping, per leaf: path parts join with ``.`` and ``layers_<i>``
becomes ``layers.<i>``; a 2-D Dense ``kernel [in, out]`` becomes
``weight [out, in]``; a 4-D conv ``kernel`` in HWIO becomes OIHW;
LayerNorm ``scale`` and Embed ``embedding`` become ``weight``; every
other leaf keeps its name.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


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


def _key_and_value(path: str, value: np.ndarray):
    parts = [re.sub(r"^layers_(\d+)$", r"layers.\1", p)
             for p in path.split("/")]
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
        if value.ndim == 2:
            value = value.T
        elif value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
    elif leaf in ("scale", "embedding"):
        parts[-1] = "weight"
    return ".".join(parts), value


def params_from_flat(flat: Mapping[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
    """{slash-joined path: array} → port state dict (f32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key, v = _key_and_value(path, np.asarray(value, np.float32))
        sd[key] = torch.from_numpy(np.array(v, np.float32, order="C"))
    return sd


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree of arrays → port state dict."""
    return params_from_flat(flatten_params(tree))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read a flat slash-joined ``.npz`` (the JAX package's format)."""
    with np.load(path) as z:
        return params_from_flat({k: z[k] for k in z.files})
