"""Random weights from the seed, made on the device in a few large draws.

One generator on the device, seeded from the run's seed, draws a single
flat buffer of standard normals (in chunks of at most 2^28); each
weight is a slice of it, scaled by its kind, in the served dtype:

- a matrix (a 2-d ``weight``, or the patch conv's 4-d one) is
  ``N(0, 1/fan_in)``;
- an embedding table, position table, class token or query tokens is
  ``N(0, 0.02²)``;
- a LayerNorm scale is ``1 + N(0, 0.1²)``, its shift and every bias
  ``N(0, 0.02²)``;
- ``logit_scale`` is CLIP's ``log(1/0.07)``.

The same seed, spec, device and dtype give the same tensors, so the
reference draws them again after the program is gone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28
_EMBEDDINGS = ("embedding", "query_tokens", "position_embeddings")
_NORMS = ("layer_norm", "layernorm", "_ln", "input_ln")


def kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 1)[0] if "." in name else ""
    if name == "logit_scale":
        return "logit_scale"
    if any(t in owner for t in _NORMS):
        return "norm_scale" if leaf == "weight" else "small"
    if leaf == "bias":
        return "small"
    if "patch_embedding" in name or (leaf == "weight" and len(shape) == 2
                                     and "embedding" not in name):
        return "matrix"
    if any(t in name for t in _EMBEDDINGS):
        return "small"
    raise ValueError(f"no initialisation rule for {name} {shape}")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for the ``stream``-th kind of data of a
    run (weights, frames, rows, ...), seeded from the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(stream)) % (1 << 63))


def make(spec: List[Tuple[str, tuple]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """name → tensor on ``device`` in ``dtype`` for every entry of
    ``spec`` (see the module docstring)."""
    sizes = [math.prod(shape) for _, shape in spec]
    total = sum(sizes)
    gen = generator(seed, 0, device)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    for lo in range(0, total, CHUNK):
        flat[lo:lo + CHUNK].normal_(generator=gen)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, shape), n in zip(spec, sizes):
        x = flat[off:off + n].view(shape)
        off += n
        k = kind(name, shape)
        if k == "matrix":
            x = x * (n // shape[0]) ** -0.5
        elif k == "small":
            x = x * 0.02
        elif k == "norm_scale":
            x = 1.0 + 0.1 * x
        else:
            x = torch.full(shape, math.log(1 / 0.07), device=device)
        out[name] = x.to(dtype)
    del flat
    return out
