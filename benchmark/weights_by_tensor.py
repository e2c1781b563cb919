"""Random weights from the seed, one generator stream a tensor.

Each tensor of a spec is drawn by a generator of its own on the device,
seeded from the run's seed and the tensor's index in the spec, as
standard normals in f32, scaled by its kind, and cast to the served
dtype. Any tensor, so any layer, can be drawn again alone: the
reference streams a 16 B-parameter model one layer at a time without
ever holding it, where ``weights.py``'s single flat draw would need the
whole model in f32 at once (65.6 GB for Kimi-VL).

Kinds (``weights.py``'s scales, and the kinds a latent-attention MoE
decoder adds):

- a matrix (a 2-d ``weight``, or a conv's 4-d one) is ``N(0, 1/fan_in)``;
- a stack of expert matrices ``[E, out, in]`` (``w_gate``, ``w_up``,
  ``w_down``) is ``N(0, 1/in)``;
- an embedding table or position table is ``N(0, 0.02²)``;
- a LayerNorm's or RMSNorm's scale is ``1 + N(0, 0.1²)``, a LayerNorm
  shift, every bias and the router's correction bias ``N(0, 0.02²)``.

The same seed, spec, device and dtype give the same tensors.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, tuple]]


def kind(name: str, shape: tuple) -> str:
    leaf = name.rsplit(".", 1)[-1]
    owner = name.rsplit(".", 1)[0].rsplit(".", 1)[-1] if "." in name else ""
    if "norm" in owner:
        return "norm_scale" if leaf == "weight" else "small"
    if leaf in ("bias", "e_score_correction_bias", "pos_emb") \
            or "embed_tokens" in name:
        return "small"
    if len(shape) == 3 and leaf.startswith("w_"):
        return "experts"
    if leaf == "weight" and len(shape) in (2, 4):
        return "matrix"
    raise ValueError(f"no initialisation rule for {name} {shape}")


def generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of the ``index``-th tensor of a spec."""
    state = np.random.SeedSequence([abs(int(seed)), 0x7465_6E73, int(index)]
                                   ).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31 | int(state[1]) >> 1) % (1 << 63))


def draw(name: str, shape: tuple, index: int, seed: int, device,
         dtype: torch.dtype) -> torch.Tensor:
    """One tensor of a spec (see the module docstring)."""
    x = torch.empty(shape, dtype=torch.float32, device=device)
    x.normal_(generator=generator(seed, index, device))
    k = kind(name, shape)
    if k == "matrix":
        x *= (x.numel() // shape[0]) ** -0.5
    elif k == "experts":
        x *= shape[-1] ** -0.5
    elif k == "small":
        x *= 0.02
    else:
        x = 1.0 + 0.1 * x
    return x.to(dtype)


def make(spec: Spec, seed: int, device, dtype: torch.dtype,
         names: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """name → tensor on ``device`` in ``dtype`` for every entry of
    ``spec``, or only those in ``names``."""
    want = None if names is None else set(names)
    return {name: draw(name, shape, i, seed, device, dtype)
            for i, (name, shape) in enumerate(spec)
            if want is None or name in want}
