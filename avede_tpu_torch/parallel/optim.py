"""The optax pieces the trainers use, in PyTorch (the JAX package's
trainers take them from optax: ``avede_tpu/parallel/train.py:83-93``,
``train_reid.py:25-32``, ``eval.py``'s schedules).

``adamw`` and ``adam`` build an :class:`Adam` on a parameter list;
``clip_norm`` puts ``optax.clip_by_global_norm`` in front, as
``optax.chain(clip_by_global_norm(n), adamw(lr, wd))`` does. Where
optax and ``torch.optim`` part ways, this follows optax:

- clipping is ``where(norm < max_norm, g, g · max_norm / norm)`` with
  no epsilon (``torch.nn.utils.clip_grad_norm_`` divides by
  ``norm + 1e-6``), and ``step`` returns the norm *before* clipping;
- a schedule is read at the update count *before* it is incremented,
  so a warmup from 0 gives the first update a learning rate of 0;
- ``eps`` is added outside the square root (``eps_root`` = 0), and the
  bias corrections ``1 - b**count`` use the incremented count, taken in
  float32 as optax takes them;
- weight decay is decoupled, ``-lr · wd · p`` on the old ``p``, and
  reaches every parameter: biases, norms, embeddings, ``logit_scale``.

The moments and the update run on the parameters' device as the
multi-tensor ``torch._foreach_*`` ops ``torch.optim`` uses; the norm
takes a reduction a tensor; a step reads nothing back to the host.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]
B1, B2, EPS = 0.9, 0.999, 1e-8       # optax's Adam defaults


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a 0-d tensor), each
    tensor's sum of squares taken by ``sum`` (PyTorch's CPU
    ``vector_norm`` and ``_foreach_norm`` drift by 5e-5 relative on a
    ViT-B/32's 25M-element token embedding; optax's sum stays within
    1e-6)."""
    return torch.stack([t.square().sum() for t in tensors]).sum().sqrt()


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``: ``init_value`` times a cosine
    from 1 down to ``alpha`` over ``decay_steps``, then flat at
    ``alpha``."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must be positive")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    to ``end_value`` at ``decay_steps`` (counted from 0, warmup
    included), then flat."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    if decay_steps <= warmup_steps:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return decay(count - warmup_steps)
    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax takes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Adam:
    """Adam with decoupled weight decay and optional global-norm
    clipping, step for step ``optax.chain(clip_by_global_norm(clip_norm),
    adamw(learning_rate, weight_decay))`` (``adam`` when
    ``weight_decay`` is 0 and ``clip_norm`` None).

    ``step()`` applies the gradients in ``p.grad`` (a parameter without
    one takes a zero gradient, as JAX's would be) and returns the global
    norm of the gradients before clipping, a 0-d tensor on the device.
    ``count`` is optax's update count."""

    def __init__(self, params: Iterable[torch.Tensor],
                 learning_rate: LearningRate, weight_decay: float = 0.0,
                 clip_norm: Optional[float] = None) -> None:
        self.params: List[torch.Tensor] = list(params)
        if not self.params:
            raise ValueError("no parameters to optimize")
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr(self) -> float:
        """The learning rate of the next update."""
        lr = self.learning_rate
        return float(lr(self.count)) if callable(lr) else float(lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = global_norm(grads)
        if self.clip_norm is not None:
            # optax: where(norm < max, g, g / norm * max), no epsilon
            scale = torch.where(norm < self.clip_norm,
                                torch.ones_like(norm),
                                self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.lr()
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - B2)
        self.count += 1
        update = torch._foreach_div(self.mu, _bias_correction(B1, self.count))
        denom = torch._foreach_div(self.nu, _bias_correction(B2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(update, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -lr)
        torch._foreach_add_(self.params, update)
        return norm

    def state_dict(self) -> Dict[str, object]:
        """``{"count", "mu", "nu"}``: the moments in parameter order."""
        return {"count": self.count, "mu": list(self.mu),
                "nu": list(self.nu)}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        mu, nu = state["mu"], state["nu"]
        if len(mu) != len(self.params) or len(nu) != len(self.params):
            raise ValueError(f"state holds {len(mu)} moments for "
                             f"{len(self.params)} parameters")
        with torch.no_grad():
            for dst, src in zip(self.mu + self.nu, list(mu) + list(nu)):
                if dst.shape != src.shape:
                    raise ValueError(f"moment of shape {tuple(src.shape)} "
                                     f"for a parameter of {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(state["count"])


def adamw(params: Iterable[torch.Tensor], learning_rate: LearningRate,
          weight_decay: float = 1e-4, clip_norm: Optional[float] = None
          ) -> Adam:
    """``optax.adamw(learning_rate, weight_decay=weight_decay)``, behind
    ``clip_by_global_norm(clip_norm)`` when it is given."""
    return Adam(params, learning_rate, weight_decay, clip_norm)


def adam(params: Iterable[torch.Tensor], learning_rate: LearningRate,
         clip_norm: Optional[float] = None) -> Adam:
    """``optax.adam(learning_rate)``, behind
    ``clip_by_global_norm(clip_norm)`` when it is given."""
    return Adam(params, learning_rate, 0.0, clip_norm)
