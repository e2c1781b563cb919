"""Contrastive training of the appearance / identity encoder
(counterpart of ``avede_tpu/parallel/train_reid.py``): two views per
identity in a batch, NT-Xent at temperature 0.1, on one device or
data-parallel over a process mesh (the NT-Xent logits cover the whole
batch, as in the JAX package's SPMD step)."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..models.appearance import (AppearanceConfig, AppearanceEncoder,
                                 init_appearance, nt_xent_loss)
from .optim import LearningRate, adamw
from .collectives import gather_batch
from .train import (Metrics, TrainState, _apply, _f32_convs, _local_rows,
                    _on_device, _placement)


def create_reid_train_state(cfg: Optional[AppearanceConfig] = None,
                            learning_rate: LearningRate = 1e-3,
                            seed: int = 0, device=None
                            ) -> Tuple[AppearanceEncoder, TrainState]:
    """The encoder from ``seed`` on ``device`` with
    ``clip_by_global_norm(1.0)`` and ``adamw(learning_rate, 1e-4)``."""
    cfg = cfg or AppearanceConfig()
    model = _on_device(lambda: init_appearance(cfg, seed=seed), cfg, device)
    return model, TrainState(model, adamw(model.parameters(), learning_rate,
                                          weight_decay=1e-4, clip_norm=1.0))


def make_reid_train_step(model: AppearanceEncoder, mesh=None,
                         temperature: float = 0.1
                         ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, view_a, view_b) → (state, {"loss", "grad_norm"})``:
    views float ``[B, S, S, 3]`` in [0, 1]; row i of both is one
    identity (JAX's step reports the loss only). On a process mesh each
    rank embeds its data shard's rows of the global batch."""
    mesh, _ = _placement(mesh)

    def step(state: TrainState, view_a: torch.Tensor, view_b: torch.Tensor
             ) -> Tuple[TrainState, Metrics]:
        view_a, view_b = _local_rows(mesh, view_a, view_b)
        ea, eb = state.module(view_a), state.module(view_b)
        if mesh is None:
            loss = share = nt_xent_loss(ea, eb, temperature)
        else:
            # every data rank computes the global loss; each takes 1/n_data
            group = mesh.data_group
            loss = nt_xent_loss(gather_batch(ea, group),
                                gather_batch(eb, group), temperature)
            share = loss / mesh.n_data
        norm = _apply(state, share, mesh)
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return _f32_convs(step)
