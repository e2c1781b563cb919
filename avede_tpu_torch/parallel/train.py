"""Training (counterpart of ``avede_tpu/parallel/train.py``): the CLIP
contrastive step, the temporal-grounding head's step, BLIP's
teacher-forced caption step, checkpoints and an overfit smoke loop.

Each trainer runs on one device (``cuda`` unless the caller asks for the
CPU) in its config's dtype, float32 by default as in the JAX package
(a step turns off cuDNN's TF32, which PyTorch allows by default, so a
convolution is f32 too), and differentiates plain PyTorch, as the JAX
package differentiates plain XLA: no hand-written kernel has a
backward, so a model whose config asks for flash attention is refused
(its kernel would drop the gradient). A step keeps its loss on the
device; nothing is read back unless the caller reads it. The JAX package
shards a step over a mesh (``COLUMN_SHARDED`` / ``ROW_SHARDED``,
``param_spec``); here ``mesh``
must be ``None`` until the multi-GPU slice of ROADMAP.md brings a mesh
(item 7).

Checkpoints are one directory per step under ``path``, as orbax's
``CheckpointManager`` lays them out, but each holds one ``torch.save``
file of the parameters, the optimizer state and the step: it is not an
orbax checkpoint. Weights cross to the JAX package through
``models.convert.save_params`` (its flat ``.npz``).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.clip import CLIPConfig, CLIPModel, init_clip
from ..utils.platform import resolve_device
from .optim import Adam, LearningRate, adamw

Metrics = Dict[str, torch.Tensor]
CHECKPOINT_FILE = "train_state.pt"


def _no_mesh(mesh: Any) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded training waits for the multi-GPU slice (ROADMAP.md "
            "Queue 1, item 7); pass mesh=None")


def _refuse_flash(cfg: Any) -> None:
    if getattr(cfg, "use_flash", False):
        raise ValueError(
            "training needs use_flash=False: the hand-written flash kernel "
            "has no backward (the JAX package cannot differentiate its "
            "Pallas kernel either)")


def _f32_convs(step: Callable[..., Any]) -> Callable[..., Any]:
    """``step`` with cuDNN's TF32 off (and restored after): its
    convolutions, forward and backward, run in f32 as its matrix
    products do and as the CPU runs them (PyTorch lets cuDNN round f32
    convolutions to TF32 by default)."""
    @functools.wraps(step)
    def run(*args):
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return step(*args)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    return run


@dataclasses.dataclass
class TrainState:
    """A model, its optimizer (over ``module.parameters()`` in order) and
    the number of steps taken."""

    module: nn.Module
    optimizer: Adam
    step: int = 0

    def __post_init__(self) -> None:
        params = list(self.module.parameters())
        if len(params) != len(self.optimizer.params) or any(
                a is not b for a, b in zip(params, self.optimizer.params)):
            raise ValueError("the optimizer must hold module.parameters(), "
                             "in order")

    def state_dict(self) -> Dict[str, Any]:
        """``{"params", "opt_state", "step"}``; the moments are keyed by
        parameter name, as ``models.convert.train_state_from_jax``
        writes them."""
        names = [n for n, _ in self.module.named_parameters()]
        opt = self.optimizer.state_dict()
        return {"params": self.module.state_dict(),
                "opt_state": {"count": opt["count"],
                              "mu": dict(zip(names, opt["mu"])),
                              "nu": dict(zip(names, opt["nu"]))},
                "step": self.step}

    def load_state_dict(self, state: Dict[str, Any]) -> "TrainState":
        names = [n for n, _ in self.module.named_parameters()]
        opt = state["opt_state"]
        self.module.load_state_dict(state["params"])
        self.optimizer.load_state_dict({
            "count": opt["count"], "mu": [opt["mu"][n] for n in names],
            "nu": [opt["nu"][n] for n in names]})
        self.step = int(state["step"])
        return self


def _on_device(build: Callable[[], nn.Module], cfg: Any, device
               ) -> nn.Module:
    """``build()`` on ``device`` (resolved first: no card, no model) in
    the config's dtype, in training mode."""
    dev = resolve_device(device)
    return build().to(dev, getattr(torch, cfg.dtype)).train()


def clip_contrastive_loss(img_emb: torch.Tensor, txt_emb: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch, on f32 logits."""
    logits = logit_scale.float() * (img_emb.float() @ txt_emb.float().T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels)
                  + F.cross_entropy(logits.T, labels))


def create_train_state(cfg: Optional[CLIPConfig] = None, mesh=None,
                       learning_rate: LearningRate = 1e-4, seed: int = 0,
                       device=None) -> Tuple[CLIPModel, TrainState]:
    """CLIP from ``seed`` on ``device`` in the config's dtype, with
    ``clip_by_global_norm(1.0)`` and ``adamw(learning_rate, 0.05)``."""
    _no_mesh(mesh)
    cfg = cfg or CLIPConfig()
    _refuse_flash(cfg)
    model = _on_device(lambda: init_clip(cfg, seed=seed), cfg, device)
    opt = adamw(model.parameters(), learning_rate, weight_decay=0.05,
                clip_norm=1.0)
    return model, TrainState(model, opt)


def _apply(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Backward, one optimizer update; → the gradient norm before
    clipping."""
    state.optimizer.zero_grad()
    loss.backward()
    norm = state.optimizer.step()
    state.step += 1
    return norm


def make_train_step(model: CLIPModel, mesh=None
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, images, ids) → (state, {"loss", "grad_norm"})``:
    images float ``[B, S, S, 3]`` CLIP-normalized pixels, ids int
    ``[B, L]``, both on the model's device. The state is updated in
    place and returned."""
    _no_mesh(mesh)
    _refuse_flash(model.cfg)

    def step(state: TrainState, images: torch.Tensor, ids: torch.Tensor
             ) -> Tuple[TrainState, Metrics]:
        img, txt, scale = state.module(images, ids)
        loss = clip_contrastive_loss(img, txt, scale)
        norm = _apply(state, loss)
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return _f32_convs(step)


def make_grounding_train_step(model, mesh=None
                              ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, frame_emb, text_emb, sal_labels, off_labels, valid) →
    (state, {"loss", "grad_norm"})`` for the temporal-grounding head
    (``models/univtg.py``); JAX's step reports the loss only."""
    from ..models.univtg import grounding_loss

    _no_mesh(mesh)

    def step(state: TrainState, frame_emb, text_emb, sal_labels,
             off_labels, valid) -> Tuple[TrainState, Metrics]:
        sal, off = state.module(frame_emb, text_emb, valid)
        loss = grounding_loss(sal, off, sal_labels, off_labels, valid)
        norm = _apply(state, loss)
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return _f32_convs(step)


def caption_loss(logits: torch.Tensor, ids: torch.Tensor,
                 pad_token_id: int) -> torch.Tensor:
    """Teacher-forced cross-entropy of ``logits[:, t]`` against
    ``ids[:, t + 1]``, pad targets masked, mean over the rest."""
    targets = ids[:, 1:].long()
    mask = (targets != pad_token_id).float()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def make_caption_train_step(model, pad_token_id: int, mesh=None
                            ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, pixels, ids) → (state, {"loss", "grad_norm"})``: BLIP
    (``models/blip.py``, built with ``use_flash=False``) trained on
    :func:`caption_loss`; JAX's step reports the loss only."""
    _no_mesh(mesh)
    _refuse_flash(model.cfg)

    def step(state: TrainState, pixels: torch.Tensor, ids: torch.Tensor
             ) -> Tuple[TrainState, Metrics]:
        loss = caption_loss(state.module(pixels, ids), ids, pad_token_id)
        norm = _apply(state, loss)
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return _f32_convs(step)


def create_grounding_train_state(cfg=None, learning_rate: LearningRate = 1e-3,
                                 seed: int = 0, device=None):
    """The grounding head from ``seed`` with ``adamw(learning_rate,
    0.01)`` (no clipping); ``learning_rate`` may be a schedule."""
    from ..models.univtg import TemporalGroundingConfig, init_grounding

    cfg = cfg or TemporalGroundingConfig()
    model = _on_device(lambda: init_grounding(cfg, seed=seed), cfg, device)
    return model, TrainState(model, adamw(model.parameters(), learning_rate,
                                          weight_decay=0.01))


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def save_checkpoint(state: TrainState, path: str, step: int) -> str:
    """Write ``state`` to ``<path>/<step>/`` (one ``torch.save`` file; not
    an orbax checkpoint) → ``path``."""
    d = Path(path) / str(int(step))
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / (CHECKPOINT_FILE + ".tmp")
    torch.save(state.state_dict(), tmp)
    tmp.replace(d / CHECKPOINT_FILE)
    return path


def restore_checkpoint(state: TrainState, path: str,
                       step: Optional[int] = None) -> TrainState:
    """Load ``<path>/<step>/`` into ``state`` (``step=None``: the latest
    saved step) → ``state``."""
    root = Path(path)
    if step is None:
        steps = [int(d.name) for d in root.iterdir() if d.name.isdigit()
                 and (d / CHECKPOINT_FILE).exists()] if root.is_dir() else []
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = max(steps)
    device = next(state.module.parameters()).device
    saved = torch.load(root / str(int(step)) / CHECKPOINT_FILE,
                       map_location=device, weights_only=True)
    return state.load_state_dict(saved)


def demo_batch(cfg: CLIPConfig, batch: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``train_demo``'s fixed batch, the JAX package's numpy draws:
    normal f32 images and token ids in [1, vocab - 2) ending in the EOT
    id (vocab - 1)."""
    rng = np.random.default_rng(0)
    images = rng.normal(size=(batch, cfg.image_size, cfg.image_size, 3)
                        ).astype(np.float32)
    ids = rng.integers(1, cfg.vocab_size - 2,
                       size=(batch, cfg.max_text_len)).astype(np.int32)
    ids[:, -1] = cfg.vocab_size - 1
    return images, ids


def train_demo(n_steps: int = 2, batch: int = 8, mesh=None,
               cfg: Optional[CLIPConfig] = None, device=None
               ) -> Dict[str, float]:
    """Overfit smoke loop: ``n_steps`` CLIP steps on one fixed seeded
    batch (``tiny_test_config`` by default) → first and last loss."""
    from ..models.clip import tiny_test_config

    _no_mesh(mesh)
    cfg = cfg or tiny_test_config()
    model, state = create_train_state(cfg, device=device)
    step = make_train_step(model)
    dev = next(model.parameters()).device
    images, ids = (torch.from_numpy(x).to(dev) for x in demo_batch(cfg, batch))
    losses = []
    for _ in range(n_steps):
        state, metrics = step(state, images, ids)
        losses.append(metrics["loss"])
    return {"first_loss": float(losses[0]), "last_loss": float(losses[-1])}
