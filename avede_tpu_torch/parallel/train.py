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
device; nothing is read back unless the caller reads it.

A step maker's ``mesh`` is ``None`` (one device), a local 1 × 1 mesh
(its device), or a process mesh (``parallel/mesh.py``: one rank a grid
cell under ``torch.distributed``), the JAX package's SPMD step written
out. Every rank is handed the same global batch and takes its data
shard's rows; it differentiates its share of the *global* loss, so the
shares add up to the one-device loss: the contrastive logits cover the
whole batch (``gather_batch`` over ``data``), the batch-wide normalisers
(grounding's frame counts, the caption's token count) are summed over
``data``, a per-example mean is divided by ``n_data``. The gradients
are then summed over ``data`` and the reported loss is the global one.
The CLIP step also splits its weights over ``model`` (Megatron-style,
``COLUMN_SHARDED`` / ``ROW_SHARDED`` by ``param_spec``, JAX's rules:
``shard_params``); its optimizer's global norm counts the shards once
(``optim.Adam.shard_norm``). A local mesh of several devices has no
process group and is refused.

Checkpoints are one directory per step under ``path``, as orbax's
``CheckpointManager`` lays them out, but each holds one ``torch.save``
file of the parameters, the optimizer state and the step: it is not an
orbax checkpoint. A sharded state is saved as whole tensors (gathered
over ``model``, written by rank 0), so a checkpoint restores at any
shard count, as orbax's does. Weights cross to the JAX package through
``models.convert.save_params`` (its flat ``.npz``).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.clip import CLIPConfig, CLIPModel, init_clip
from ..models.layers import MLP, MultiHeadAttention
from ..utils.platform import resolve_device
from .collectives import all_reduce_sum, gather_batch
from .mesh import MODEL_AXIS, MeshContext
from .optim import Adam, LearningRate, adamw

Metrics = Dict[str, torch.Tensor]
CHECKPOINT_FILE = "train_state.pt"

COLUMN_SHARDED = ("fc1", "q_proj", "k_proj", "v_proj")
ROW_SHARDED = ("fc2", "out_proj")

Spec = Tuple[Optional[str], ...]


def param_spec(name: Union[str, Sequence[str]], param: Any = None) -> Spec:
    """The tensor-parallel layout of a parameter by its name (or path),
    JAX's rules (``avede_tpu/parallel/train.py:39-51``) on the port's
    tensors: for each dim, the mesh axis it is split over (None: whole),
    ``()`` for a replicated parameter — ``PartitionSpec``'s tuple form.
    A ``Linear``'s weight is ``[out, in]``, flax's kernel transposed, so
    a column-sharded weight is ``("model", None)`` where JAX's kernel is
    ``P(None, "model")``."""
    names = name.split(".") if isinstance(name, str) else list(name)
    parent = names[-2] if len(names) >= 2 else ""
    kind = names[-1]
    if parent in COLUMN_SHARDED:
        if kind == "weight":
            return (MODEL_AXIS, None)
        if kind == "bias":
            return (MODEL_AXIS,)
    if parent in ROW_SHARDED and kind == "weight":
        return (None, MODEL_AXIS)
    return ()


def _shard_dim(name: str) -> Optional[int]:
    spec = param_spec(name)
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def param_shardings(model: nn.Module, mesh: MeshContext) -> Dict[str, Spec]:
    """Every parameter's layout on ``mesh``, by name (``param_spec``; an
    axis of size 1 keeps the tensor whole)."""
    return {n: param_spec(n) for n, _ in model.named_parameters()}


def shard_params(model: nn.Module, mesh: MeshContext) -> nn.Module:
    """Keep this rank's slice (its model coordinate's ``1 / n_model``) of
    each tensor-parallel parameter, in place, and turn attention and the
    MLP to their tensor-parallel forms over the mesh's model group.
    Nothing changes at ``n_model`` = 1; a head count or a width that does
    not split over ``n_model`` raises."""
    n = mesh.n_model
    if n == 1:
        return model
    if not mesh.is_distributed:
        raise ValueError("tensor parallelism needs a process mesh "
                         "(init_distributed, then build_mesh())")
    for name, mod in model.named_modules():
        if isinstance(mod, MultiHeadAttention) and mod.num_heads % n:
            raise ValueError(f"{name}: {mod.num_heads} heads do not split "
                             f"over {n} model shards")
    m = mesh.coord[1]
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = _shard_dim(name)
            if dim is None:
                continue
            if p.shape[dim] % n:
                raise ValueError(f"{name}: dim {dim} of {tuple(p.shape)} "
                                 f"does not split over {n} model shards")
            p.data = p.data.chunk(n, dim)[m].clone()
    for mod in model.modules():
        if isinstance(mod, (MultiHeadAttention, MLP)):
            mod.tp_group = mesh.model_group
    return model


def _placement(mesh: Any, device=None
               ) -> Tuple[Optional[MeshContext], Any]:
    """``(process mesh or None, device)`` for a trainer: ``mesh=None`` is
    one device; a local 1 × 1 mesh is its device; a process mesh is
    this rank's cell. Anything else raises."""
    if mesh is None:
        return None, device
    if not isinstance(mesh, MeshContext):
        raise TypeError(f"mesh must be a MeshContext, not "
                        f"{type(mesh).__name__}")
    if device is not None:
        raise ValueError("pass mesh or device, not both")
    if mesh.is_distributed:
        return mesh, mesh.device
    if mesh.n_devices == 1:
        return None, mesh.device
    raise ValueError(
        f"a local {mesh.n_data}×{mesh.n_model} mesh has no process group "
        f"to reduce over: train on a process mesh (init_distributed, then "
        f"build_mesh())")


def _local_rows(mesh: Optional[MeshContext], *tensors: torch.Tensor
                ) -> List[torch.Tensor]:
    """Each tensor's rows of this rank's data shard (the global batch cut
    into ``n_data`` equal, contiguous shards)."""
    if mesh is None:
        return list(tensors)
    n, d = mesh.n_data, mesh.coord[0]
    out = []
    for t in tensors:
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} does not split over "
                             f"{n} data shards")
        per = t.shape[0] // n
        out.append(t[d * per: (d + 1) * per])
    return out


def _global(share: torch.Tensor, mesh: Optional[MeshContext]
            ) -> torch.Tensor:
    """The ranks' shares summed over ``data`` (the global loss)."""
    if mesh is None:
        return share.detach()
    return all_reduce_sum(share, mesh.data_group)


def _reduce_grads(params: List[torch.Tensor], group: Any) -> None:
    """Sum every parameter's gradient over ``group`` (one collective on a
    flat buffer); a parameter without one counts as zero, as in JAX."""
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


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
    the number of steps taken; ``mesh``, where the module's parameters
    are shards of it (``shard_params``)."""

    module: nn.Module
    optimizer: Adam
    step: int = 0
    mesh: Optional[MeshContext] = None

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
    """CLIP from ``seed`` on ``device`` (or this rank's cell of a process
    mesh, its parameters sharded over ``model``) in the config's dtype,
    with ``clip_by_global_norm(1.0)`` and ``adamw(learning_rate,
    0.05)``."""
    mesh, device = _placement(mesh, device)
    cfg = cfg or CLIPConfig()
    _refuse_flash(cfg)
    model = _on_device(lambda: init_clip(cfg, seed=seed), cfg, device)
    if mesh is not None:
        shard_params(model, mesh)
    opt = adamw(model.parameters(), learning_rate, weight_decay=0.05,
                clip_norm=1.0)
    if mesh is not None and mesh.n_model > 1:
        opt.shard_norm([_shard_dim(n) is not None
                        for n, _ in model.named_parameters()],
                       mesh.model_group)
    return model, TrainState(model, opt, mesh=mesh)


def _apply(state: TrainState, loss: torch.Tensor,
           mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Backward, the gradients summed over ``data`` (on a process mesh),
    one optimizer update; → the gradient norm before clipping."""
    state.optimizer.zero_grad()
    loss.backward()
    if mesh is not None:
        _reduce_grads(state.optimizer.params, mesh.data_group)
    norm = state.optimizer.step()
    state.step += 1
    return norm


def make_train_step(model: CLIPModel, mesh=None
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, images, ids) → (state, {"loss", "grad_norm"})``:
    images float ``[B, S, S, 3]`` CLIP-normalized pixels, ids int
    ``[B, L]``, both on the model's device (on a process mesh, the global
    batch: each rank takes its data shard's rows, the InfoNCE logits
    cover the whole batch). The state is updated in place and
    returned."""
    mesh, _ = _placement(mesh)
    _refuse_flash(model.cfg)

    def step(state: TrainState, images: torch.Tensor, ids: torch.Tensor
             ) -> Tuple[TrainState, Metrics]:
        images, ids = _local_rows(mesh, images, ids)
        img, txt, scale = state.module(images, ids)
        if mesh is None:
            share = loss = clip_contrastive_loss(img, txt, scale)
        else:
            # every data rank computes the global loss; each takes 1/n_data
            group = mesh.data_group
            loss = clip_contrastive_loss(gather_batch(img, group),
                                         gather_batch(txt, group), scale)
            share = loss / mesh.n_data
        norm = _apply(state, share, mesh)
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return _f32_convs(step)


def make_grounding_train_step(model, mesh=None
                              ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, frame_emb, text_emb, sal_labels, off_labels, valid) →
    (state, {"loss", "grad_norm"})`` for the temporal-grounding head
    (``models/univtg.py``); JAX's step reports the loss only. On a
    process mesh: data-parallel, the frame counts the whole batch's."""
    from ..models.univtg import grounding_loss

    mesh, _ = _placement(mesh)
    group = mesh.data_group if mesh is not None else None

    def step(state: TrainState, frame_emb, text_emb, sal_labels,
             off_labels, valid) -> Tuple[TrainState, Metrics]:
        frame_emb, text_emb, sal_labels, off_labels, valid = _local_rows(
            mesh, frame_emb, text_emb, sal_labels, off_labels, valid)
        sal, off = state.module(frame_emb, text_emb, valid)
        loss = grounding_loss(sal, off, sal_labels, off_labels, valid,
                              group)
        norm = _apply(state, loss, mesh)
        return state, {"loss": _global(loss, mesh), "grad_norm": norm}

    return _f32_convs(step)


def caption_loss(logits: torch.Tensor, ids: torch.Tensor,
                 pad_token_id: int, group=None) -> torch.Tensor:
    """Teacher-forced cross-entropy of ``logits[:, t]`` against
    ``ids[:, t + 1]``, pad targets masked, mean over the rest. With
    ``group`` (the data ranks of a sharded step) the batch is one shard:
    the mean is over the whole batch's tokens (counted over the group),
    so the ranks' results add up to the whole batch's loss."""
    targets = ids[:, 1:].long()
    mask = (targets != pad_token_id).float()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    count = mask.sum()
    if group is not None:
        count = all_reduce_sum(count, group)
    return (nll * mask).sum() / count.clamp(min=1.0)


def make_caption_train_step(model, pad_token_id: int, mesh=None
                            ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``(state, pixels, ids) → (state, {"loss", "grad_norm"})``: BLIP
    (``models/blip.py``, built with ``use_flash=False``) trained on
    :func:`caption_loss`; JAX's step reports the loss only. On a process
    mesh: data-parallel, the token count the whole batch's."""
    mesh, _ = _placement(mesh)
    _refuse_flash(model.cfg)
    group = mesh.data_group if mesh is not None else None

    def step(state: TrainState, pixels: torch.Tensor, ids: torch.Tensor
             ) -> Tuple[TrainState, Metrics]:
        pixels, ids = _local_rows(mesh, pixels, ids)
        loss = caption_loss(state.module(pixels, ids), ids, pad_token_id,
                            group)
        norm = _apply(state, loss, mesh)
        return state, {"loss": _global(loss, mesh), "grad_norm": norm}

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

def _sharded(state: TrainState) -> Optional[MeshContext]:
    mesh = state.mesh
    return mesh if mesh is not None and mesh.n_model > 1 else None


def _whole(name: str, t: torch.Tensor, mesh: MeshContext) -> torch.Tensor:
    """The model group's slices of ``name``'s tensor joined (every rank of
    the group calls)."""
    dim = _shard_dim(name)
    if dim is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.n_model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def gather_state_dict(state: TrainState) -> Dict[str, Any]:
    """``state.state_dict()`` with every sharded parameter and moment
    whole (on a sharded state, every rank of the model group calls)."""
    sd = state.state_dict()
    mesh = _sharded(state)
    if mesh is None:
        return sd
    opt = sd["opt_state"]
    return {"params": {k: _whole(k, v, mesh)
                       for k, v in sd["params"].items()},
            "opt_state": {"count": opt["count"],
                          **{m: {k: _whole(k, v, mesh)
                                 for k, v in opt[m].items()}
                             for m in ("mu", "nu")}},
            "step": sd["step"]}


def save_checkpoint(state: TrainState, path: str, step: int) -> str:
    """Write ``state`` to ``<path>/<step>/`` (one ``torch.save`` file; not
    an orbax checkpoint) → ``path``. A sharded state is written whole;
    under ``torch.distributed`` every rank calls, rank 0 writes."""
    sd = gather_state_dict(state)
    distributed = dist.is_available() and dist.is_initialized()
    if not distributed or dist.get_rank() == 0:
        d = Path(path) / str(int(step))
        d.mkdir(parents=True, exist_ok=True)
        tmp = d / (CHECKPOINT_FILE + ".tmp")
        torch.save(sd, tmp)
        tmp.replace(d / CHECKPOINT_FILE)
    if distributed:
        dist.barrier()
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
    mesh = _sharded(state)
    if mesh is not None:               # whole tensors → this rank's slices
        m, n = mesh.coord[1], mesh.n_model

        def cut(name: str, t: torch.Tensor) -> torch.Tensor:
            dim = _shard_dim(name)
            return t if dim is None else t.chunk(n, dim)[m].clone()

        opt = saved["opt_state"]
        saved = {"params": {k: cut(k, v) for k, v in saved["params"].items()},
                 "opt_state": {"count": opt["count"],
                               **{mo: {k: cut(k, v)
                                       for k, v in opt[mo].items()}
                                  for mo in ("mu", "nu")}},
                 "step": saved["step"]}
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
    batch (``tiny_test_config`` by default) → first and last loss; on a
    process mesh, the batch split over ``data`` and the weights over
    ``model``."""
    from ..models.clip import tiny_test_config

    cfg = cfg or tiny_test_config()
    model, state = create_train_state(cfg, mesh=mesh, device=device)
    step = make_train_step(model, mesh)
    dev = next(model.parameters()).device
    images, ids = (torch.from_numpy(x).to(dev) for x in demo_batch(cfg, batch))
    losses = []
    for _ in range(n_steps):
        state, metrics = step(state, images, ids)
        losses.append(metrics["loss"])
    return {"first_loss": float(losses[0]), "last_loss": float(losses[-1])}
