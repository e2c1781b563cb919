"""Appearance / identity embedding for person re-identification
(counterpart of ``avede_tpu/models/appearance.py``).

A small convolutional encoder (four 3×3 stride-2 convolutions, each
followed by a LayerNorm over channels and SiLU, global average pooling,
a projection, unit norm) trained contrastively in the JAX package on
identity pairs that differ in background, clothing and lighting. The
person search embeds head crops with it (64 px) and, at the face
geometry (32 px, widths ``(16, 32, 32, 64)``, 64-d), detected face
boxes. It runs in f32, as in the JAX package.

Numerics that differ from PyTorch's habits: flax's ``padding="SAME"``
at stride 2 pads (0, 1) on an even side where PyTorch's symmetric
padding would pad (1, 1), so the padding is explicit; flax's
``LayerNorm`` eps is 1e-6, over the channel axis of NHWC. On the card
cuDNN may run the f32 convolutions in TF32 (PyTorch's default); the
card-vs-CPU bar (row cosine ≥ 0.9999) allows for that. Images are NHWC
at the public functions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.platform import resolve_device
from .layers import seeded_init


@dataclasses.dataclass(frozen=True)
class AppearanceConfig:
    input_size: int = 64
    widths: Tuple[int, ...] = (32, 64, 128, 128)
    embed_dim: int = 128
    dtype: str = "float32"


def tiny_appearance_config() -> AppearanceConfig:
    """Reduced widths for fast CPU tests."""
    return AppearanceConfig(widths=(16, 32, 32, 64), embed_dim=64)


def face_embed_config() -> AppearanceConfig:
    """The face embedding's geometry: 32 px face crops."""
    return AppearanceConfig(input_size=32, widths=(16, 32, 32, 64),
                            embed_dim=64)


def _same_pad(n: int, k: int = 3, s: int = 2) -> Tuple[int, int]:
    """TF/flax "SAME" padding of one side of length ``n``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class AppearanceEncoder(nn.Module):
    """[N, S, S, 3] float in [0, 1] → unit-norm f32 [N, embed_dim]."""

    def __init__(self, cfg: AppearanceConfig = AppearanceConfig()) -> None:
        super().__init__()
        self.cfg = cfg
        cin = 3
        for i, w in enumerate(cfg.widths):
            self.add_module(f"conv{i}", nn.Conv2d(cin, w, 3, stride=2))
            self.add_module(f"ln{i}", nn.LayerNorm(w, eps=1e-6))
            cin = w
        self.proj = nn.Linear(cin, cfg.embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.proj.weight.dtype).permute(0, 3, 1, 2)   # NCHW
        for i in range(len(self.cfg.widths)):
            top, bottom = _same_pad(x.shape[2])
            left, right = _same_pad(x.shape[3])
            x = getattr(self, f"conv{i}")(
                F.pad(x, (left, right, top, bottom)))
            x = getattr(self, f"ln{i}")(x.permute(0, 2, 3, 1))
            x = F.silu(x).permute(0, 3, 1, 2)
        x = self.proj(x.mean(dim=(2, 3))).float()               # GAP
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True
                                            ).clamp(min=1e-8)


def nt_xent_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                 temperature: float = 0.1) -> torch.Tensor:
    """SimCLR NT-Xent over positive pairs (row i of ``emb_a`` with row i
    of ``emb_b``): the diagonals of the row and the column log-softmax of
    ``emb_a @ emb_b.T / temperature``, averaged, then halved."""
    logits = (emb_a @ emb_b.T) / temperature                 # [B, B]
    loss_ab = -torch.log_softmax(logits, dim=1).diagonal()
    loss_ba = -torch.log_softmax(logits, dim=0).diagonal()
    return (loss_ab + loss_ba).mean() / 2.0


def init_appearance(cfg: Optional[AppearanceConfig] = None, seed: int = 0
                    ) -> AppearanceEncoder:
    """Encoder with deterministic random weights from ``seed``."""
    return seeded_init(AppearanceEncoder(cfg or AppearanceConfig()), seed,
                       (nn.Linear, nn.Conv2d))


class AppearanceEmbedder:
    """Inference front end: uint8 crops of any size → unit-norm
    embeddings. Crops are resized on the host (cv2 ``INTER_AREA``, as in
    the JAX package) and go through one forward on ``device`` (``cuda``
    unless the caller asks for the CPU).

    Weights: ``state_dict`` (``models.convert.load_params`` of the JAX
    package's ``.npz``, or ``params_from_jax``), else random from
    ``seed``."""

    def __init__(self, cfg: Optional[AppearanceConfig] = None,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device=None) -> None:
        self.cfg = cfg or AppearanceConfig()
        self.device = resolve_device(device)
        model = init_appearance(self.cfg, seed=seed)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device, getattr(torch, self.cfg.dtype)
                              ).eval()

    def embed(self, crops: Sequence[np.ndarray]) -> np.ndarray:
        """List of uint8 H×W×3 crops (ragged ok) → f32 [N, D]."""
        import cv2

        if not len(crops):
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        s = self.cfg.input_size
        batch = np.stack([
            cv2.resize(c, (s, s), interpolation=cv2.INTER_AREA)
            if c.shape[:2] != (s, s) else c
            for c in crops]).astype(np.float32) / 255.0
        with torch.inference_mode():
            out = self.model(torch.from_numpy(batch).to(self.device))
        return out.cpu().numpy()
