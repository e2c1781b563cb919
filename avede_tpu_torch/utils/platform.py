"""Device and compute-dtype resolution (counterpart of
``avede_tpu/utils/platform.py:64-94``).

The port's entry points run on ``cuda`` unless the caller asks for the
CPU. With no card they raise instead of carrying on on the CPU: a
number measured on the CPU must never pass for a device number.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from .config import settings
from .errors import ConfigurationError


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigurationError(
            "CUDA requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ConfigurationError(f"unsupported device {dev}")
    return dev


def compute_dtype(device: torch.device) -> str:
    """``settings.COMPUTE_DTYPE`` (bfloat16) on CUDA; float32 on the
    CPU, where the tests compare with the JAX reference in f32."""
    return settings.COMPUTE_DTYPE if device.type == "cuda" else "float32"


def with_compute_dtype(cfg, device: torch.device):
    """``cfg`` (a model config dataclass) with ``dtype`` set to
    :func:`compute_dtype` — for default-constructed configs only."""
    return dataclasses.replace(cfg, dtype=compute_dtype(device))
