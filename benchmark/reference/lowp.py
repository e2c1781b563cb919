"""Roundings below the configurations' precisions, for the controls.

A control is a reference computed one step below the precision that a
configuration states: fp8 (e4m3) for bfloat16, int4 for int8. Each
rounding scales by the absolute maximum first, as an fp8 or int4
deployment does, so that the format's range is used whole.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn
INT4_MAX = 7


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor,
    returned in x's dtype."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (x.float() / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).to(x.dtype)


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [N, D] rounded to float8 e4m3 with a scale a row."""
    amax = x.abs().amax(dim=1, keepdim=True).float().clamp_min(1e-30)
    scale = amax / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float()
            * scale).to(x.dtype)


def int4_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` [N, D] rounded to int4 (-7..7) with a scale a row,
    returned dequantized in f32."""
    amax = x.abs().amax(dim=1, keepdim=True).float()
    scale = torch.where(amax > 0, amax / INT4_MAX, torch.ones_like(amax))
    return torch.clamp(torch.round(x.float() / scale), -INT4_MAX,
                       INT4_MAX) * scale
