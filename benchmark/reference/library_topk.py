"""Plain reference of a whole-library search: the index tier's rounding
of the rows, exact scores, a stable top-k and the service's threshold,
per-video cap and candidate loop, written from their semantics.

- Tiers: ``bfloat16`` rows rounded to bfloat16; ``int8`` rows scaled by
  their absolute maximum over 127, rounded and clamped to -127..127,
  the score the int8 row's product times its f32 scale; ``float32`` as
  given. The score is the f32 product with the query, TF32 off.
- Order: descending score, equal scores the lower row first.
- Service: candidates come best first, ``K' = max(64, 4 · top_k)`` of
  them; a candidate under the threshold ends the pass, one whose video
  already has ``per_video_k`` results is skipped, ``top_k`` results end
  it; if the results fall short while candidates remain, ``K'``
  quadruples and the pass runs again.

Controls: ``lowp_rows`` rounds the rows one step below the tier
(``fp8`` below bfloat16, ``int4`` below int8).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .lowp import fp8_rows, int4_rows

INT8_MAX = 127


def tier_rows(rows: torch.Tensor, tier: str,
              lowp: Optional[str] = None) -> torch.Tensor:
    """f32 ``[N, D]`` unit rows → the values the tier scores them with,
    in f32 (an int8 row's integers already times its scale)."""
    if lowp == "fp8":
        return fp8_rows(rows)
    if lowp == "int4":
        return int4_rows(rows)
    if lowp is not None:
        raise ValueError(f"unknown control precision {lowp!r}")
    if tier == "float32":
        return rows.float()
    if tier == "bfloat16":
        return rows.to(torch.bfloat16).float()
    if tier == "int8":
        amax = rows.abs().amax(dim=1, keepdim=True)
        scale = torch.where(amax > 0, amax / INT8_MAX, torch.ones_like(amax))
        q = torch.clamp(torch.round(rows / scale), -INT8_MAX, INT8_MAX)
        return q * scale
    raise ValueError(f"unknown tier {tier!r}")


def stable_order(scores: torch.Tensor) -> torch.Tensor:
    """Row indices by descending score, ties the lower row first."""
    return torch.sort(scores, descending=True, stable=True).indices


def capped_search(scores: torch.Tensor, video_of_row, top_k: int,
                  threshold: float, per_video_k: int) -> List[int]:
    """The service's result rows for one query over ``scores`` [N]
    (``video_of_row(row)`` gives a row's video)."""
    order = stable_order(scores)
    n = scores.shape[0]
    k_dev = max(64, 4 * top_k)
    while True:
        cand = order[:k_dev].tolist()
        vals = scores[order[:k_dev]].tolist()
        per_video: Dict[int, int] = {}
        results: List[int] = []
        for row, s in zip(cand, vals):
            if s < threshold:
                break
            v = video_of_row(row)
            if per_video.get(v, 0) >= per_video_k:
                continue
            per_video[v] = per_video.get(v, 0) + 1
            results.append(row)
            if len(results) >= top_k:
                break
        exhausted = len(cand) < k_dev or (cand and vals[-1] < threshold)
        if len(results) >= top_k or exhausted or k_dev >= n:
            return results
        k_dev *= 4


def judge(scores: torch.Tensor, ref_rows: Sequence[int],
          served: Sequence[Tuple[int, float]]) -> Tuple[float, float]:
    """One served search judged by the reference: (``rank_gap``, the
    widest gap by which a served result's reference score lies below the
    reference's result of the same rank; ``score_err``, the widest gap
    between a served confidence and the reference score of its row).
    ``served`` is (row, confidence) best first; a result missing or
    unknown reads infinity."""
    if len(served) < len(ref_rows) or any(r is None for r, _ in served):
        return float("inf"), float("inf")
    ref = sorted((float(scores[r]) for r in ref_rows), reverse=True)
    got = sorted((float(scores[r]) for r, _ in served), reverse=True)
    gap = max([a - b for a, b in zip(ref, got)], default=0.0)
    err = max([abs(c - float(scores[r])) for r, c in served], default=0.0)
    return gap, err
