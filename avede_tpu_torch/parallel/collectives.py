"""Collectives with the gradients a sharded training step needs (the
collectives that XLA inserts from the JAX package's sharding
annotations, written out for ``torch.distributed``).

- ``copy_to_model`` / ``reduce_from_model``: Megatron's "f" and "g"
  around a tensor-parallel region. "f" is the identity forward and an
  all-reduce of the gradient over the model group backward (each rank's
  column-sharded product sends back only its own columns' part of the
  input's gradient); "g" all-reduces the row-sharded product's partial
  sums forward and passes the gradient through backward.
- ``gather_batch``: the global batch's rows from every data rank, in
  rank order (the contrastive losses contrast the whole batch). Every
  data rank computes the same global loss from it and differentiates
  ``1 / n_data`` of it, so backward sums the ranks' gradients and keeps
  this rank's rows (a reduce-scatter, written as an all-reduce and a
  slice: gloo has no reduce-scatter).
- ``all_reduce_sum``: a plain sum over a group (the batch-wide
  normalisers, the loss for its report), outside autograd.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> Tuple[torch.Tensor, None]:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return grad, None


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> Tuple[torch.Tensor, None]:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        n = grad.shape[0] // dist.get_world_size(ctx.group)
        return grad[ctx.rank * n: (ctx.rank + 1) * n], None


def copy_to_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's "f": identity forward, gradient all-reduced over
    ``group`` backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Megatron's "g": sum over ``group`` forward, gradient passed
    through backward."""
    return _ReduceFromModel.apply(x, group)


def gather_batch(x: torch.Tensor, group: Any) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) along dim 0, in rank order; the
    gradient of this rank's rows is the ranks' summed gradient of them."""
    return _GatherBatch.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor, no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out
