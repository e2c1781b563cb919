"""The sparse-expert (MoE) SwiGLU layer: routing, dispatch by expert, the
grouped expert GEMM and the combine (no counterpart in the JAX package,
which has no sparse-expert layer; added for Kimi-VL's decoder).

A layer holds ``E`` routed experts and ``S`` shared ones in one set of
stacked weights, ``w_gate`` and ``w_up`` ``[E + S, F, D]`` and ``w_down``
``[E + S, D, F]``: a shared SwiGLU of width ``S·F`` is the same function
as ``S`` experts of width ``F`` that every token takes with weight 1,
since SiLU(gate)·up acts element by element over the intermediate
dimension and the down projection sums over it.

- ``route``: DeepSeek-V3's ``noaux_tc`` routing with one group: scores
  ``s = sigmoid(W_g h)`` in f32, the top ``k`` of ``s + bias`` chosen
  (the correction bias moves the choice only), their ``s`` normalised to
  sum 1 and scaled; the shared experts appended with weight 1.
- ``dispatch``: the ``(token, slot)`` assignments sorted by expert with a
  stable sort on the device, each expert's first row (``offsets``) and
  where each assignment landed (``inverse``), with no host sync.
- ``grouped_swiglu``: the layer's output. On the card three launches of
  ``csrc/moe_grouped_gemm.cu`` (gate and up with the SiLU product, down,
  and the combine: a gather and a weighted sum in f32, no atomics); for
  CPU tensors the plain version, which loops over the experts. A CUDA
  tensor takes the kernels or raises.

``grouped_swiglu.launches`` counts the layer's launches (the two of the
grouped kernel and the combine), each where it is made, and
``launches_by_shape`` the grouped kernel's by tile shape (``"prefill"``:
128-row tiles, ``"decode"``: 16-row tiles, chosen from the mean rows an
expert).
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .kernels import _refuse_grad, _require_cuda

# mean rows an expert below which the kernels take their 16-row tiles
DECODE_ROWS = 32
_TILE_ROWS = {"prefill": 128, "decode": 16}


class Routing(NamedTuple):
    slots: torch.Tensor       # int64 [T, k + S]: experts, shared last
    weights: torch.Tensor     # f32 [T, k + S]


def route(h: torch.Tensor, gate_w: torch.Tensor, bias: torch.Tensor,
          top_k: int, scale: float, n_shared: int) -> Routing:
    """h [T, D] → the routing of each token (see the module docstring)."""
    e = gate_w.shape[0]
    s = torch.sigmoid(F.linear(h.float(), gate_w.float()))
    choice = torch.topk(s + bias.float(), top_k, dim=-1).indices
    w = s.gather(1, choice)
    w = w / w.sum(dim=-1, keepdim=True) * scale
    t = h.shape[0]
    shared = torch.arange(e, e + n_shared, device=h.device).expand(t, -1)
    ones = torch.ones(t, n_shared, dtype=w.dtype, device=h.device)
    return Routing(torch.cat([choice, shared], dim=1),
                   torch.cat([w, ones], dim=1))


class Dispatch(NamedTuple):
    tokens: torch.Tensor      # int32 [A]: the token of each sorted row
    offsets: torch.Tensor     # int32 [E + S + 1]: each expert's first row
    inverse: torch.Tensor     # int32 [T, k + S]: each assignment's row
    counts: torch.Tensor      # int32 [E + S]: rows an expert


def dispatch(slots: torch.Tensor, n_experts: int) -> Dispatch:
    """Sort the assignments ``slots`` [T, k + S] by expert (stable: a
    token's rows keep token order within an expert), on the device."""
    t, per = slots.shape
    flat = slots.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat[order]
    offsets = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, device=slots.device))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=slots.device)
    offsets = offsets.to(torch.int32)
    return Dispatch((order // per).to(torch.int32), offsets,
                    inverse.view(t, per).to(torch.int32),
                    offsets[1:] - offsets[:-1])


def expert_swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                  wd: torch.Tensor) -> torch.Tensor:
    """One expert's SwiGLU on rows ``x`` [n, D] (plain)."""
    return F.linear(F.silu(F.linear(x, wg)) * F.linear(x, wu), wd)


def grouped_swiglu_plain(x: torch.Tensor, r: Routing, d: Dispatch,
                         w_gate: torch.Tensor, w_up: torch.Tensor,
                         w_down: torch.Tensor) -> torch.Tensor:
    """Plain version: each expert's rows through its SwiGLU in the input
    dtype, then each token's rows weighted and summed in f32."""
    rows = torch.empty(d.tokens.numel(), x.shape[1], dtype=x.dtype,
                       device=x.device)
    off = d.offsets.tolist()
    for e in range(w_gate.shape[0]):
        lo, hi = off[e], off[e + 1]
        if hi > lo:
            rows[lo:hi] = expert_swiglu(x[d.tokens[lo:hi].long()],
                                        w_gate[e], w_up[e], w_down[e])
    y = rows[d.inverse.long()].float()            # [T, k + S, D]
    return (y * r.weights.unsqueeze(-1)).sum(dim=1).to(x.dtype)


def tile_shape(n_rows: int, n_experts: int) -> str:
    """``"decode"`` (16-row tiles) when the experts hold fewer than
    ``DECODE_ROWS`` rows on average, else ``"prefill"`` (128-row)."""
    return "decode" if n_rows < DECODE_ROWS * n_experts else "prefill"


def grouped_swiglu(x: torch.Tensor, r: Routing, d: Dispatch,
                   w_gate: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """x [T, D] → the layer's output [T, D] for the routing ``r`` and its
    dispatch ``d``; w_gate, w_up [E + S, F, D], w_down [E + S, D, F]. On
    the card: bf16, D and F multiples of 128 and 64, contiguous."""
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, r, d, w_gate, w_up, w_down)
    _require_cuda(x, w_gate, w_up, w_down, d.tokens, d.offsets, d.inverse)
    if any(t.dtype != torch.bfloat16 for t in (x, w_gate, w_up, w_down)):
        raise ValueError("grouped_swiglu takes bfloat16 x and weights")
    n_exp, f, dim = w_gate.shape
    if x.dim() != 2 or x.shape[1] != dim or w_down.shape != (n_exp, dim, f) \
            or w_up.shape != w_gate.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_down "
                         f"{tuple(w_down.shape)}")
    if dim % 128 or f % 64:
        raise ValueError(f"grouped_swiglu: D {dim} must be a multiple of "
                         f"128 and F {f} of 64")
    _refuse_grad("grouped_swiglu", x, w_gate, w_up, w_down)
    t, per = d.inverse.shape
    a = d.tokens.numel()
    shape = tile_shape(a, n_exp)
    bm = _TILE_ROWS[shape]
    tiles = (d.counts + (bm - 1)) // bm
    tile_start = torch.zeros(n_exp + 1, dtype=torch.int32, device=x.device)
    tile_start[1:] = torch.cumsum(tiles, 0)
    max_tiles = (a + bm - 1) // bm + n_exp
    h = torch.empty(a, f, dtype=torch.bfloat16, device=x.device)
    y = torch.empty(a, dim, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(t, dim, dtype=torch.bfloat16, device=x.device)
    weights = r.weights.to(torch.float32).contiguous()
    p, i = ctypes.c_void_p, ctypes.c_int
    dec = int(shape == "decode")
    _build.launch(x.device, "moe_grouped_gemm", "avede_moe_gate_up_bf16",
                  [p, p, p, p, p, p, p, i, i, i, i, i, i],
                  x.data_ptr(), d.tokens.data_ptr(), w_gate.data_ptr(),
                  w_up.data_ptr(), h.data_ptr(), tile_start.data_ptr(),
                  d.offsets.data_ptr(), n_exp, max_tiles, dim, f, dim, dec)
    _count(shape)
    _build.launch(x.device, "moe_grouped_gemm", "avede_moe_down_bf16",
                  [p, p, p, p, p, i, i, i, i, i],
                  h.data_ptr(), w_down.data_ptr(), y.data_ptr(),
                  tile_start.data_ptr(), d.offsets.data_ptr(), n_exp,
                  max_tiles, f, dim, dec)
    _count(shape)
    _build.launch(x.device, "moe_grouped_gemm", "avede_moe_combine_bf16",
                  [p, p, p, p, i, i, i],
                  y.data_ptr(), d.inverse.data_ptr(), weights.data_ptr(),
                  out.data_ptr(), t, per, dim)
    _count(None)
    return out


def _count(shape: Optional[str]) -> None:
    """One launch: of the grouped kernel at ``shape``, or the combine."""
    grouped_swiglu.launches += 1
    if shape is not None:
        grouped_swiglu.launches_by_shape[shape] += 1


grouped_swiglu.launches = 0
grouped_swiglu.launches_by_shape = collections.Counter()


def load_stats(d: Dispatch, n_routed: int) -> torch.Tensor:
    """int64 [4] on the device: the layer's rows (assignments, shared
    included), experts with at least one row (of all ``E + S``), the
    routed experts' largest load, and their rows (for the mean load)."""
    c = d.counts.long()
    routed = c[:n_routed]
    return torch.stack([c.sum(), (c > 0).sum(), routed.max(),
                        routed.sum()])


def moe_layer(x: torch.Tensor, gate_w: torch.Tensor, bias: torch.Tensor,
              w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, top_k: int, scale: float,
              n_shared: int, stats: Optional[list] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] → (output [T, D], the routed choices int64 [T, top_k]).
    With ``stats`` (a list) the layer's ``load_stats`` is appended."""
    r = route(x, gate_w, bias, top_k, scale, n_shared)
    d = dispatch(r.slots, w_gate.shape[0])
    if stats is not None:
        stats.append(load_stats(d, gate_w.shape[0]))
    return grouped_swiglu(x, r, d, w_gate, w_up, w_down), r.slots[:, :top_k]
