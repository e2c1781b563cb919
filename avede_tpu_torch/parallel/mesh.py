"""Device meshes (counterpart of ``avede_tpu/parallel/mesh.py``).

A mesh is a ``[n_data, n_model]`` grid of devices under the JAX
package's axes: frames and batches split over ``data``, the
tensor-parallel weights of a training step over ``model``. It comes in
two kinds, with the same code paths whatever devices fill the grid:

- a **local** mesh lists devices that one process drives. Serving takes
  it: ``ClipEngine`` and ``DeviceLibraryIndex`` split their work over the
  data devices (the first column). A device may repeat: N virtual
  shards of one card, or of the CPU, run what N cards would run, the
  counterpart of JAX's ``xla_force_host_platform_device_count``.
- a **process** mesh spans a ``torch.distributed`` process group, one
  rank a grid cell, rank = data · n_model + model (the order of JAX's
  ``reshape(d, m)``). It also holds the rank's coordinate and the two
  sub-groups its collectives run over: ``data_group`` (the grid's
  column through the rank: the ranks that hold the same weight shard)
  and ``model_group`` (its row: the ranks that split one batch shard's
  weights). Training takes this kind.

``build_mesh()`` builds the process mesh once ``init_distributed`` (or
``torch.distributed.init_process_group``) has run, else a local mesh
over every visible card; it raises without a card unless devices are
passed. The shape is ``settings.MESH_SHAPE`` (``[n_data, n_model]``, or
``[n_data]``), by default every device on ``data``; ``settings.MESH_AXES``
must name the two axes as above.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..utils.config import settings
from ..utils.errors import ConfigurationError
from ..utils.logging import get_logger

logger = get_logger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """A ``[n_data, n_model]`` grid of devices; under ``torch.distributed``
    also this rank's place in it and its two sub-groups."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    rank: Optional[int] = None            # None: a local mesh
    data_group: Any = None                # ranks with this model coordinate
    model_group: Any = None               # ranks with this data coordinate

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def n_model(self) -> int:
        return len(self.devices[0])

    @property
    def n_devices(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> Tuple[int, int]:
        return self.n_data, self.n_model

    @property
    def is_distributed(self) -> bool:
        return self.rank is not None

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data shard (the grid's first column)."""
        return [row[0] for row in self.devices]

    @property
    def coord(self) -> Tuple[int, int]:
        """This rank's ``(data, model)`` place (``(0, 0)`` for a local
        mesh)."""
        r = self.rank or 0
        return r // self.n_model, r % self.n_model

    @property
    def device(self) -> torch.device:
        """This rank's device (a local mesh's first data device)."""
        d, m = self.coord
        return self.devices[d][m]

    def pad_to_data(self, n: int) -> int:
        """Round ``n`` up to a multiple of the data-axis size."""
        d = self.n_data
        return ((n + d - 1) // d) * d


def _mesh_shape(n_devices: int, shape: Optional[Sequence[int]]
                ) -> Tuple[int, int]:
    if isinstance(shape, str):               # MESH_SHAPE from the environment
        shape = json.loads(shape)
    if shape is not None:
        if len(shape) == 1:
            shape = (shape[0], 1)
        if shape[0] * shape[1] != n_devices:
            raise ValueError(
                f"MESH_SHAPE {tuple(shape)} does not cover {n_devices} "
                f"devices")
        return int(shape[0]), int(shape[1])
    return n_devices, 1


def _check_axes() -> None:
    """``settings.MESH_AXES`` names the grid's two axes; the port's code
    knows them as ``DATA_AXIS`` and ``MODEL_AXIS`` only, so any other
    value is refused rather than ignored."""
    axes = settings.MESH_AXES
    if isinstance(axes, str):                # from the environment
        axes = json.loads(axes)
    if list(axes) != [DATA_AXIS, MODEL_AXIS]:
        raise ConfigurationError(
            f"MESH_AXES {list(axes)} is not supported: the mesh's axes are "
            f"[{DATA_AXIS!r}, {MODEL_AXIS!r}]")


def _normalize(device: Device) -> torch.device:
    """An explicit device: ``cuda`` gains the current card's index (two
    cards must compare unequal); a card without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ConfigurationError(
                "CUDA requested but torch.cuda.is_available() is false; "
                "pass device='cpu' (a mesh: CPU devices) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ConfigurationError(f"unsupported device {dev}")
    return dev


def _rank_device(rank: int) -> torch.device:
    """The device of ``rank`` in the process group: one card a rank
    under NCCL (ranks fill a host's cards in order), the CPU under
    gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _process_mesh(shape: Optional[Sequence[int]]) -> MeshContext:
    world, rank = dist.get_world_size(), dist.get_rank()
    d, m = _mesh_shape(world, shape)
    grid = tuple(tuple(_rank_device(i * m + j) for j in range(m))
                 for i in range(d))
    # every rank creates every group, in the same order
    data_group = model_group = None
    for j in range(m):
        g = dist.new_group([i * m + j for i in range(d)])
        if rank % m == j:
            data_group = g
    for i in range(d):
        g = dist.new_group([i * m + j for j in range(m)])
        if rank // m == i:
            model_group = g
    logger.info("Mesh: %d×%d (%s×%s) over %d processes (%s), rank %d",
                d, m, DATA_AXIS, MODEL_AXIS, world, dist.get_backend(), rank)
    return MeshContext(grid, rank, data_group, model_group)


def build_mesh(devices: Optional[Sequence[Device]] = None,
               shape: Optional[Sequence[int]] = None) -> MeshContext:
    """A mesh over ``devices`` (local; a device may repeat), else the
    process group's ranks once ``torch.distributed`` is initialized,
    else every visible card (none: raises). ``shape``: ``[n_data,
    n_model]`` or ``[n_data]``, default ``settings.MESH_SHAPE``, else
    all on ``data``. ``settings.MESH_AXES`` other than ``["data",
    "model"]`` raises."""
    _check_axes()
    shape = shape if shape is not None else settings.MESH_SHAPE
    if devices is None and dist.is_available() and dist.is_initialized():
        return _process_mesh(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise ConfigurationError(
                "no card for the default mesh (torch.cuda.is_available() "
                "is false); pass device='cpu' (a mesh: CPU devices) to run "
                "on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_normalize(x) for x in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    d, m = _mesh_shape(len(devices), shape)
    grid = tuple(tuple(devices[i * m: (i + 1) * m]) for i in range(d))
    logger.info("Mesh: %d×%d (%s×%s) over %s", d, m, DATA_AXIS, MODEL_AXIS,
                ", ".join(str(x) for x in dict.fromkeys(devices)))
    return MeshContext(grid)


_GLOBAL: Optional[MeshContext] = None


def get_mesh() -> MeshContext:
    """The process-wide mesh over every visible device (``build_mesh()``),
    built at first use."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = build_mesh()
    return _GLOBAL


def local_mesh(n: int = 1) -> MeshContext:
    """A local mesh over the first ``n`` visible cards."""
    if not torch.cuda.is_available():
        raise ConfigurationError("local_mesh needs a card; pass CPU "
                                 "devices to build_mesh instead")
    return build_mesh([torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())][:n])


def reset_mesh() -> None:
    global _GLOBAL
    _GLOBAL = None


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[float] = None) -> None:
    """Join this process to a ``torch.distributed`` group (call once per
    process, before ``build_mesh()``). Unset arguments come from
    ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``env://``).
    A process alone, with no rendezvous given, is left as it is (JAX's
    single-process no-op); a group of one is made when ``init_method``
    is given. ``backend`` is ``nccl`` (one card a rank, the card made
    current) unless the caller asks for ``gloo`` (the CPU); NCCL without
    a card raises. ``timeout``: seconds a collective may wait."""
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if init_method is None and (world_size is None or world_size <= 1):
        logger.info("Single-process mode; no process group")
        return
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise ConfigurationError(
                "the nccl backend needs a card; pass backend='gloo' to run "
                "the ranks on the CPU")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    elif backend != "gloo":
        raise ConfigurationError(f"unsupported backend {backend!r}")
    extra = ({"timeout": datetime.timedelta(seconds=timeout)}
             if timeout is not None else {})
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size or 1, rank=rank, **extra)
    logger.info("torch.distributed initialized (%s): rank %d/%d", backend,
                rank, world_size or 1)
