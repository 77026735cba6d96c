"""The (data, model) process grid: the port's counterpart of
``text_to_sound_synthesis_tpu/parallel/mesh.py``.

JAX lays its devices out as a (data, model) ``Mesh`` and shards arrays over
it. The port runs one process per card (``torchrun``) and lays the ranks of
``torch.distributed``'s world out the same way: the rank at position i of
the grid's ranks sits at (i // model, i % model), the reshape JAX makes of
its device list. Each rank gets two process groups:

- its **data group**, the ranks of its model column: they hold the same
  shard of the weights and take other rows of the batch (DDP averages the
  gradients over it, the timestep state gathers over it);
- its **model group**, the ranks of its data row: they take the same rows
  of the batch and hold other shards of the weights (``sharding.py``'s
  collectives run over it).

``make_data_mesh_for_batch`` is JAX's rule for a trainer's global batch: the
largest rank count that divides the batch, with a warning when ranks are
left over. Those ranks are outside the grid: they take no step and wait at
the end. ``shard_batch`` cuts a global batch into a rank's rows.

Without a process group every function works at world size 1 (one card
needs no ``init_distributed``). ``world_size`` and ``rank`` may also lay a
grid out with no processes at all, for the trainers' batch rules and the
tests: such a mesh has no groups.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "mesh_shape", "batch_ranks", "make_mesh", "make_data_mesh_for_batch",
           "shard_batch", "join_idle"]


@dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, int]            # (data, model)
    ranks: Tuple[int, ...]            # the grid's global ranks, row-major
    rank: int                         # this process's global rank
    world_size: int                   # every rank of the world, the grid's and the idle
    data_group: Any = None            # this rank's model column; None outside a group
    model_group: Any = None           # this rank's data row; None outside a group

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def model(self) -> int:
        return self.shape[1]

    @property
    def active(self) -> bool:
        """False on a rank left out of the grid (``make_data_mesh_for_batch``)."""
        return self.rank in self.ranks

    @property
    def coords(self) -> Optional[Tuple[int, int]]:
        """(data index, model index) of this rank; None when it is idle."""
        if not self.active:
            return None
        return divmod(self.ranks.index(self.rank), self.model)

    @property
    def data_index(self) -> int:
        """This rank's row of the batch (0 on an idle rank)."""
        return self.coords[0] if self.active else 0

    @property
    def model_index(self) -> int:
        """This rank's shard of the weights (0 on an idle rank)."""
        return self.coords[1] if self.active else 0

    def local_batch(self, batch_size: int) -> int:
        """A data rank's share of a global batch."""
        if batch_size % self.data:
            raise ValueError(f"global batch {batch_size} is not a multiple of the mesh's "
                             f"data axis {self.data}")
        return batch_size // self.data


def mesh_shape(n: int, data: Optional[int] = None, model: int = 1) -> Tuple[int, int]:
    """(data, model) of a grid over ``n`` ranks, with JAX's checks
    (``make_mesh``)."""
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return data, model


def batch_ranks(batch_size: int, n: int) -> int:
    """The largest rank count up to ``n`` that divides ``batch_size``."""
    while n > 1 and batch_size % n != 0:
        n -= 1
    return n


def _world(world_size: Optional[int], rank: Optional[int]) -> Tuple[int, int]:
    if dist.is_initialized():
        w, r = dist.get_world_size(), dist.get_rank()
        if (world_size not in (None, w)) or (rank not in (None, r)):
            raise ValueError(f"rank {rank} of {world_size} given in a group where this "
                             f"process is rank {r} of {w}")
        return w, r
    return (1 if world_size is None else world_size), (0 if rank is None else rank)


def _new_group(ranks: Sequence[int], world_size: int):
    """A process group of ``ranks``; every process of the world must call it,
    in the same order."""
    if len(ranks) == world_size:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(data: Optional[int] = None, model: int = 1, *,
              ranks: Optional[Sequence[int]] = None, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """A (data, model) grid over ``ranks`` (default: every rank of the world),
    with this rank's data and model groups. In a process group every rank of
    the world must call it, those outside ``ranks`` too (they get an idle
    mesh). ``world_size`` / ``rank`` lay out a grid without processes."""
    world, me = _world(world_size, rank)
    ranks = tuple(range(world) if ranks is None else ranks)
    data, model = mesh_shape(len(ranks), data, model)
    data_group = model_group = None
    if dist.is_initialized():
        # every process creates every group, in one order; each keeps its own
        for j in range(model):
            column = ranks[j::model]
            g = _new_group(column, world)
            if me in column:
                data_group = g
        for i in range(data):
            row = ranks[i * model:(i + 1) * model]
            g = _new_group(row, world)
            if me in row:
                model_group = g
    return Mesh((data, model), ranks, me, world, data_group, model_group)


def make_data_mesh_for_batch(batch_size: int, *, world_size: Optional[int] = None,
                             rank: Optional[int] = None) -> Mesh:
    """A data-parallel grid over the largest rank count that divides the
    global batch, as JAX's ``make_data_mesh_for_batch``: debug batches may be
    smaller than the world. Ranks left over are idle (``Mesh.active``)."""
    world, _ = _world(world_size, rank)
    n = batch_ranks(batch_size, world)
    if n != world:
        warnings.warn(
            f"global batch {batch_size} does not divide the {world} available "
            f"ranks; training on {n} rank(s) and IDLING {world - n}. "
            f"Pick a batch size divisible by the rank count to use every card.",
            RuntimeWarning,
            stacklevel=2,
        )
    return make_mesh(ranks=range(n), world_size=world_size, rank=rank)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (a tensor, a numpy array, or a dict,
    list, tuple or named tuple of them): rows [d B/data, (d + 1) B/data) for data index d.
    Rank-0 leaves (python scalars, 0-d tensors and arrays) have no batch axis
    and are returned as they are, as JAX replicates them."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        parts = [shard_batch(v, mesh) for v in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else type(batch)(parts)
    if getattr(batch, "ndim", 0) == 0:
        return batch
    n = mesh.local_batch(batch.shape[0])
    d = mesh.data_index
    out = batch[d * n:(d + 1) * n]
    return out.contiguous() if isinstance(out, torch.Tensor) else out


def join_idle(mesh: Mesh) -> None:
    """Where ranks are left out of the grid, every rank of the world meets
    here (a barrier) once the grid's ranks are done: the idle ones wait for
    the end of training. Every rank calls it; it does nothing otherwise."""
    if dist.is_initialized() and len(mesh.ranks) < mesh.world_size:
        dist.barrier()
