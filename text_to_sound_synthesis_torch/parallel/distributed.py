"""The process group and data parallelism on ``torch.distributed``.

The JAX package runs one SPMD program over a (data, model) device mesh; the
port runs one process per card (``torchrun``), NCCL between cards, gloo on
the CPU, and lays the ranks out as that grid (``mesh.py``). Each data rank
trains on its own slice of the data (``data/loader.py::ShardedLoader``) and
DDP averages the gradients over the data group (``wrap_ddp``); a model axis
above 1 splits the Stage-2 denoiser (``sharding.py``).

Generation is batch-parallel with no collective but the final gather:
``run_sharded`` runs a sampler on each shard of a batch, either on the ranks
of a process group or on a list of devices in one process (a device may
repeat), with the run's seed folded by the shard's index (``fold_seed``, the
counterpart of ``jax.random.fold_in``).
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["init_distributed", "get_rank", "get_world_size", "is_primary", "local_device",
           "wrap_ddp", "all_gather_cat", "all_reduce_mean_", "same_across", "fold_seed", "replica",
           "run_sharded"]

_MASK64 = (1 << 64) - 1


def init_distributed(device="cuda", *, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group and return (rank, world size). ``rank``,
    ``world_size`` and ``init_method`` default to what ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``); the backend
    is NCCL for a CUDA ``device``, gloo otherwise. A process that is already
    in a group returns its place there."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if init_method is None:
        init_method = "env://" if "MASTER_ADDR" in os.environ else None
        if init_method is None:
            raise ValueError("init_distributed needs init_method (tcp://host:port) "
                             "outside torchrun")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    return rank, world_size


def get_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_primary() -> bool:
    return get_rank() == 0


def local_device(device="cuda") -> torch.device:
    """This process's device: for CUDA the card ``torchrun`` gave it
    (``LOCAL_RANK``); refuses a CUDA device on a host without one."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card visible to torch; pass device='cpu' to run on the CPU")
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    return device


def wrap_ddp(module: nn.Module, device, group=None) -> nn.Module:
    """``module`` under DDP over ``group`` (the default group; a mesh's data
    group) when the process is in a group (of any size), else ``module``
    itself. Only the trainable denoiser goes in: DDP refuses parameters that
    take no gradient, and the frozen codec and text tower take none."""
    if not dist.is_initialized():
        return module
    device = torch.device(device)
    ids = [device.index] if device.type == "cuda" else None
    return nn.parallel.DistributedDataParallel(module, device_ids=ids, process_group=group)


def all_gather_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along dim 0 in rank order."""
    parts = [torch.empty_like(x) for _ in range(get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def same_across(x: torch.Tensor, group=None) -> bool:
    """Whether ``x`` (equal shapes) is bit for bit the same on every rank of
    ``group``: a check that ranks meant to agree do."""
    parts = [torch.empty_like(x) for _ in range(get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return all(torch.equal(p, parts[0]) for p in parts)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over ``group``'s ranks, in place, in
    one all-reduce (the data-parallel average of gradients and metrics that
    DDP's hooks would make; the Stage-1 steps call it themselves, between
    their passes)."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def fold_seed(seed: int, index: int) -> int:
    """The seed of shard ``index`` of a run seeded ``seed``: splitmix64 of
    seed + (index + 1) * 0x9E3779B97F4A7C15, as a 63-bit integer."""
    z = (seed + (index + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _module_device(module: nn.Module) -> torch.device:
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    raise ValueError("module holds no tensor")


def replica(module: nn.Module, device, cache: dict) -> nn.Module:
    """``module`` if it lies on ``device``, else a copy moved there (kept in
    ``cache``, keyed by device)."""
    device = torch.device(device)
    if _module_device(module) == device:
        return module
    if device not in cache:
        cache[device] = copy.deepcopy(module).to(device)
    return cache[device]


def run_sharded(fn: Callable[[torch.Tensor, torch.Generator], torch.Tensor], x: torch.Tensor,
                *, seed: int, devices: Optional[Sequence] = None, group=None) -> torch.Tensor:
    """``fn`` on each batch shard of ``x``: shard i gets rows [i B/n, (i+1)
    B/n) of ``x`` on its device and a generator there seeded
    ``fold_seed(seed, i)``; the outputs are concatenated in shard order.

    The shards are ``devices``, in this process (a device may repeat), or,
    without ``devices``, the ranks of ``group`` (the default group): each
    rank passes the whole batch, runs its own shard on ``x``'s device, and
    gets every shard's output back (``all_gather_cat``). The result equals
    ``fn`` run per shard with the folded seeds, bit for bit."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        shards = range(n)
    else:
        if not dist.is_initialized():
            raise ValueError("run_sharded needs devices or a process group")
        n = get_world_size(group)
        shards = [get_rank(group)]
    B = x.shape[0]
    if n == 0 or B % n:
        raise ValueError(f"batch {B} must be a multiple of the shard count {n}")
    Bs = B // n
    outs = []
    for i in shards:
        dev = devices[i] if devices is not None else x.device
        g = torch.Generator(dev).manual_seed(fold_seed(seed, i))
        outs.append(fn(x[i * Bs:(i + 1) * Bs].to(dev), g).to(x.device))
    if devices is None:
        return all_gather_cat(outs[0], group)
    return torch.cat(outs)
