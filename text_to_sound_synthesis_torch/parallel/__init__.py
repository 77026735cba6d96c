"""Data and model parallelism on ``torch.distributed`` (the port's ``parallel/``).

``sharding`` (the Megatron model axis) is imported by its path: it builds on
the denoiser's modules, which import this package."""

from .distributed import (all_gather_cat, all_reduce_mean_, fold_seed, get_rank,  # noqa: F401
                          get_world_size, init_distributed, is_primary, local_device, replica,
                          run_sharded, same_across, wrap_ddp)
from .mesh import (Mesh, batch_ranks, join_idle, make_data_mesh_for_batch,  # noqa: F401
                   make_mesh, mesh_shape, shard_batch)
