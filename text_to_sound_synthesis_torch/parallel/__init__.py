"""Data parallelism on ``torch.distributed`` (the port's ``parallel/``)."""

from .distributed import (all_gather_cat, all_reduce_mean_, fold_seed, get_rank,  # noqa: F401
                          get_world_size, init_distributed, is_primary, local_device, replica,
                          run_sharded, wrap_ddp)
