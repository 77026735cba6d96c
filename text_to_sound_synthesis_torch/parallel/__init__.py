"""Data parallelism on ``torch.distributed`` (the port's ``parallel/``)."""

from .distributed import (all_gather_cat, fold_seed, get_rank, get_world_size,  # noqa: F401
                          init_distributed, is_primary, local_device, replica, run_sharded,
                          wrap_ddp)
