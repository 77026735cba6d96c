from .model import Melception, load_melception_checkpoint, unit_batch_stats_  # noqa: F401
