"""The port's input pipeline: mel datasets, transforms and the sharded loader."""

from .transforms import CropSpec
from .datasets import (
    ArrayDataset,
    AudiosetDataset,
    CapsDataset,
    SpecsDataset,
    make_split_files,
)
from .loader import ShardedLoader, build_dataloader
