"""The compute-dtype guard of a ``Diffsound``'s parts.

A ``Diffsound`` built with a compute dtype other than f32 keeps its weights
in f32 and reads them through ``Diffsound.compute_weights``, which lends each
part copies in the compute dtype for the length of a call. It marks its
parts (the codec, the diffusion model, its denoiser and the text tower) with
``compute_dtype``; a marked part called on its f32 storage, outside that
block, would compute in f32 and give other results with no error, so it
raises instead.
"""

from __future__ import annotations

import torch
from torch import nn


def check_compute_dtype(module: nn.Module, weight: torch.Tensor) -> None:
    """Raise ``TypeError`` when ``module`` is marked with a compute dtype and
    ``weight``, one of its own, is held in another."""
    want = getattr(module, "compute_dtype", None)
    if want is not None and weight.dtype != want:
        raise TypeError(
            f"{type(module).__name__} computes in {want} but reads {weight.dtype} weights: call "
            "it through its Diffsound's entry points or inside Diffsound.compute_weights(...)")
