"""The compute-dtype guard of a ``Diffsound``'s parts, and ``full_f32``.

A ``Diffsound`` built with a compute dtype other than f32 keeps its weights
in f32 and reads them through ``Diffsound.compute_weights``, which lends each
part copies in the compute dtype for the length of a call. It marks its
parts (the codec, the diffusion model, its denoiser and the text tower) with
``compute_dtype``; a marked part called on its f32 storage, outside that
block, would compute in f32 and give other results with no error, so it
raises instead.

``full_f32`` turns TF32 off for a block: PyTorch's default lets cuDNN run f32
convs on TF32 on the card, which a comparison with the CPU or a feature
extractor held to f32 does not want.
"""

from __future__ import annotations

import contextlib

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


@contextlib.contextmanager
def full_f32():
    """Matmuls and cuDNN's convs in full f32 (no TF32) for the block, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
