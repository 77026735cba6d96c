"""The compute dtype (``ComputeDtype``), its guard, and ``full_f32``.

A model built with a compute dtype other than f32 (``Diffsound``,
``Net2NetTransformer``, the GPTs) keeps its weights in f32 and reads them
through ``compute_weights``, which lends each part copies in the compute
dtype for the length of a call. A model marks the parts it does not run
itself (``Diffsound``'s codec, diffusion model, denoiser and text tower; the
AR codec) with ``compute_dtype``; a marked part called on its f32 storage,
outside that block, would compute in f32 and give other results with no
error, so it raises instead.

``full_f32`` turns TF32 off for a block: PyTorch's default lets cuDNN run f32
convs on TF32 on the card, which a comparison with the CPU or a feature
extractor held to f32 does not want.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional

import torch
from torch import nn


def resolve_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a dtype or its name (config files say e.g. ``dtype: bfloat16``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, dtype)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"dtype must name a torch dtype, got {dtype!r}")
    return dtype


class ComputeDtype:
    """Mixin of an ``nn.Module`` that holds its weights in f32 and computes in
    ``self.dtype``, as flax's ``dtype`` does in the JAX package: the
    parameters, their gradients and the optimizer's moments stay f32, and a
    forward runs on copies of the weights in the compute dtype
    (``compute_weights``). The module sets ``self.dtype`` before its first
    call; setting it drops the copies and marks the parts ``_marked_parts``
    names (a ``ComputeDtype`` part takes the dtype as its own)."""

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self._dtype

    @dtype.setter
    def dtype(self, dtype: Any) -> None:
        self._dtype = dtype = resolve_dtype(dtype)
        self._compute_copies: dict = {}
        self._computing_all = 0
        for part in self._marked_parts():
            if isinstance(part, ComputeDtype):
                part.dtype = dtype
            elif part is not None:
                part.compute_dtype = None if dtype == torch.float32 else dtype

    def _marked_parts(self) -> tuple:
        """The parts that refuse weights outside ``compute_weights``, or take the dtype."""
        return ()

    @contextlib.contextmanager
    def compute_weights(self, *parts: Optional[nn.Module]) -> Iterator[Any]:
        """Within the block, every floating parameter and buffer of ``parts``
        (the whole model when none is given) reads as its copy in the compute
        dtype: the f32 weights rounded to ``dtype``. A tensor that takes a
        gradient, under autograd, is cast afresh and the cast recorded, so
        the gradient reaches the f32 parameter. Any other tensor reads a
        copy kept from an earlier block, made anew only when the tensor
        changed since (its version counter: an optimizer step, an in-place
        write or a load; or its storage: ``.to``), so a request casts
        nothing twice. A write through ``.data`` is not seen: set ``dtype``
        again after one, which drops the copies. Tensors already in ``dtype``
        are left alone, so the blocks nest (a block over the whole model
        inside another costs nothing). A no-op in f32."""
        swapped = []
        whole = not parts
        if self.dtype != torch.float32 and not (whole and self._computing_all):
            grad, memo = torch.is_grad_enabled(), {}
            for part in (parts or (self,)):
                for m in (part.modules() if part is not None else ()):
                    for store in (m._parameters, m._buffers):
                        for k, t in store.items():
                            if t is None or not t.is_floating_point() or t.dtype == self.dtype:
                                continue
                            if id(t) not in memo:
                                memo[id(t)] = (t.to(self.dtype) if grad and t.requires_grad
                                               else self._kept_copy(t))
                            swapped.append((store, k, t))
                            store[k] = memo[id(t)]
        self._computing_all += whole
        try:
            yield self
        finally:
            self._computing_all -= whole
            for store, k, t in reversed(swapped):
                store[k] = t

    def _kept_copy(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in the compute dtype, cast again only when ``t`` changed."""
        stamp = (t._version, t.data_ptr(), t.device)
        kept = self._compute_copies.get(id(t))
        if kept is None or kept[0] is not t or kept[1] != stamp:
            kept = (t, stamp, t.detach().to(self.dtype))
            self._compute_copies[id(t)] = kept
        return kept[2]


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
