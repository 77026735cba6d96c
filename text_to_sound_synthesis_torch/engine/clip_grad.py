"""Iteration-gated global-norm gradient clipping.

Port of ``text_to_sound_synthesis_tpu/engine/clip_grad.py`` (reference
``ClipGradNorm``, ``Diffsound/sound_synthesis/engine/clip_grad_norm.py:8-35``).
The reference's conditions are OR-ed, not a window: clip when ``iteration >=
start_iteration`` OR (``end_iteration > 0`` AND ``iteration < end_iteration``),
so with the flagship's (start 0, end 5000, max_norm 0.5) it clips at every
iteration, and with the default ``end_iteration=-1`` too (via start 0). Kept as
it is. The iteration is the host's step count, so the gate costs no wait for
the device; the norm and the scale stay on the device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..utils.config import register

__all__ = ["ClipGradNorm", "clip_by_global_norm"]


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        active: bool) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / (norm + 1e-6)) when
    ``active``; return the global norm sqrt(sum g^2) (a device scalar)."""
    if not grads:
        raise ValueError("no gradients to clip")
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))
    if active:
        torch._foreach_mul_(list(grads), torch.clamp(max_norm / (gnorm + 1e-6), max=1.0))
    return gnorm


@register(
    "text_to_sound_synthesis_tpu.engine.ClipGradNorm",
    "sound_synthesis.engine.clip_grad_norm.ClipGradNorm",
)
class ClipGradNorm:
    def __init__(self, start_iteration: int = 0, end_iteration: int = -1,
                 max_norm: float = 0.5):
        self.start_iteration = start_iteration
        self.end_iteration = end_iteration
        self.max_norm = max_norm

    def active(self, iteration: int) -> bool:
        """The reference's OR-ed conditions (module docstring)."""
        on = iteration >= self.start_iteration
        if self.end_iteration > 0:
            on = on or iteration < self.end_iteration
        return on

    def __call__(self, grads: Sequence[torch.Tensor], iteration: int) -> torch.Tensor:
        """Clip ``grads`` in place at step ``iteration``; returns the global norm."""
        return clip_by_global_norm(grads, self.max_norm, self.active(iteration))
