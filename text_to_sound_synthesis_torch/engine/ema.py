"""EMA of the trainable parameters.

Port of ``text_to_sound_synthesis_tpu/engine/ema.py`` (reference ``EMA``,
``Diffsound/sound_synthesis/engine/ema.py:8-70``): decay 0.99 every
``update_interval`` (25) optimizer steps, over the diffusion transformer's
trainable parameters. The shadow is a copy of them on the device, made at
creation (never an alias), and is updated in place.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["ema_copy", "ema_update"]


def ema_copy(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A shadow: each parameter copied (detached, its own storage)."""
    return [p.detach().clone() for p in params]


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float) -> None:
    """shadow <- decay * shadow + (1 - decay) * params, in place: the JAX
    package's two products and one sum, in that order."""
    ema_params = list(ema_params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, torch._foreach_mul([p.detach() for p in params],
                                                       1.0 - decay))
