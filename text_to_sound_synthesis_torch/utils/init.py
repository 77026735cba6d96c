"""Seeded random initialisation of a module's parameters, in place, on their device."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["init_random_"]


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator,
                 draw_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """Matrices and kernels ~ N(0, 1/fan_in) (fan_in = all dims but the first,
    as torch lays out Linear, Conv and Embedding weights), biases 0, norm
    scales 1. ``generator`` must live on the parameters' device, so a model
    on a card is initialised there without a host copy. With ``draw_dtype``
    the normal draws are made in that dtype and then copied in (the values a
    model stored in that dtype would hold)."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            if draw_dtype is None or draw_dtype == p.dtype:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
            else:
                p.copy_(torch.empty_like(p, dtype=draw_dtype).normal_(
                    0.0, p[0].numel() ** -0.5, generator=generator))
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return module
