"""Seeded random initialisation of a module's parameters, in place, on their device."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["init_random_"]


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Matrices and kernels ~ N(0, 1/fan_in) (fan_in = all dims but the first,
    as torch lays out Linear, Conv and Embedding weights), biases 0, norm
    scales 1. ``generator`` must live on the parameters' device, so a model
    on a card is initialised there without a host copy."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return module
