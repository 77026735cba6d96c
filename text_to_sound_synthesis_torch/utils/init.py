"""Seeded random initialisation of a module's parameters, in place, on their device."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["init_random_", "lecun_normal_"]

# the standard deviation of a standard normal truncated to [-2, 2] (flax's
# variance_scaling divides by it, so a truncated draw keeps its variance)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(p: torch.Tensor, generator: torch.Generator,
                  draw_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: a standard normal truncated to [-2, 2]
    (drawn in f32, rounded to ``draw_dtype`` if given), scaled to variance
    1/fan_in, fan_in all dims but the first (torch's Linear and Conv layout)."""
    w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    w.mul_(p[0].numel() ** -0.5 / _TRUNC_STD)
    return p.copy_(w if draw_dtype is None else w.to(draw_dtype))


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator,
                 draw_dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The JAX package's flax defaults: Linear and Conv weights as
    ``lecun_normal`` (``lecun_normal_``: truncated at 2 sigma, variance
    1/fan_in), every other matrix or table ~ N(0, 1/fan_in) (fan_in = all
    dims but the first, as torch lays out Linear, Conv and Embedding weights;
    flax's ``nn.Embed`` draws N(0, 1/features)), biases 0, norm scales 1. A
    module's parameters named in its ``ZERO_INIT`` (a tuple of names of its
    own parameters) are 0, as the JAX package's ``self.param(..., zeros,
    ...)`` leaves them. ``generator`` must live on the parameters'
    device, so a model on a card is initialised there without a host copy.
    With ``draw_dtype`` the parameters hold values of that dtype: the normal
    draws are made in it, the truncated ones in f32 and rounded to it."""
    lecun, zero = set(), set()
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)):
            lecun.add(id(m.weight))
        zero.update(id(p) for n, p in m.named_parameters(recurse=False)
                    if n in getattr(m, "ZERO_INIT", ()))
    for name, p in module.named_parameters():
        std = p[0].numel() ** -0.5 if p.dim() >= 2 else 0.0
        if id(p) in zero:
            p.zero_()
        elif id(p) in lecun:
            lecun_normal_(p, generator, draw_dtype)
        elif p.dim() >= 2:
            if draw_dtype is None or draw_dtype == p.dtype:
                p.normal_(0.0, std, generator=generator)
            else:
                p.copy_(torch.empty_like(p, dtype=draw_dtype).normal_(0.0, std, generator=generator))
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    return module
