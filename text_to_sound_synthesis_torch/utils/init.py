"""Seeded random initialisation of a module's parameters, in place, on their device."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["init_random_"]

# the standard deviation of a standard normal truncated to [-2, 2] (flax's
# variance_scaling divides by it, so a truncated draw keeps its variance)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator,
                 draw_dtype: Optional[torch.dtype] = None,
                 lecun_normal: bool = False) -> nn.Module:
    """Matrices and kernels ~ N(0, 1/fan_in) (fan_in = all dims but the first,
    as torch lays out Linear, Conv and Embedding weights), biases 0, norm
    scales 1. With ``lecun_normal`` the Linear and Conv weights are drawn as
    flax's default ``lecun_normal`` instead (the JAX package's ``nn.Dense`` /
    ``nn.Conv`` init): a standard normal truncated to [-2, 2], scaled to
    variance 1/fan_in. ``generator`` must live on the parameters' device, so
    a model on a card is initialised there without a host copy. With
    ``draw_dtype`` the parameters hold values of that dtype: the normal
    draws are made in it, the truncated ones in f32 and rounded to it."""
    lecun = {id(m.weight) for m in module.modules()
             if lecun_normal and isinstance(m, (nn.Linear, nn.modules.conv._ConvNd))}
    for name, p in module.named_parameters():
        std = p[0].numel() ** -0.5 if p.dim() >= 2 else 0.0
        if id(p) in lecun:
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.mul_(std / _TRUNC_STD)
            p.copy_(w if draw_dtype is None else w.to(draw_dtype))
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
