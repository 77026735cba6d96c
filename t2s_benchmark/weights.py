"""Seeded weights, made on the device in a few large draws.

flax's defaults, as the JAX package draws them: Linear and Conv weights
``lecun_normal`` (a standard normal truncated to [-2, 2], scaled to variance
1/fan_in), every other matrix or table N(0, 1/fan_in), biases 0, norm
scales 1, and the parameters a module names in ``ZERO_INIT`` 0. fan_in is
every dimension but the first (torch's Linear, Conv and Embedding layouts).
All truncated draws come from one call and all normal ones from another, on
the card, and each parameter is a scaled slice of them.
"""

import torch
from torch import nn

TRUNC_STD = 0.87962566103423978    # std of a standard normal truncated to [-2, 2]


def _kinds(module: nn.Module) -> dict:
    lecun, zero = set(), set()
    for mn, m in module.named_modules():
        for pn, _ in m.named_parameters(recurse=False):
            full = f"{mn}.{pn}" if mn else pn
            if pn in getattr(m, "ZERO_INIT", ()):
                zero.add(full)
            elif isinstance(m, (nn.Linear, nn.modules.conv._ConvNd)) and pn == "weight":
                lecun.add(full)
    kinds = {}
    for name, p in module.named_parameters():
        if name in zero:
            kinds[name] = "zero"
        elif name in lecun:
            kinds[name] = "lecun"
        elif p.dim() >= 2:
            kinds[name] = "normal"
        else:
            kinds[name] = "zero" if name.endswith("bias") else "one"
    return kinds


@torch.no_grad()
def seeded_weights(module: nn.Module, seed: int, device) -> dict:
    """{parameter name: float32 tensor on ``device``} for ``module``'s
    parameters (the module itself may live on the meta device)."""
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    kinds = _kinds(module)
    gen = torch.Generator(device).manual_seed(int(seed))
    out = {}
    for kind in ("lecun", "normal"):
        names = [n for n in shapes if kinds[n] == kind]
        total = sum(torch.Size(shapes[n]).numel() for n in names)
        flat = torch.empty(total, dtype=torch.float32, device=device)
        if kind == "lecun":
            nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
        else:
            flat.normal_(0.0, 1.0, generator=gen)
        off = 0
        for n in names:
            shape = shapes[n]
            size = torch.Size(shape).numel()
            scale = (size // shape[0]) ** -0.5 / (TRUNC_STD if kind == "lecun" else 1.0)
            out[n] = flat[off:off + size].view(shape).mul_(scale)
            off += size
    for n, shape in shapes.items():
        if kinds[n] == "zero":
            out[n] = torch.zeros(shape, device=device)
        elif kinds[n] == "one":
            out[n] = torch.ones(shape, device=device)
    return {n: out[n] for n in shapes}


def materialize(module: nn.Module, weights: dict, device) -> nn.Module:
    """``module`` (on the meta device) given storage on ``device`` and ``weights``."""
    module = module.to_empty(device=device)
    module.load_state_dict(weights)
    return module
