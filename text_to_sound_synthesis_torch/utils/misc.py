"""Misc utilities: seeding, parameter-count reporting.

Port of ``text_to_sound_synthesis_tpu/utils/misc.py`` (reference
``Diffsound/sound_synthesis/utils/misc.py``: ``seed_everything:9``,
``get_model_parameters_info:57``). The counts take ``nn.Module``\\ s or
``state_dict``\\ s where the JAX package takes parameter pytrees.
"""

from __future__ import annotations

import random
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

__all__ = ["seed_everything", "get_model_parameters_info", "format_parameters_info"]


def seed_everything(seed: int | None) -> None:
    """Seed python and numpy, as the JAX package does. The port's random
    draws take explicit ``torch.Generator``\\ s: seed those where they are
    made."""
    if seed is None:
        return
    random.seed(seed)
    np.random.seed(seed)


def _count(part: Any) -> int:
    """Values in a module's parameters, or in a ``state_dict``'s tensors."""
    if isinstance(part, nn.Module):
        return sum(p.numel() for p in part.parameters())
    if isinstance(part, torch.Tensor):
        return part.numel()
    return sum(_count(v) for v in part.values())


def get_model_parameters_info(params: Any) -> Dict[str, Dict[str, int]]:
    """{'<part>': {'total': n}, ..., 'overall': {'total': sum}} for a dict of
    parts (the Diffsound composite's ``nn.Module``\\ s or ``state_dict``\\ s;
    a ``state_dict``'s parts are its tensors), or {'params': ...,
    'overall': ...} for one module; parts that are None are left out."""
    items = params.items() if isinstance(params, dict) else [("params", params)]
    info: Dict[str, Dict[str, int]] = {}
    total = 0
    for name, sub in items:
        if sub is None:
            continue
        n = _count(sub)
        info[name] = {"total": n}
        total += n
    info["overall"] = {"total": total}
    return info


def format_parameters_info(info: Dict[str, Dict[str, int]]) -> str:
    return "\n".join(f"{name}: {d['total'] / 1e6:.2f} M params" for name, d in info.items())
