"""AdamW with the reference's decay / no-decay split.

Port of ``text_to_sound_synthesis_tpu/engine/optimizers.py``. Weight decay
goes to the weights of ``nn.Linear`` and ``nn.Conv*`` only: the JAX package's
``decay_mask`` picks the flax leaves named ``kernel``, which are exactly the
Dense and Conv kernels. Biases, LayerNorm weights and every embedding table
(the 2-D token, position and timestep tables included: a rule by ``ndim``
would be wrong) take none (the minGPT bucketing,
``diffusion_transformer.py:483-537``).

The optimizer is ``torch.optim.AdamW`` over two parameter groups, decay
first, each in the sorted order of the parameters' names, as the reference
builds them, so a reference optimizer state loads by position. Its update is
optax's ``adamw``: bias-corrected moments, eps added after the square root,
decay lr * wd * p applied beside the Adam step (optax adds it to the update,
torch scales p by 1 - lr * wd first: the same step up to rounding). The
learning rate is set on the groups before each step from the host-side
scheduler (``set_learning_rate``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch
from torch import nn

__all__ = ["decay_mask", "param_groups", "build_optimizer", "set_learning_rate"]

_DECAY_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d,
                  nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def decay_mask(module: nn.Module) -> Dict[str, bool]:
    """{parameter name: True when it takes weight decay}: the ``weight`` of a
    Linear or Conv module."""
    decay = {f"{mn}.{pn}" if mn else pn: isinstance(m, _DECAY_MODULES) and pn == "weight"
             for mn, m in module.named_modules() for pn, _ in m.named_parameters(recurse=False)}
    names = [n for n, _ in module.named_parameters()]
    if sorted(decay) != sorted(names):
        raise ValueError("decay_mask: a parameter is shared or unnamed")
    return {n: decay[n] for n in names}


def param_groups(module: nn.Module, weight_decay: float) -> List[dict]:
    """[decay group, no-decay group] of the trainable parameters, each sorted by name."""
    mask = decay_mask(module)
    params = {n: p for n, p in module.named_parameters() if p.requires_grad}
    decay = [params[n] for n in sorted(params) if mask[n]]
    no_decay = [params[n] for n in sorted(params) if not mask[n]]
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def build_optimizer(optimizer_config: Mapping[str, Any], module: nn.Module,
                    base_lr: float) -> torch.optim.Optimizer:
    """The config's solver block (caps.yaml:109-120): ``{'target':
    'torch.optim.AdamW' | 'adamw' | 'adam', 'params': {betas, weight_decay, eps}}``."""
    params = dict(optimizer_config.get("params") or {})
    target = str(optimizer_config.get("target", "adamw")).lower()
    betas = tuple(float(b) for b in params.get("betas", (0.9, 0.96)))
    wd = float(params.get("weight_decay", 0.0))
    eps = float(params.get("eps", 1e-8))
    if "adamw" in target:
        return torch.optim.AdamW(param_groups(module, wd), lr=base_lr, betas=betas, eps=eps)
    if "adam" in target:
        return torch.optim.Adam(param_groups(module, 0.0), lr=base_lr, betas=betas, eps=eps)
    raise ValueError(f"unsupported optimizer target {optimizer_config.get('target')!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
