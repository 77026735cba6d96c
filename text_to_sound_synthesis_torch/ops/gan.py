"""GAN loss primitives shared by Stage-1 (SpecVQGAN) and vocoder training.

Port of ``text_to_sound_synthesis_tpu/ops/gan.py`` (reference
``vqperceptual.py:19-36``'s ``hinge_d_loss`` / ``vanilla_d_loss`` /
``adopt_weight`` and the MelGAN hinge + feature-matching objective,
``Diffsound/vocoder/scripts/train.py:147-176``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["hinge_d_loss", "vanilla_d_loss", "hinge_g_loss", "adopt_weight",
           "feature_matching_l1"]


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    loss_real = torch.relu(1.0 - logits_real).mean()
    loss_fake = torch.relu(1.0 + logits_fake).mean()
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def hinge_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """Generator objective -E[D(fake)] (the VQGAN generator pass and MelGAN's)."""
    return -logits_fake.mean()


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0) -> float:
    """``weight`` once ``global_step`` reaches ``threshold``, else ``value``
    (the step is the host's count)."""
    return value if global_step < threshold else weight


def feature_matching_l1(feats_real: Sequence[Sequence[torch.Tensor]],
                        feats_fake: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """The reference-weighted feature-matching L1 (MelGAN train.py:167-176):
    each map but a scale's last (its logits) weighs 4 / (len(scale) - 2) x
    1 / num_D, which is 4 / (n_layers_D + 1) x 1 / num_D for MelGAN's
    n_layers_D + 3 maps a scale. The real maps take no gradient."""
    num_D = max(len(feats_fake), 1)
    total = 0.0
    for fr, ff in zip(feats_real, feats_fake):
        wt = (4.0 / max(len(ff) - 2, 1)) * (1.0 / num_D)
        for r, f in zip(fr[:-1], ff[:-1]):
            total = total + wt * (f - r.detach()).abs().mean()
    return total
