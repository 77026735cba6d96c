"""MelGAN multi-scale discriminator (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/melgan/discriminator.py``
(reference ``Diffsound/vocoder/modules.py:133-199``): ``num_D``
discriminators at 1x, 2x, 4x ... average-pooled scales
(``AvgPool1d(4, 2, padding=1, count_include_pad=False)`` between them), each
a stack of grouped strided convs returning every feature map (the
feature-matching loss reads them) with the logit map last. The convs are
plain, without the reference's weight norm, as in the JAX package; the
module names are the reference's (``model.disc_i.model.layer_k``), so its
state dict loads once the weight norm is folded. Layout is NCW: wav (B, 1, T).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ...utils.config import register

__all__ = ["MelGANDiscriminator", "NLayerDiscriminator1d"]


class NLayerDiscriminator1d(nn.Module):
    def __init__(self, ndf: int = 16, n_layers: int = 4, downsampling_factor: int = 4):
        super().__init__()
        model = nn.ModuleDict()
        model["layer_0"] = nn.Sequential(nn.ReflectionPad1d(7), nn.Conv1d(1, ndf, 15),
                                         nn.LeakyReLU(0.2))
        nf, stride = ndf, downsampling_factor
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(nf * stride, 1024)
            model[f"layer_{n}"] = nn.Sequential(
                nn.Conv1d(nf_prev, nf, stride * 10 + 1, stride=stride, padding=stride * 5,
                          groups=nf_prev // 4),
                nn.LeakyReLU(0.2))
        nf_prev, nf = nf, min(nf * 2, 1024)
        model[f"layer_{n_layers + 1}"] = nn.Sequential(nn.Conv1d(nf_prev, nf, 5, padding=2),
                                                       nn.LeakyReLU(0.2))
        model[f"layer_{n_layers + 2}"] = nn.Conv1d(nf, 1, 3, padding=1)
        self.model = model

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """wav (B, 1, T) -> the feature maps (B, C, T'), the logit map last."""
        feats = []
        for layer in self.model.values():
            x = layer(x)
            feats.append(x)
        return feats


@register(
    "text_to_sound_synthesis_tpu.models.melgan.MelGANDiscriminator",
    "vocoder.modules.Discriminator",
)
class MelGANDiscriminator(nn.Module):
    def __init__(self, num_D: int = 3, ndf: int = 16, n_layers: int = 4,
                 downsampling_factor: int = 4):
        super().__init__()
        self.model = nn.ModuleDict({f"disc_{i}": NLayerDiscriminator1d(ndf, n_layers,
                                                                       downsampling_factor)
                                    for i in range(num_D)})
        self.downsample = nn.AvgPool1d(4, stride=2, padding=1, count_include_pad=False)

    def forward(self, x: torch.Tensor) -> List[List[torch.Tensor]]:
        """wav (B, 1, T) -> per scale, its feature maps."""
        results = []
        for disc in self.model.values():
            results.append(disc(x))
            x = self.downsample(x)
        return results
