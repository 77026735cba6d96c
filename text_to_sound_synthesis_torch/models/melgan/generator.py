"""MelGAN generator: 80-ch log-mel -> waveform at 256x upsampling (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/melgan/generator.py`` (reference
``Diffsound/vocoder/modules.py:88-130``): reflection-pad + 7-conv stem,
ConvTranspose1d stages with ratios [8, 8, 2, 2] (kernel 2r, stride r,
padding r//2 + r%2, output_padding r%2), 3 dilated residual units (dilation
3^j) per stage, LeakyReLU(0.2), tanh output.

The layers sit in the reference's flat ``model`` Sequential, so the state dict
of a released ``best_netG.pt`` loads once its weight norm is folded into
plain ``weight`` tensors. The transposed convs are native
``nn.ConvTranspose1d``; the JAX package's polyphase rewrite is a TPU device.
Layout is NCW: mel (B, 80, T) -> wav (B, 1, T*256).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...utils.config import register

__all__ = ["MelGANGenerator", "ResnetBlock"]


class ResnetBlock(nn.Module):
    """LeakyReLU -> reflect-pad -> dilated 3-conv -> LeakyReLU -> 1-conv, plus a
    1x1 shortcut (modules.py:72-85)."""

    def __init__(self, dim: int, dilation: int = 1):
        super().__init__()
        self.block = nn.Sequential(
            nn.LeakyReLU(0.2),
            nn.ReflectionPad1d(dilation),
            nn.Conv1d(dim, dim, 3, dilation=dilation),
            nn.LeakyReLU(0.2),
            nn.Conv1d(dim, dim, 1),
        )
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x):
        return self.shortcut(x) + self.block(x)


@register(
    "text_to_sound_synthesis_tpu.models.melgan.MelGANGenerator",
    "vocoder.modules.Generator",
)
class MelGANGenerator(nn.Module):
    def __init__(self, input_size: int = 80, ngf: int = 32, n_residual_layers: int = 3,
                 ratios: Sequence[int] = (8, 8, 2, 2)):
        super().__init__()
        self.input_size = input_size
        mult = int(2 ** len(ratios))
        layers = [nn.ReflectionPad1d(3), nn.Conv1d(input_size, mult * ngf, 7)]
        for r in ratios:
            layers += [
                nn.LeakyReLU(0.2),
                nn.ConvTranspose1d(mult * ngf, mult * ngf // 2, kernel_size=2 * r, stride=r,
                                   padding=r // 2 + r % 2, output_padding=r % 2),
            ]
            layers += [ResnetBlock(mult * ngf // 2, dilation=3 ** j)
                       for j in range(n_residual_layers)]
            mult //= 2
        layers += [nn.LeakyReLU(0.2), nn.ReflectionPad1d(3), nn.Conv1d(ngf, 1, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        """mel (B, input_size, T) -> wav (B, 1, T*prod(ratios)) in [-1, 1]."""
        return self.model(mel)
