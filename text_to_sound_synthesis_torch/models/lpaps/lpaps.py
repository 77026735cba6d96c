"""LPAPS: the learned perceptual loss on spectrograms (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/lpaps/lpaps.py`` (reference
``specvqgan/modules/losses/lpaps.py:17-97``): per-mel-bin standardisation
(``scaling_layer``: shift, scale), the frozen VGGishish's five slices
(``net.slice1..5``, the reference's feature indices), unit-normalisation
over channels with 1e-10, squared differences through the 1x1 no-bias
``lin0..4`` heads, the spatial mean, summed over the slices. LPAPS is frozen:
its parameters take no gradient, the reconstruction takes one through it.
"""

from __future__ import annotations

import torch
from torch import nn

from ...utils.config import register
from .vggishish import VGG16_LAYERS, tap_indices, vgg_features

__all__ = ["LPAPS", "CHANNELS"]

CHANNELS = (64, 128, 256, 512, 512)


class _ScalingLayer(nn.Module):
    def __init__(self, n_mels: int):
        super().__init__()
        # from the released vggishish_mean_std file: [0, 1] stats -> shift = 2 m - 1, scale = 2 s
        self.register_buffer("shift", torch.zeros(n_mels))
        self.register_buffer("scale", torch.ones(n_mels))


class _NetLin(nn.Module):
    """The reference's ``NetLinLayer``: (dropout,) 1x1 conv without bias."""

    def __init__(self, chn: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(0.0), nn.Conv2d(chn, 1, 1, bias=False))


class _VGGSlices(nn.Module):
    """``vggishish16``: the VGG16 features cut after each tap."""

    def __init__(self):
        super().__init__()
        layers = vgg_features(VGG16_LAYERS)
        cuts = [0] + [i + 1 for i in tap_indices(VGG16_LAYERS)]
        for s in range(5):
            sl = nn.Sequential()
            for i in range(cuts[s], cuts[s + 1]):
                sl.add_module(str(i), layers[i])
            setattr(self, f"slice{s + 1}", sl)

    def forward(self, x):
        feats = []
        for s in range(5):
            x = getattr(self, f"slice{s + 1}")(x)
            feats.append(x)
        return feats


@register(
    "text_to_sound_synthesis_tpu.models.lpaps.LPAPS",
    "specvqgan.modules.losses.lpaps.LPAPS",
    "specvqgan.modules.losses.lpaps_audioset.LPLoss",
)
class LPAPS(nn.Module):
    def __init__(self, n_mels: int = 80):
        super().__init__()
        self.scaling_layer = _ScalingLayer(n_mels)
        self.net = _VGGSlices()
        for i, c in enumerate(CHANNELS):
            setattr(self, f"lin{i}", _NetLin(c))
        self.requires_grad_(False)

    @torch.no_grad()
    def init_heads_(self) -> "LPAPS":
        """The JAX package's init of the standardisation and the heads: shift 0,
        scale 1, every ``lin`` weight 1 (the VGG convs are set apart)."""
        self.scaling_layer.shift.zero_()
        self.scaling_layer.scale.fill_(1.0)
        for i in range(len(CHANNELS)):
            getattr(self, f"lin{i}").model[1].weight.fill_(1.0)
        return self

    def forward(self, inputs: torch.Tensor, reconstructions: torch.Tensor) -> torch.Tensor:
        """Both (B, H, W, 1) in [-1, 1], H the mel bins -> (B,) distances."""
        sh = self.scaling_layer.shift[None, None, :, None]
        sc = self.scaling_layer.scale[None, None, :, None]
        f0 = self.net((inputs.permute(0, 3, 1, 2) - sh) / sc)
        f1 = self.net((reconstructions.permute(0, 3, 1, 2) - sh) / sc)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            na = a / (torch.sqrt((a ** 2).sum(dim=1, keepdim=True)) + 1e-10)
            nb = b / (torch.sqrt((b ** 2).sum(dim=1, keepdim=True)) + 1e-10)
            head = getattr(self, f"lin{i}").model((na - nb) ** 2)
            total = total + head.mean(dim=(1, 2, 3))
        return total
