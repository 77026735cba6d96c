"""VGGishish: the VGG16-style classifier over mel spectrograms (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/lpaps/vggishish.py`` (reference
``specvqgan/modules/losses/vggishish/model.py:5-60`` and the 5-slice feature
splitter ``vggishish16``, ``lpaps.py:100-143``): the conv stack
[64, 64, MP, 128, 128, MP, 256 x 3, MP, 512 x 3, MP, 512 x 3] (3x3 convs,
ReLU, no BatchNorm in the LPAPS variant), torch's ``AdaptiveAvgPool2d`` to
(5, 10) and the 3-layer head over 309 VGGSound classes. The five feature
taps follow ReLU 1_2, 2_2, 3_3, 4_3 and 5_3. Layout is NCHW; the module
names are the reference's (``features.N``, ``classifier.{0,2,4}``).

``use_bn=True`` puts a BatchNorm between each conv and its ReLU, as the
reference's classifier variant does (``features`` then holds conv, BN,
ReLU a width), with flax's ``BatchNorm`` semantics, the JAX package's
(``models/discriminator.py::FlaxBatchNorm2d``): momentum 0.99, eps 1e-5, the
biased batch variance; the batch's statistics normalise in train mode only,
the running ones in eval mode.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
from torch import nn

from ...utils.config import register
from ..discriminator import FlaxBatchNorm2d

__all__ = ["VGGishish", "VGG16_LAYERS", "TAP_AFTER_CONV", "vgg_features"]

VGG16_LAYERS: Tuple[Union[int, str], ...] = (
    64, 64, "MP", 128, 128, "MP", 256, 256, 256, "MP", 512, 512, 512, "MP",
    512, 512, 512,
)
#: conv indices (in the conv-only sequence) after whose ReLU a feature tap fires
TAP_AFTER_CONV = (1, 3, 6, 9, 12)


def vgg_features(conv_layers: Sequence = VGG16_LAYERS, in_channels: int = 1,
                 use_bn: bool = False) -> List[nn.Module]:
    """The reference's ``features`` layers: Conv2d(3x3, pad 1) [+ BatchNorm]
    + ReLU per width, MaxPool2d(2, 2) per "MP"."""
    layers: List[nn.Module] = []
    cin = in_channels
    for v in conv_layers:
        if v == "MP":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers.append(nn.Conv2d(cin, int(v), 3, padding=1))
            if use_bn:
                layers.append(FlaxBatchNorm2d(int(v), eps=1e-5, momentum=0.01))
            layers.append(nn.ReLU())
            cin = int(v)
    return layers


def conv_indices(conv_layers: Sequence = VGG16_LAYERS, use_bn: bool = False) -> List[int]:
    """Index in ``features`` of each conv (its BatchNorm follows it)."""
    out, idx = [], 0
    for v in conv_layers:
        if v != "MP":
            out.append(idx)
        idx += 1 if v == "MP" else 2 + use_bn
    return out


def tap_indices(conv_layers: Sequence = VGG16_LAYERS, use_bn: bool = False) -> List[int]:
    """Index in ``features`` of the ReLU after each tapped conv."""
    convs = conv_indices(conv_layers, use_bn)
    return [convs[i] + 1 + use_bn for i in TAP_AFTER_CONV if i < len(convs)]


@register(
    "text_to_sound_synthesis_tpu.models.lpaps.VGGishish",
    "specvqgan.modules.losses.vggishish.model.VGGishish",
)
class VGGishish(nn.Module):
    def __init__(self, conv_layers: Sequence = VGG16_LAYERS, use_bn: bool = False,
                 num_classes: int = 309):
        super().__init__()
        self.features = nn.Sequential(*vgg_features(conv_layers, use_bn=use_bn))
        self.avgpool = nn.AdaptiveAvgPool2d((5, 10))
        width = [int(v) for v in conv_layers if v != "MP"][-1]
        self.classifier = nn.Sequential(
            nn.Linear(width * 5 * 10, 4096), nn.ReLU(), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))
        self._taps = set(tap_indices(conv_layers, use_bn))

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x (B, H, W) or (B, 1, H, W) standardized mel -> class logits
        (B, num_classes), or with ``return_features`` the five tapped
        activations (NCHW)."""
        if x.dim() == 3:
            x = x[:, None]
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self._taps:
                feats.append(x)
        if return_features:
            return feats
        return self.classifier(torch.flatten(self.avgpool(x), 1))
