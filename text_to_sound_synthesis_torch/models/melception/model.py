"""Melception: InceptionV3 retrained on 1-channel mel spectrograms (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/melception/model.py``. Parity
target: ``Melception`` (``Codebook/evaluation/feature_extractors/melception.py:5``)
— torchvision Inception3 with (a) a 1-channel stem conv, (b) both stem
max-pools removed (mel height is 80, not 299), (c) 309 VGGSound classes, and
the feature taps '64', '192', '768', '2048', 'logits_unbiased' and 'logits'
used by the FID/ISc/KID/KL suite.

NCHW, under torchvision's Inception3 names (``Conv2d_1a_3x3.conv.weight``,
``Conv2d_1a_3x3.bn.{weight,bias,running_mean,running_var}``, ...,
``fc.weight`` / ``fc.bias``): a released melception ``.pt``'s ``model`` state
dict loads as it is (``load_melception_checkpoint``). BasicConv2d is conv (no
bias) + ``BatchNorm2d(eps=1e-3)`` + ReLU; the module runs in eval mode, so
the BatchNorm is the running statistics' affine, which the JAX package folds
into ``bn_scale`` / ``bn_shift``. The pools keep torchvision's: the branch
avg-pool is 3x3, stride 1, zero pad 1, the pad counted in the mean; the
reduction max-pools are 3x3, stride 2, no pad.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.config import register

__all__ = ["Melception", "BasicConv2d", "InceptionA", "InceptionB", "InceptionC",
           "InceptionD", "InceptionE", "load_melception_checkpoint", "TAPS"]

#: every feature tap, in the order the forward reaches them
TAPS = ("64", "192", "768", "2048", "logits_unbiased", "logits")

_Pair = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm2d(eps=1e-3) + relu."""

    def __init__(self, cin: int, cout: int, kernel_size: _Pair, stride: _Pair = 1,
                 padding: _Pair = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avgpool3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _maxpool3s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                     self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avgpool3(x))
        return torch.cat([b1, b3, bd, bp], 1)


_STEM = (("Conv2d_1a_3x3", 1, 32, 3, 2, 0), ("Conv2d_2a_3x3", 32, 32, 3, 1, 0),
         ("Conv2d_2b_3x3", 32, 64, 3, 1, 1), ("Conv2d_3b_1x1", 64, 80, 1, 1, 0),
         ("Conv2d_4a_3x3", 80, 192, 3, 1, 0))


@register(
    "text_to_sound_synthesis_tpu.models.melception.Melception",
    "evaluation.feature_extractors.melception.Melception",
)
class Melception(nn.Module):
    """mel (B, 80, T) standardized -> the requested feature dict. The stem's
    maxpool1 / maxpool2 are gone (melception.py:15-16). The weights path is
    kept for config parity; load a released file with
    ``load_melception_checkpoint``."""

    def __init__(self, num_classes: int = 309,
                 features_list: Sequence[str] = ("logits_unbiased", "2048", "logits"),
                 feature_extractor_weights_path: Optional[str] = None):
        super().__init__()
        self.features_list = tuple(features_list)
        self.feature_extractor_weights_path = feature_extractor_weights_path
        for name, cin, cout, k, s, p in _STEM:
            setattr(self, name, BasicConv2d(cin, cout, k, stride=s, padding=p))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, num_classes)
        self.eval()     # a feature extractor: BatchNorm on its running statistics

    def forward(self, mel: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats: Dict[str, torch.Tensor] = {}
        want = self.features_list

        def tap(name, x):
            if name in want:
                feats[name] = x.mean(dim=(2, 3))

        x = mel[:, None]                                    # NCHW, one channel
        for name, *_ in _STEM[:3]:
            x = getattr(self, name)(x)
        tap("64", x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        tap("192", x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e"):
            x = getattr(self, name)(x)
        tap("768", x)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pooled = x.mean(dim=(2, 3))                         # adaptive avg pool to 1x1
        if "2048" in want:
            feats["2048"] = pooled
        logits_unbiased = pooled @ self.fc.weight.t()
        if "logits_unbiased" in want:
            feats["logits_unbiased"] = logits_unbiased
        if "logits" in want:
            feats["logits"] = logits_unbiased + self.fc.bias
        return feats


def load_melception_checkpoint(model: Melception, path: str) -> Melception:
    """Load a released melception ``.pt`` (``{"model": state_dict}``, or a
    bare state dict) into ``model`` with ``strict=True``. torchvision's
    auxiliary classifier (``AuxLogits.*``), which only its training forward
    reads, is left out where the file has one; every other name must match."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    sd = {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")}
    device = next(model.parameters()).device
    model.load_state_dict({k: v.to(device) for k, v in sd.items()}, strict=True)
    return model
