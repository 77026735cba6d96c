"""PatchGAN discriminators for Stage-1 adversarial training (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/discriminator.py`` (reference
``specvqgan/modules/discriminator/model.py``): ``NLayerDiscriminator``
(pix2pix: 4x4 stride-2 convs, BatchNorm or ActNorm, LeakyReLU 0.2, a
1-channel logit map; conv biases only with ActNorm) and its 1-D variants
over feature and spectrogram sequences. The layers sit in the reference's
``main`` Sequential, so a reference state dict loads as it is and
``convert/torch_to_jax.py::convert_discriminator`` reads the port's.

BatchNorm trains as flax's ``BatchNorm(momentum=0.9)`` does in the JAX
package (``FlaxBatchNorm2d`` / ``1d``): the batch's mean and biased variance
(E[x^2] - E[x]^2, floored at 0) normalise, and the running averages take
0.9 old + 0.1 new with that biased variance (torch's BatchNorm puts the
unbiased variance there); torch's ``momentum`` m is flax's 1 - m, so
``momentum=0.01`` is flax's default 0.99 (``VGGishish(use_bn=True)``). Forwards inside ``frozen_batch_stats`` normalise
with the batch's statistics and leave the running ones untouched, as the JAX
step discards the updates of its generator-phase forwards. With a process
group set (``set_batch_stats_group``) the sums are all-reduced, so the
statistics are the global batch's, as under the JAX package's SPMD step, and
the gradient runs through the all-reduce.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..utils.config import register
from ..utils.init import lecun_normal_

__all__ = ["ActNorm", "FlaxBatchNorm1d", "FlaxBatchNorm2d", "NLayerDiscriminator",
           "NLayerDiscriminator1dFeats", "NLayerDiscriminator1dSpecs", "frozen_batch_stats",
           "set_batch_stats_group", "init_discriminator_"]


class _FlaxStats:
    """The flax training forward of a torch BatchNorm (module docstring)."""

    update_stats = True
    stats_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        n = x.numel() // x.shape[1]
        sums = torch.cat([x.sum(dims), (x * x).sum(dims)])
        if self.stats_group is not None:
            from torch.distributed.nn.functional import all_reduce

            sums = all_reduce(sums, group=self.stats_group)
            n *= dist.get_world_size(self.stats_group)
        mean, mean2 = (sums / n).chunk(2)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class FlaxBatchNorm2d(_FlaxStats, nn.BatchNorm2d):
    pass


class FlaxBatchNorm1d(_FlaxStats, nn.BatchNorm1d):
    pass


def _batch_norms(module: nn.Module) -> List[_FlaxStats]:
    return [m for m in module.modules() if isinstance(m, _FlaxStats)]


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Forwards in the block normalise with their batch's statistics and
    leave the running averages of ``module``'s BatchNorms as they are."""
    norms = _batch_norms(module)
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def set_batch_stats_group(module: nn.Module, group) -> nn.Module:
    """Take ``module``'s BatchNorm statistics over ``group``'s global batch
    (None: this process's batch)."""
    for m in _batch_norms(module):
        m.stats_group = group
    return module


class ActNorm(nn.Module):
    """Per-channel affine ``scale * (x + loc)`` (reference ``ActNorm``,
    model.py:5-80, with its (1, C, 1, 1) parameters). Like the JAX package it
    starts at loc 0, scale 1 with no data-dependent init, so its
    ``initialized`` flag is set."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, num_features, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, num_features, 1, 1))
        self.register_buffer("initialized", torch.tensor(1, dtype=torch.uint8))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1, -1] + [1] * (x.dim() - 2)
        return self.scale.view(shape) * (x + self.loc.view(shape))


def _lrelu() -> nn.Module:
    return nn.LeakyReLU(0.2)


def _main(stages: List[Tuple[int, int, int]], conv, norm, first: Tuple[int, int],
          use_actnorm: bool) -> nn.Sequential:
    """conv(first) + LeakyReLU, then each (in, out, stride) stage as conv
    (bias only with ActNorm) + norm + LeakyReLU, then a 1-channel conv."""
    layers = [conv(first[0], first[1], 4, 2, 1), _lrelu()]
    for cin, cout, stride in stages:
        layers += [conv(cin, cout, 4, stride, 1, bias=use_actnorm),
                   ActNorm(cout) if use_actnorm else norm(cout), _lrelu()]
    layers.append(conv(stages[-1][1] if stages else first[1], 1, 4, 1, 1))
    return nn.Sequential(*layers)


@register(
    "text_to_sound_synthesis_tpu.models.NLayerDiscriminator",
    "specvqgan.modules.discriminator.model.NLayerDiscriminator",
)
class NLayerDiscriminator(nn.Module):
    """(B, H, W, input_nc) NHWC -> (B, h, w, 1) patch logits."""

    def __init__(self, input_nc: int = 1, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        super().__init__()
        stages, nf = [], 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            stages.append((ndf * prev, ndf * nf, 2))
        stages.append((ndf * nf, ndf * min(2 ** n_layers, 8), 1))
        self.main = _main(stages, nn.Conv2d, FlaxBatchNorm2d, (input_nc, ndf), use_actnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class _Disc1d(nn.Module):
    """The 1-D variants' body over (B, L, C) NWC sequences."""

    def __init__(self, first: Tuple[int, int], stages: List[Tuple[int, int, int]],
                 use_actnorm: bool):
        super().__init__()
        self.main = _main(stages, nn.Conv1d, FlaxBatchNorm1d, first, use_actnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x.transpose(1, 2)).transpose(1, 2)


@register(
    "text_to_sound_synthesis_tpu.models.NLayerDiscriminator1dFeats",
    "specvqgan.modules.discriminator.model.NLayerDiscriminator1dFeats",
)
class NLayerDiscriminator1dFeats(_Disc1d):
    """1-D PatchGAN over feature sequences (B, L, input_nc): the channels
    halve down to a floor of 8, divided by 2**n with ``n`` frozen at the last
    loop index for the two stride-1 tail convs (model.py:149-203)."""

    def __init__(self, input_nc: int = 2048, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        stages, nf, n = [], input_nc // 2, 1
        for n in range(1, n_layers):
            prev, nf = nf, max(nf // (2 ** n), 8)
            stages.append((prev, nf, 2))
        for _ in range(2):
            prev, nf = nf, max(nf // (2 ** n), 8)
            stages.append((prev, nf, 1))
        super().__init__((input_nc, input_nc // 2), stages, use_actnorm)


@register(
    "text_to_sound_synthesis_tpu.models.NLayerDiscriminator1dSpecs",
    "specvqgan.modules.discriminator.model.NLayerDiscriminator1dSpecs",
)
class NLayerDiscriminator1dSpecs(_Disc1d):
    """1-D PatchGAN over spectrograms with the mel bins as channels
    (model.py:205-259): (B, L, input_nc), or the codec's (B, input_nc, L, 1)."""

    def __init__(self, input_nc: int = 80, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False):
        stages, prev = [], ndf
        for n in range(1, n_layers):
            stages.append((prev, ndf * min(2 ** n, 8), 2))
            prev = ndf * min(2 ** n, 8)
        stages.append((prev, ndf * min(2 ** n_layers, 8), 1))
        super().__init__((input_nc, ndf), stages, use_actnorm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 4:        # (B, mel, T, 1) -> (B, T, mel)
            x = x[..., 0].transpose(1, 2)
        return super().forward(x)


@torch.no_grad()
def init_discriminator_(disc: nn.Module, generator: torch.Generator) -> nn.Module:
    """The training init from scratch, as the JAX package's: conv kernels
    flax's ``lecun_normal``, biases 0; BatchNorm scale 1, bias 0, running mean
    0 and variance 1; ActNorm loc 0, scale 1."""
    for m in disc.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, _FlaxStats):
            m.reset_parameters()
        elif isinstance(m, ActNorm):
            m.loc.zero_()
            m.scale.fill_(1.0)
    return disc
