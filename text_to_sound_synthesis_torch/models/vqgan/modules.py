"""SpecVQGAN conv encoder/decoder stacks (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/vqgan/modules.py`` (reference
taming-style stacks, ``specvqgan/modules/diffusionmodules/model.py``):
GroupNorm(32) + swish ResNet blocks, single-head self-attention at the
coarsest time resolution, stride-2 conv downsampling with the (0,1,0,1)
asymmetric pad, nearest-neighbour 2x upsampling.

Module names are the reference's (``down.N.block.M``, ``mid.attn_1``,
``up.N.upsample``, ``nin_shortcut``, ...). Activations are NCHW inside;
``VQModel`` keeps the JAX package's NHWC at its public methods.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

__all__ = ["GroupNorm32", "ResnetBlock", "AttnBlock", "Upsample", "Downsample",
           "Encoder", "Decoder"]


def swish(x):
    return x * torch.sigmoid(x)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32, eps=1e-6, affine) — ``Normalize`` (model.py:34). Small
    test widths fall back to gcd(C, 32) groups, as in the JAX package."""

    def __init__(self, channels: int):
        super().__init__(math.gcd(channels, 32), channels, eps=1e-6)


def _conv3(cin: int, cout: int, stride: int = 1, padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding)


class ResnetBlock(nn.Module):
    """norm-swish-conv x2 with a 1x1 projection shortcut (model.py:92-151);
    dropout before the second conv, acting in training mode."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = _conv3(in_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = _conv3(out_channels, out_channels)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(self.dropout(swish(self.norm2(h))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the (H, W) grid (model.py:174-226)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(channels, channels, 1) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(B, C, H * W)
        k = self.k(h).reshape(B, C, H * W)
        v = self.v(h).reshape(B, C, H * W)
        att = (q.transpose(1, 2) @ k) * (C ** -0.5)              # (B, i, j)
        att = torch.softmax(att.float(), dim=-1).to(v.dtype)
        h = (v @ att.transpose(1, 2)).reshape(B, C, H, W)        # sum_j att[i,j] v[:, j]
        return x + self.proj_out(h)


class Upsample(nn.Module):
    """2x nearest-neighbour upsample + 3x3 conv (model.py:37-52)."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = _conv3(channels, channels)

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample(nn.Module):
    """Stride-2 conv with bottom/right padding (model.py:60-77), or 2x2 average pooling."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = _conv3(channels, channels, stride=2, padding=0)

    def forward(self, x):
        if hasattr(self, "conv"):
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class _Level(nn.Module):
    """One resolution level: ``block`` ResNets, ``attn`` blocks, and a resampler."""

    def __init__(self, blocks, attns):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)


class _Mid(nn.Module):
    def __init__(self, channels: int, dropout: float = 0.0):
        super().__init__()
        self.block_1 = ResnetBlock(channels, dropout=dropout)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, dropout=dropout)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class Encoder(nn.Module):
    """Mel (B, 1, n_mels, T) -> latent (B, z_channels, n_mels/16, T/16), NCHW."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (53,),
                 resamp_with_conv: bool = True, in_channels: int = 1,
                 resolution: int = 848, z_channels: int = 256, double_z: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.conv_in = _conv3(in_channels, ch)
        curr_res, block_in = resolution, ch
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            block_out = ch * mult
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, block_out, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            level = _Level(blocks, attns)
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, dropout)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = _conv3(block_in, 2 * z_channels if double_z else z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(swish(self.norm_out(h)))


class Decoder(nn.Module):
    """Latent (B, z_channels, h, w) -> mel (B, out_ch, H, W), NCHW."""

    def __init__(self, ch: int = 128, out_ch: int = 1, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (53,),
                 resamp_with_conv: bool = True, resolution: int = 848,
                 z_channels: int = 256, give_pre_end: bool = False, dropout: float = 0.0):
        super().__init__()
        self.give_pre_end = give_pre_end
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (len(ch_mult) - 1)
        self.conv_in = _conv3(z_channels, block_in)
        self.mid = _Mid(block_in, dropout)
        levels = [None] * len(ch_mult)
        for i_level in reversed(range(len(ch_mult))):
            block_out = ch * ch_mult[i_level]
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, block_out, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in))
            level = _Level(blocks, attns)
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = _conv3(block_in, out_ch)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if self.give_pre_end:
            return h
        return self.conv_out(swish(self.norm_out(h)))
