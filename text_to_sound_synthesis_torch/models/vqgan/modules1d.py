"""1-D SpecVQGAN variants: codecs over feature sequences (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/vqgan/modules1d.py`` (reference
``specvqgan/modules/diffusionmodules/model.py``'s ``Encoder1d`` /
``Decoder1d`` / ``ResnetBlock1d`` / ``AttnBlock1d`` / ``Upsample1d`` /
``Downsample1d`` and ``VQModel1d``, ``models/vqgan.py:171``): the 2-D
stacks with 1-D convs over time and a symmetric (1, 1) pad before the
stride-2 downsampling conv. Module names are the 2-D port's; activations are
NCW inside, and ``VQModel1d``'s public methods keep the JAX package's (B, T,
C) layout.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...utils.config import register
from .modules import GroupNorm32, swish
from .quantize import VectorQuantizer, VQResult

__all__ = ["ResnetBlock1d", "AttnBlock1d", "Upsample1d", "Downsample1d", "Encoder1d",
           "Decoder1d", "VQModel1d"]


def _conv3(cin: int, cout: int, stride: int = 1, padding: int = 1) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, 3, stride=stride, padding=padding)


class ResnetBlock1d(nn.Module):
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
            self.nin_shortcut = nn.Conv1d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(swish(self.norm1(x)))
        h = self.conv2(self.dropout(swish(self.norm2(h))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock1d(nn.Module):
    """Single-head self-attention over time."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q, self.k, self.v, self.proj_out = (nn.Conv1d(channels, channels, 1)
                                                 for _ in range(4))

    def forward(self, x):
        C = x.shape[1]
        h = self.norm(x)
        q, k, v = self.q(h), self.k(h), self.v(h)                   # (B, C, T)
        att = (q.transpose(1, 2) @ k) * (C ** -0.5)                 # (B, i, j)
        att = torch.softmax(att.float(), dim=-1).to(v.dtype)
        return x + self.proj_out(v @ att.transpose(1, 2))


class Upsample1d(nn.Module):
    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = _conv3(channels, channels)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=-1)
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample1d(nn.Module):
    """Stride-2 conv after a symmetric (1, 1) pad (model.py:79-89), or pooling."""

    def __init__(self, channels: int, with_conv: bool = True):
        super().__init__()
        if with_conv:
            self.conv = _conv3(channels, channels, stride=2, padding=0)

    def forward(self, x):
        if hasattr(self, "conv"):
            return self.conv(F.pad(x, (1, 1)))
        return F.avg_pool1d(x, 2, 2)


class _Level(nn.Module):
    def __init__(self, blocks, attns):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)


class _Mid(nn.Module):
    def __init__(self, channels: int, dropout: float):
        super().__init__()
        self.block_1 = ResnetBlock1d(channels, dropout=dropout)
        self.attn_1 = AttnBlock1d(channels)
        self.block_2 = ResnetBlock1d(channels, dropout=dropout)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


def _run_level(level: _Level, h):
    for i, blk in enumerate(level.block):
        h = blk(h)
        if len(level.attn):
            h = level.attn[i](h)
    return h


class Encoder1d(nn.Module):
    """(B, in_channels, T) -> (B, z_channels, T / 2^(levels-1))."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True, in_channels: int = 2048,
                 resolution: int = 212, z_channels: int = 256, double_z: bool = False):
        super().__init__()
        self.conv_in = _conv3(in_channels, ch)
        curr_res, block_in = resolution, ch
        self.down = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            block_out = ch * mult
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock1d(block_in, block_out, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock1d(block_in))
            level = _Level(blocks, attns)
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample1d(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in, dropout)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = _conv3(block_in, 2 * z_channels if double_z else z_channels)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = _run_level(level, h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(swish(self.norm_out(self.mid(h))))


class Decoder1d(nn.Module):
    """(B, z_channels, t) -> (B, out_ch, t * 2^(levels-1))."""

    def __init__(self, ch: int = 128, out_ch: int = 2048, ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True, resolution: int = 212,
                 z_channels: int = 256, give_pre_end: bool = False):
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
                blocks.append(ResnetBlock1d(block_in, block_out, dropout))
                block_in = block_out
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock1d(block_in))
            level = _Level(blocks, attns)
            if i_level != 0:
                level.upsample = Upsample1d(block_in, resamp_with_conv)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(block_in)
        self.conv_out = _conv3(block_in, out_ch)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = _run_level(level, h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        if self.give_pre_end:
            return h
        return self.conv_out(swish(self.norm_out(h)))


@register(
    "text_to_sound_synthesis_tpu.models.vqgan.VQModel1d",
    "specvqgan.models.vqgan.VQModel1d",
)
class VQModel1d(nn.Module):
    """Feature-sequence tokenizer: (B, T, C_feat) <-> token ids (B, t)."""

    def __init__(self, ddconfig: Mapping[str, Any], n_embed: int = 1024, embed_dim: int = 256,
                 ckpt_path=None, lossconfig=None, ignore_keys=(), image_key: str = "feature",
                 monitor=None):
        super().__init__()
        dd = dict(ddconfig)
        common = dict(ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
                      num_res_blocks=dd["num_res_blocks"],
                      attn_resolutions=tuple(dd.get("attn_resolutions", ())),
                      dropout=float(dd.get("dropout", 0.0)), resolution=dd["resolution"],
                      z_channels=dd["z_channels"])
        self.encoder = Encoder1d(in_channels=dd.get("in_channels", 2048),
                                 double_z=bool(dd.get("double_z", False)), **common)
        self.decoder = Decoder1d(out_ch=dd.get("out_ch", dd.get("in_channels", 2048)), **common)
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta=0.25)
        self.quant_conv = nn.Conv1d(dd["z_channels"], embed_dim, 1)
        self.post_quant_conv = nn.Conv1d(embed_dim, dd["z_channels"], 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, VQResult]:
        """(B, T, C) -> (quantized latents (B, t, embed_dim), ``VQResult``)."""
        h = self.quant_conv(self.encoder(x.transpose(1, 2)))
        vq = self.quantize(h.transpose(1, 2))
        return vq.z_q, vq

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """(B, t, embed_dim) -> (B, T, out_ch)."""
        return self.decoder(self.post_quant_conv(quant.transpose(1, 2))).transpose(1, 2)

    def decode_code(self, code: torch.Tensor) -> torch.Tensor:
        return self.decode(self.quantize.get_codebook_entry(code))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, VQResult]:
        quant, vq = self.encode(x)
        return self.decode(quant), vq
