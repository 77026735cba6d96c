"""SpecVQGAN's codec and MelGAN's generator, plain float32.

The codec is taming-transformers' VQGAN (Esser et al. 2021) as SpecVQGAN
(Iashin and Rahtu 2021) configures it for 80 x 848 mels: GroupNorm(32) +
swish ResNet blocks, single-head attention at the coarsest time resolution,
stride-2 convolutions padded (0, 1, 0, 1) down and nearest 2x up, a 1x1
convolution on each side of a nearest-code vector quantizer. Mels are NCHW
(B, 1, 80, 848) here. MelGAN (Kumar et al. 2019): a 7-tap stem, transposed
convolutions at ratios 8, 8, 2, 2, three dilated residual units per stage,
LeakyReLU(0.2), tanh.
"""

import math

import torch
import torch.nn.functional as F

CODEC = "content_codec."


def _conv(w, p, x, stride=1, padding=1):
    return F.conv2d(x, w[p + ".weight"], w[p + ".bias"], stride=stride, padding=padding)


def _norm(w, p, x):
    C = x.shape[1]
    return F.group_norm(x, math.gcd(32, C), w[p + ".weight"], w[p + ".bias"], eps=1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


def _resnet(w, p, x):
    h = _conv(w, p + ".conv1", _swish(_norm(w, p + ".norm1", x)))
    h = _conv(w, p + ".conv2", _swish(_norm(w, p + ".norm2", h)))
    if p + ".nin_shortcut.weight" in w:
        x = _conv(w, p + ".nin_shortcut", x, padding=0)
    return x + h


def _attn(w, p, x):
    B, C, H, W = x.shape
    h = _norm(w, p + ".norm", x)
    q, k, v = (_conv(w, f"{p}.{n}", h, padding=0).reshape(B, C, H * W) for n in "qkv")
    att = torch.softmax(q.transpose(1, 2) @ k * C ** -0.5, dim=-1)      # (B, i, j)
    h = (v @ att.transpose(1, 2)).reshape(B, C, H, W)
    return x + _conv(w, p + ".proj_out", h, padding=0)


def _mid(w, p, h):
    h = _resnet(w, p + ".block_1", h)
    h = _attn(w, p + ".attn_1", h)
    return _resnet(w, p + ".block_2", h)


def encoder(w, mel, dd, prefix=CODEC):
    """mel (B, 1, 80, T) -> pre-quantization latents (B, embed_dim, 5, T/16)."""
    p = prefix + "encoder"
    h = _conv(w, p + ".conv_in", mel)
    levels = len(dd["ch_mult"])
    for i in range(levels):
        for j in range(dd["num_res_blocks"]):
            h = _resnet(w, f"{p}.down.{i}.block.{j}", h)
            if f"{p}.down.{i}.attn.{j}.q.weight" in w:
                h = _attn(w, f"{p}.down.{i}.attn.{j}", h)
        if i != levels - 1:
            h = _conv(w, f"{p}.down.{i}.downsample.conv", F.pad(h, (0, 1, 0, 1)), stride=2,
                      padding=0)
    h = _mid(w, p + ".mid", h)
    h = _conv(w, p + ".conv_out", _swish(_norm(w, p + ".norm_out", h)))
    return _conv(w, prefix + "quant_conv", h, padding=0)


def quantize(w, z, prefix=CODEC):
    """Latents (B, C, h, w) -> (nearest code ids (B, h, w), codes (B, C, h, w))."""
    cb = w[prefix + "quantize.embedding.weight"]
    B, C, h, wd = z.shape
    flat = z.permute(0, 2, 3, 1).reshape(-1, C)
    d = cb.square().sum(1)[None] - 2 * flat @ cb.T       # |z|^2 is the same for every code
    idx = d.argmin(dim=1)
    zq = cb[idx].reshape(B, h, wd, C).permute(0, 3, 1, 2)
    return idx.reshape(B, h, wd), zq


def decoder(w, zq, dd, prefix=CODEC):
    """Codes (B, embed_dim, h, w) -> mel (B, 1, 16 h, 16 w)."""
    p = prefix + "decoder"
    h = _conv(w, prefix + "post_quant_conv", zq, padding=0)
    h = _mid(w, p + ".mid", _conv(w, p + ".conv_in", h))
    levels = len(dd["ch_mult"])
    for i in reversed(range(levels)):
        for j in range(dd["num_res_blocks"] + 1):
            h = _resnet(w, f"{p}.up.{i}.block.{j}", h)
            if f"{p}.up.{i}.attn.{j}.q.weight" in w:
                h = _attn(w, f"{p}.up.{i}.attn.{j}", h)
        if i != 0:
            h = _conv(w, f"{p}.up.{i}.upsample.conv", F.interpolate(h, scale_factor=2.0,
                                                                     mode="nearest"))
    return _conv(w, p + ".conv_out", _swish(_norm(w, p + ".norm_out", h)))


def decode_tokens(w, tokens, dd, H: int, W: int, prefix=CODEC):
    """Time-major token ids (B, H W) (column by column over the H x W grid) ->
    mel (B, 1, 16 H, 16 W)."""
    grid = tokens.long().reshape(-1, W, H).transpose(1, 2)
    zq = w[prefix + "quantize.embedding.weight"][grid].permute(0, 3, 1, 2)
    return decoder(w, zq, dd, prefix)


def encode_tokens(w, mel, dd, prefix=CODEC):
    """mel (B, 1, 80, T) -> time-major token ids (B, 5 T/16)."""
    grid, _ = quantize(w, encoder(w, mel, dd, prefix), prefix)
    return grid.transpose(1, 2).reshape(grid.shape[0], -1)


def melgan(w, spec, *, ngf: int = 32, n_residual_layers: int = 3, ratios=(8, 8, 2, 2),
           prefix: str = "model."):
    """spec (B, 80, T) in [0, 1] -> wav (B, 256 T) in [-1, 1]."""
    i = 1
    x = F.conv1d(F.pad(spec, (3, 3), mode="reflect"), w[f"{prefix}{i}.weight"],
                 w[f"{prefix}{i}.bias"])
    i += 1
    for r in ratios:
        x = F.conv_transpose1d(F.leaky_relu(x, 0.2), w[f"{prefix}{i + 1}.weight"],
                               w[f"{prefix}{i + 1}.bias"], stride=r, padding=r // 2 + r % 2,
                               output_padding=r % 2)
        i += 2
        for j in range(n_residual_layers):
            p, d = f"{prefix}{i}.", 3 ** j
            h = F.pad(F.leaky_relu(x, 0.2), (d, d), mode="reflect")
            h = F.conv1d(h, w[p + "block.2.weight"], w[p + "block.2.bias"], dilation=d)
            h = F.conv1d(F.leaky_relu(h, 0.2), w[p + "block.4.weight"], w[p + "block.4.bias"])
            x = F.conv1d(x, w[p + "shortcut.weight"], w[p + "shortcut.bias"]) + h
            i += 1
    x = F.pad(F.leaky_relu(x, 0.2), (3, 3), mode="reflect")
    x = F.conv1d(x, w[f"{prefix}{i + 2}.weight"], w[f"{prefix}{i + 2}.bias"])
    return torch.tanh(x)[:, 0, :]
