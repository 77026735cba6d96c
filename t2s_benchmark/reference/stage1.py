"""SpecVQGAN's Stage-1 step, plain float32.

The codec's forward with the straight-through vector quantizer and its
codebook and commitment terms (van den Oord et al. 2017; beta 0.25), the
L1 reconstruction plus LPAPS (SpecVQGAN's LPIPS on mels: a VGG16 conv stack
without BatchNorm tapped after relu1_2, 2_2, 3_3, 4_3 and 5_3, each tap
unit-normalised over channels, squared differences through 1x1 heads,
spatially averaged and summed), the pix2pix PatchGAN (4x4 convolutions,
BatchNorm on the batch's statistics, LeakyReLU 0.2) with the hinge losses,
and Adam on the codec and then on the discriminator, the discriminator's
phase on a fresh forward of the updated codec (Esser et al. 2021,
``VQLPAPSWithDiscriminator``).
"""

import torch
import torch.nn.functional as F

from . import codec as rcodec

VGG16 = (64, 64, "MP", 128, 128, "MP", 256, 256, 256, "MP", 512, 512, 512, "MP",
         512, 512, 512)
TAPS = (1, 3, 6, 9, 12)          # conv indices whose ReLU output is a tap


def lpaps(w, x, y, prefix="lpaps."):
    """(B,) LPAPS distances of two mel batches (B, 1, 80, T)."""
    def feats(h):
        out, conv, idx = [], 0, 0
        for v in VGG16:
            if v == "MP":
                h = F.max_pool2d(h, 2, 2)
                idx += 1
                continue
            p = f"{prefix}net.slice{1 + sum(conv > t for t in TAPS)}.{idx}"
            h = F.relu(F.conv2d(h, w[p + ".weight"], w[p + ".bias"], padding=1))
            if conv in TAPS:
                out.append(h)
            conv += 1
            idx += 2
        return out

    shift = w[prefix + "scaling_layer.shift"][None, None, :, None]
    scale = w[prefix + "scaling_layer.scale"][None, None, :, None]
    total = 0.0
    for i, (a, b) in enumerate(zip(feats((x - shift) / scale), feats((y - shift) / scale))):
        na = a / (a.square().sum(1, keepdim=True).sqrt() + 1e-10)
        nb = b / (b.square().sum(1, keepdim=True).sqrt() + 1e-10)
        total = total + F.conv2d((na - nb).square(), w[f"{prefix}lin{i}.model.1.weight"]).mean(
            dim=(1, 2, 3))
    return total


def patchgan(w, x, n_layers: int = 3, prefix="disc."):
    """(B, 1, h, w) patch logits of a mel batch (B, 1, 80, T)."""
    h = F.leaky_relu(F.conv2d(x, w[prefix + "main.0.weight"], w[prefix + "main.0.bias"],
                              stride=2, padding=1), 0.2)
    i = 2
    for n in range(1, n_layers + 1):
        h = F.conv2d(h, w[f"{prefix}main.{i}.weight"], None, stride=2 if n < n_layers else 1,
                     padding=1)
        mean = h.mean(dim=(0, 2, 3), keepdim=True)
        var = (h.square().mean(dim=(0, 2, 3), keepdim=True) - mean.square()).clamp_min(0.0)
        h = (h - mean) * torch.rsqrt(var + 1e-5) * w[f"{prefix}main.{i + 1}.weight"][
            None, :, None, None] + w[f"{prefix}main.{i + 1}.bias"][None, :, None, None]
        h = F.leaky_relu(h, 0.2)
        i += 3
    return F.conv2d(h, w[f"{prefix}main.{i}.weight"], w[f"{prefix}main.{i}.bias"], padding=1)


def _alter(idx, n_codes: int):
    flat = idx.reshape(-1).clone()
    flat[::7] = (flat[::7] + 1) % n_codes
    return flat.reshape(idx.shape)


def codes(w, mel, dd, alter: bool = False, prefix=""):
    """The quantizer's code grid (B, h, w) of mels (B, 1, 80, T)."""
    idx, _ = rcodec.quantize(w, rcodec.encoder(w, mel, dd, prefix), prefix)
    return _alter(idx, w[prefix + "quantize.embedding.weight"].shape[0]) if alter else idx


def codec_forward(w, mel, dd, beta: float = 0.25, prefix="", alter: bool = False):
    """(reconstruction, VQ loss) of mels (B, 1, 80, T) through the straight-through
    quantizer; with ``alter`` every seventh code picked moves to the next one (a
    planted fault)."""
    z = rcodec.encoder(w, mel, dd, prefix)
    idx, zq = rcodec.quantize(w, z, prefix)
    if alter:
        cb = w[prefix + "quantize.embedding.weight"]
        zq = cb[_alter(idx, cb.shape[0])].permute(0, 3, 1, 2)
    vq = (zq.detach() - z).square().mean() + beta * (zq - z.detach()).square().mean()
    zq = z + (zq - z).detach()
    return rcodec.decoder(w, zq, dd, prefix), vq


def ae_loss(w, mel, dd, loss: dict, alter: bool = False):
    """The codec phase's total loss (the discriminator's weights held fixed)."""
    xrec, vq = codec_forward(w, mel, dd, alter=alter)
    nll = (mel - xrec).abs().mean() + loss["perceptual_weight"] * lpaps(w, mel, xrec).mean()
    g = -patchgan(w, xrec).mean()
    return nll + loss["disc_weight"] * g + loss["codebook_weight"] * vq


def d_loss(w, mel, dd, alter: bool = False):
    """The discriminator phase's hinge loss on a fresh forward of the codec."""
    with torch.no_grad():
        xrec, _ = codec_forward(w, mel, dd, alter=alter)
    real, fake = patchgan(w, mel), patchgan(w, xrec)
    return 0.5 * (F.relu(1.0 - real).mean() + F.relu(1.0 + fake).mean())
