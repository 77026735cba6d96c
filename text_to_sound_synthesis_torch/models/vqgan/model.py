"""VQModel composite: encoder -> 1x1 quant conv -> VQ -> 1x1 post conv -> decoder.

Port of ``text_to_sound_synthesis_tpu/models/vqgan/model.py`` (reference
``specvqgan/models/vqgan.py``) for inference. Module names follow the
reference (``encoder``, ``decoder``, ``quantize.embedding``, ``quant_conv``,
``post_quant_conv``). The public methods keep the JAX package's layouts:
mels are (B, n_mels, T, 1) NHWC and token grids (B, h, w).
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from ...utils.config import register
from .modules import Decoder, Encoder
from .quantize import VectorQuantizer

__all__ = ["VQModel"]


@register(
    "text_to_sound_synthesis_tpu.models.vqgan.VQModel",
    "specvqgan.models.vqgan.VQModel",
    "sound_synthesis.modeling.codecs.spec_codec.vqgan.VQModel",
)
class VQModel(nn.Module):
    """Spectrogram tokenizer; ``ddconfig`` follows the reference YAML schema.
    ``ckpt_path``, ``lossconfig``, ``ignore_keys``, ``image_key``,
    ``colorize_nlabels`` and ``monitor`` are accepted for config parity."""

    def __init__(self, ddconfig: Mapping[str, Any], n_embed: int = 256, embed_dim: int = 256,
                 ckpt_path=None, lossconfig=None, ignore_keys=(), image_key: str = "image",
                 colorize_nlabels=None, monitor=None):
        super().__init__()
        dd = dict(ddconfig)
        common = dict(ch=dd["ch"], ch_mult=tuple(dd["ch_mult"]),
                      num_res_blocks=dd["num_res_blocks"],
                      attn_resolutions=tuple(dd["attn_resolutions"]),
                      resolution=dd["resolution"], z_channels=dd["z_channels"])
        self.encoder = Encoder(in_channels=dd.get("in_channels", 1),
                               double_z=bool(dd.get("double_z", False)), **common)
        self.decoder = Decoder(out_ch=dd.get("out_ch", dd.get("in_channels", 1)), **common)
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta=0.25)
        self.quant_conv = nn.Conv2d(dd["z_channels"], embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, dd["z_channels"], 1)

    def encode_indices(self, x: torch.Tensor) -> torch.Tensor:
        """mel (B, H, W, 1) in [-1, 1] -> (B, h, w) int32 token grid."""
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return self.quantize.indices(h.permute(0, 2, 3, 1))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """Latents (B, h, w, C) -> mel (B, H, W, out_ch)."""
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    def decode_code(self, code: torch.Tensor) -> torch.Tensor:
        """(B, h, w) int codebook ids -> decoded mel (B, H, W, out_ch)."""
        return self.decode(self.quantize.get_codebook_entry(code))
