"""VQModel composite: encoder -> 1x1 quant conv -> VQ -> 1x1 post conv -> decoder.

Port of ``text_to_sound_synthesis_tpu/models/vqgan/model.py`` (reference
``specvqgan/models/vqgan.py:11-331``): ``VQModel`` (``encode``, ``decode``,
``decode_code``, ``forward``), ``VQNoDiscModel`` and
``VQSegmentationModel``; their training steps are
``engine/vqgan_solver.py``. Module names follow the reference (``encoder``,
``decoder``, ``quantize.embedding``, ``quant_conv``, ``post_quant_conv``),
so the state dict of a Lightning checkpoint's ``state_dict`` loads as it is.
The public methods keep the JAX package's layouts: mels are (B, n_mels, T,
1) NHWC and token grids (B, h, w).
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import torch
from torch import nn

from ...utils.config import register
from ...utils.dtype import check_compute_dtype
from ...utils.init import init_random_
from .modules import Decoder, Encoder
from .quantize import VectorQuantizer, VQResult

__all__ = ["VQModel", "VQNoDiscModel", "VQSegmentationModel", "init_codec_"]


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
                      resolution=dd["resolution"], z_channels=dd["z_channels"],
                      dropout=float(dd.get("dropout", 0.0)))
        self.encoder = Encoder(in_channels=dd.get("in_channels", 1),
                               double_z=bool(dd.get("double_z", False)), **common)
        self.decoder = Decoder(out_ch=dd.get("out_ch", dd.get("in_channels", 1)), **common)
        self.quantize = VectorQuantizer(n_embed, embed_dim, beta=0.25)
        self.quant_conv = nn.Conv2d(dd["z_channels"], embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, dd["z_channels"], 1)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, VQResult]:
        """mel (B, H, W, 1) in [-1, 1] -> (quantized latents (B, h, w, C)
        through the straight-through estimator, ``VQResult``)."""
        check_compute_dtype(self, self.quant_conv.weight)
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        vq = self.quantize(h.permute(0, 2, 3, 1))
        return vq.z_q, vq

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, VQResult]:
        """mel (B, H, W, 1) -> (reconstruction (B, H, W, out_ch), ``VQResult``)."""
        quant, vq = self.encode(x)
        return self.decode(quant), vq

    def encode_indices(self, x: torch.Tensor) -> torch.Tensor:
        """mel (B, H, W, 1) in [-1, 1] -> (B, h, w) int32 token grid."""
        check_compute_dtype(self, self.quant_conv.weight)
        h = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        return self.quantize.indices(h.permute(0, 2, 3, 1))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        """Latents (B, h, w, C) -> mel (B, H, W, out_ch)."""
        check_compute_dtype(self, self.post_quant_conv.weight)
        h = self.post_quant_conv(quant.permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    def decode_code(self, code: torch.Tensor) -> torch.Tensor:
        """(B, h, w) int codebook ids -> decoded mel (B, H, W, out_ch)."""
        return self.decode(self.quantize.get_codebook_entry(code))


@register(
    "text_to_sound_synthesis_tpu.models.vqgan.VQNoDiscModel",
    "specvqgan.models.vqgan.VQNoDiscModel",
)
class VQNoDiscModel(VQModel):
    """VQModel trained without an adversarial loss (vqgan.py:284-331): the
    same network; its step is ``engine/vqgan_solver.py::make_vqgan_nodisc_train_step``."""


@register(
    "text_to_sound_synthesis_tpu.models.vqgan.VQSegmentationModel",
    "specvqgan.models.vqgan.VQSegmentationModel",
)
class VQSegmentationModel(VQModel):
    """Segmentation-map VQ autoencoder (vqgan.py:232-281): the decoder emits
    ``n_labels`` class-logit channels (``ddconfig.out_ch = n_labels``); its
    step is ``make_vqgan_segmentation_train_step`` (pixel-wise BCE)."""

    def __init__(self, ddconfig: Mapping[str, Any], n_labels=None, **kwargs):
        out_ch = (ddconfig or {}).get("out_ch", (ddconfig or {}).get("in_channels", 1))
        if n_labels is not None and n_labels != out_ch:
            raise ValueError(
                f"n_labels={n_labels} but ddconfig.out_ch={out_ch}; the decoder emits out_ch "
                f"logit channels: set ddconfig.out_ch = n_labels (vqgan.py:232-281)")
        super().__init__(ddconfig, **kwargs)
        self.n_labels = n_labels


@torch.no_grad()
def init_codec_(codec: nn.Module, generator: torch.Generator) -> nn.Module:
    """The training init of a codec from scratch, as the JAX package's: convs
    ~ N(0, 1/fan_in), biases 0, GroupNorm scales 1, and each codebook
    U(-1/n_e, 1/n_e) (quantize.py:52-59), not the generic init's normal."""
    init_random_(codec, generator)
    for m in codec.modules():
        if isinstance(m, VectorQuantizer):
            m.reset_parameters_(generator)
    return codec
