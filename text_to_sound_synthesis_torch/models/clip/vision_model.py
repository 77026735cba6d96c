"""CLIP ViT image tower (PyTorch port): completes the vendored CLIP.

Port of ``text_to_sound_synthesis_tpu/models/clip/vision_model.py``. Parity
target: the vendored OpenAI ``VisualTransformer``
(``Diffsound/sound_synthesis/modeling/modules/clip/model.py:201-236``): a
patch conv stem with no bias, a learned class token and positional
embeddings, ``ln_pre``, the text tower's ``ResidualAttentionBlock`` with no
mask, ``ln_post`` on the class token, and the projection ``proj`` to the
shared embedding space.

The text-to-sound pipeline never reads image features; the tower is there
for the vendored CLIP's whole surface (scoring generations against images,
CLIP-space retrieval). Images are NCHW (the JAX package's are NHWC; the
bridge transposes the stem). The names are the reference's
(``conv1``, ``class_embedding``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.N``, ``ln_post``, ``proj``), so a CLIP checkpoint's
``visual.*`` entries load as they are, and the JAX package's
``convert_clip_vision(sd, params, prefix="")`` takes the port's
``state_dict``. LayerNorm eps is 1e-6, as in the text tower.
"""

from __future__ import annotations

import torch
from torch import nn

from ...utils.init import init_random_
from .text_model import LN_EPS, _Transformer

__all__ = ["ClipVisionEncoder"]


class ClipVisionEncoder(nn.Module):
    def __init__(self, input_resolution: int = 224, patch_size: int = 32, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512):
        super().__init__()
        self.input_resolution, self.patch_size, self.width = input_resolution, patch_size, width
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((input_resolution // patch_size) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=LN_EPS)
        self.transformer = _Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width, eps=LN_EPS)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def init_params(self, generator: torch.Generator) -> "ClipVisionEncoder":
        """Seeded init in place, as the JAX module's initialisers draw: the
        conv and the blocks' Linear weights flax's ``lecun_normal``, the class
        token, the positions and ``proj`` N(0, width^-1)."""
        init_random_(self, generator)
        with torch.no_grad():
            for p in (self.class_embedding, self.positional_embedding, self.proj):
                p.normal_(0.0, self.width ** -0.5, generator=generator)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, 3, H, W), H = W = input_resolution -> (B, output_dim)."""
        x = self.conv1(images.to(self.conv1.weight.dtype))          # (B, width, g, g)
        B = x.shape[0]
        x = x.reshape(B, self.width, -1).transpose(1, 2)            # (B, g^2, width)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        x = self.transformer(x, x.new_zeros((), dtype=torch.float32))
        return self.ln_post(x[:, 0]) @ self.proj.to(x.dtype)
