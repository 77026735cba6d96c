"""Content (token-grid) embedding with factored 2-D positions (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/diffusion/embeddings.py``
(reference ``DalleMaskImageEmbedding``): a token table of ``num_embed + 1``
rows (the extra row is MASK) plus ``height_emb[h] + width_emb[w]`` flattened
row-major over the (5, 53) grid.

Kept from the reference on purpose: tokens arrive ColumnMajor-permuted
(time-major) while the positional flatten is row-major; the model learns the
mapping, and changing it would break released-checkpoint parity.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...utils.config import register

__all__ = ["ContentEmbedding"]


@register(
    "text_to_sound_synthesis_tpu.models.diffusion.ContentEmbedding",
    "sound_synthesis.modeling.embeddings.dalle_mask_image_embedding.DalleMaskImageEmbedding",
)
class ContentEmbedding(nn.Module):
    """``pos_emb_type="embedding"`` (every config) keeps the positions as
    ``Embedding`` tables; ``"parameter"`` as bare (H, D) / (W, D) parameters
    of the same names, zeros at init (``ZERO_INIT``), as the JAX module's
    ``self.param(..., zeros, ...)``."""

    ZERO_INIT = ("height_emb", "width_emb")

    def __init__(self, num_embed: int = 256, spatial_size: Sequence[int] = (5, 53),
                 embed_dim: int = 1024, trainable: bool = True,
                 pos_emb_type: str = "embedding"):
        super().__init__()
        self.num_embed = num_embed
        self.spatial_size = tuple(int(s) for s in spatial_size)
        H, W = self.spatial_size
        self.emb = nn.Embedding(num_embed + 1, embed_dim)
        if pos_emb_type == "embedding":
            self.height_emb = nn.Embedding(H, embed_dim)
            self.width_emb = nn.Embedding(W, embed_dim)
        else:
            self.height_emb = nn.Parameter(torch.zeros(H, embed_dim))
            self.width_emb = nn.Parameter(torch.zeros(W, embed_dim))

    @property
    def num_classes(self) -> int:
        """Total classes including MASK."""
        return self.num_embed + 1

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        """(B, L) int token ids (mask id == num_embed) -> (B, L, D)."""
        tok = self.emb(index.clamp(min=0))  # reference clamps negatives to 0
        h, w = (e if isinstance(e, torch.Tensor) else e.weight
                for e in (self.height_emb, self.width_emb))
        pos = (h[:, None, :] + w[None, :, :]).reshape(1, -1, h.shape[-1])
        return tok + pos[:, : tok.shape[1], :].to(tok.dtype)
