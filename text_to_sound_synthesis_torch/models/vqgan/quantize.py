"""Vector quantization — nearest-neighbour codebook lookup (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/vqgan/quantize.py`` for
inference: ``nearest_codebook_indices`` (expanded-L2 argmin) and
``get_codebook_entry`` (decode from tokens). The codebook is the reference's
``embedding`` table. The training losses wait for the training port.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["VectorQuantizer", "nearest_codebook_indices"]


def nearest_codebook_indices(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ||z - e_k||^2 via the expanded form e^2 - 2 z.e (the z^2 term
    is constant per row). ``z_flat`` (N, C), ``codebook`` (K, C) -> (N,) int32."""
    z32, cb32 = z_flat.float(), codebook.float()
    d = (cb32 ** 2).sum(dim=1)[None, :] - 2.0 * (z32 @ cb32.T)
    return d.argmin(dim=1).to(torch.int32)


class VectorQuantizer(nn.Module):
    """Codebook of ``n_e`` vectors of dim ``e_dim``."""

    def __init__(self, n_e: int = 256, e_dim: int = 256, beta: float = 0.25):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Embedding(n_e, e_dim)

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., e_dim) channels-last -> (...) int32 nearest codebook ids."""
        return nearest_codebook_indices(z.reshape(-1, self.e_dim),
                                        self.embedding.weight).reshape(z.shape[:-1])

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """(...,) int ids -> (..., e_dim) codebook vectors."""
        return self.embedding(indices)
