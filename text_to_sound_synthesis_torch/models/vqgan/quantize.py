"""Vector quantization — nearest-neighbour codebook lookup (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/vqgan/quantize.py`` (reference
``specvqgan/modules/vqvae/quantize.py:5-103``): ``nearest_codebook_indices``
(expanded-L2 argmin), the training forward (the beta-weighted commitment
loss, the straight-through estimator, the perplexity of the code counts) and
``get_codebook_entry`` (decode from tokens). The codebook is the reference's
``embedding`` table.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

__all__ = ["VectorQuantizer", "VQResult", "nearest_codebook_indices", "code_counts", "perplexity"]


class VQResult(NamedTuple):
    z_q: torch.Tensor         # straight-through quantized latents, z's shape
    loss: torch.Tensor        # codebook + beta * commitment loss (scalar)
    indices: torch.Tensor     # (...) int32 nearest codebook ids
    perplexity: torch.Tensor  # scalar codebook-usage perplexity


def nearest_codebook_indices(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_k ||z - e_k||^2 via the expanded form e^2 - 2 z.e (the z^2 term
    is constant per row). ``z_flat`` (N, C), ``codebook`` (K, C) -> (N,) int32."""
    z32, cb32 = z_flat.float(), codebook.float()
    d = (cb32 ** 2).sum(dim=1)[None, :] - 2.0 * (z32 @ cb32.T)
    return d.argmin(dim=1).to(torch.int32)


def code_counts(indices: torch.Tensor, n_e: int) -> torch.Tensor:
    """(n_e,) f32 counts of each code in ``indices`` (a scatter-add:
    ``bincount`` on a card reads the largest index back to the host)."""
    flat = indices.reshape(-1).long()
    return torch.zeros(n_e, device=flat.device).index_add_(
        0, flat, torch.ones(flat.shape, device=flat.device))


def perplexity(counts: torch.Tensor, n: int) -> torch.Tensor:
    """exp(-sum p log(p + 1e-10)) of the code counts (n codes in all)."""
    e_mean = counts.float() / n
    return torch.exp(-(e_mean * torch.log(e_mean + 1e-10)).sum())


class VectorQuantizer(nn.Module):
    """Codebook of ``n_e`` vectors of dim ``e_dim``; beta-commitment VQ."""

    def __init__(self, n_e: int = 256, e_dim: int = 256, beta: float = 0.25):
        super().__init__()
        self.n_e, self.e_dim, self.beta = n_e, e_dim, beta
        self.embedding = nn.Embedding(n_e, e_dim)

    @torch.no_grad()
    def reset_parameters_(self, generator: torch.Generator) -> "VectorQuantizer":
        """The training init of the JAX package and the reference: U(-1/n_e, 1/n_e)."""
        self.embedding.weight.uniform_(-1.0 / self.n_e, 1.0 / self.n_e, generator=generator)
        return self

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """z (..., e_dim) channels-last -> (...) int32 nearest codebook ids."""
        return nearest_codebook_indices(z.reshape(-1, self.e_dim),
                                        self.embedding.weight).reshape(z.shape[:-1])

    def forward(self, z: torch.Tensor) -> VQResult:
        """z (..., e_dim) channels-last (any leading shape) -> ``VQResult``:
        loss = mean((sg(z_q) - z)^2) + beta mean((z_q - sg(z))^2), z_q passed
        straight through to z's gradient."""
        idx = nearest_codebook_indices(z.reshape(-1, self.e_dim), self.embedding.weight)
        z_q = self.embedding(idx.long()).reshape(z.shape).to(z.dtype)
        loss = ((z_q.detach() - z) ** 2).mean() + self.beta * ((z_q - z.detach()) ** 2).mean()
        z_q = z + (z_q - z).detach()
        return VQResult(z_q, loss, idx.reshape(z.shape[:-1]),
                        perplexity(code_counts(idx, self.n_e), idx.numel()))

    def get_codebook_entry(self, indices: torch.Tensor) -> torch.Tensor:
        """(...,) int ids -> (..., e_dim) codebook vectors."""
        return self.embedding(indices)
