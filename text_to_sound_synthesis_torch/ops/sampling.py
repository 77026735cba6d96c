"""Logit filtering for sampling: truncation (top-r), top-k, temperature.

Port of ``text_to_sound_synthesis_tpu/ops/sampling.py``. The reference
monkey-patches ``predict_start`` once per process (``dalle_spec.py:135-177``);
here each filter is a plain function the one-hot sampler applies to
log p(x0 | x_t) at every step.
"""

from __future__ import annotations

from typing import Optional

import torch

from .diffusion import MIN_LOGP, gumbel_from_uniform

__all__ = ["truncate_top_r", "truncate_top_k", "apply_temperature", "top_k_multinomial"]


def truncate_top_r(log_probs: torch.Tensor, r: float) -> torch.Tensor:
    """Nucleus-style truncation over the class axis (last).

    Sort descending, keep the largest prefix whose cumulative probability
    stays below ``r`` (the top class always kept), set the rest to -70: the
    ``top0.85r`` rule of ``predict_start_with_truncation`` (dalle_spec.py:158-174).
    A class is kept iff its log-prob reaches the smallest kept sorted value,
    so tied classes are kept or dropped together. No renormalisation (the
    posterior renormalises), as in the reference."""
    sorted_lp = torch.sort(log_probs, dim=-1, descending=True).values
    cum = torch.cumsum(torch.exp(sorted_lp), dim=-1)
    keep_sorted = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool),
                             cum[..., :-1] < r], dim=-1)
    threshold = torch.where(keep_sorted, sorted_lp, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(log_probs >= threshold, log_probs, MIN_LOGP)


def truncate_top_k(log_probs: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the classes at or above the k-th largest value per position (ties
    with it kept too), set the rest to -70: the ``top<k>p`` rule
    (dalle_spec.py:147-157). A k beyond the class count keeps every class,
    as the JAX package's clamped index does."""
    return torch.where(log_probs >= _kth_largest(log_probs, k), log_probs, MIN_LOGP)


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest value over the last axis, (..., 1); the smallest when
    k is 0 or beyond the axis (JAX clamps the out-of-range index)."""
    return torch.sort(x, dim=-1).values[..., -min(k, x.shape[-1]), None]


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits if temperature == 1.0 else logits / temperature


def top_k_multinomial(generator: Optional[torch.Generator], logits: torch.Tensor, k: int,
                      temperature: float = 1.0,
                      gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Top-k multinomial sampling over the last axis (the AR baseline's
    sampler, ``Codebook/evaluation/generate_samples_caps.py:192-229``): a
    Gumbel argmax over the k largest logits. ``gumbel`` (the logits' shape)
    supplies the noise in place of draws from ``generator``."""
    logits = apply_temperature(logits, temperature)
    masked = torch.where(logits >= _kth_largest(logits, k), logits, -torch.inf)
    if gumbel is None:
        gumbel = gumbel_from_uniform(
            torch.rand(logits.shape, generator=generator, device=logits.device))
    return (masked + gumbel).argmax(dim=-1)
