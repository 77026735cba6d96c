"""Vocoder interface: MelGAN generator on generated spectrograms (PyTorch port).

Port of ``Vocoder.__call__`` of
``text_to_sound_synthesis_tpu/models/melgan/interface.py``. Loading a trained
generator (``best_netG.pt`` or an orbax tree) waits for checkpoints; build
one with random weights via ``utils.init.init_random_`` or load converted
weights with ``convert.from_jax.load_melgan_generator``.
"""

from __future__ import annotations

import torch

from .generator import MelGANGenerator

__all__ = ["Vocoder"]


class Vocoder:
    def __init__(self, gen: MelGANGenerator):
        self.gen = gen

    @torch.no_grad()
    def __call__(self, spec: torch.Tensor) -> torch.Tensor:
        """(B, 80, T) spec (the [0,1]-normalized training convention) ->
        (B, T*256) waveform in [-1, 1], on the generator's device. The
        generation pipeline feeds the generated [0,1] spec directly
        (generate_samples_batch.py:185)."""
        w = next(self.gen.parameters())
        return self.gen(spec.to(device=w.device, dtype=w.dtype))[:, 0, :]
