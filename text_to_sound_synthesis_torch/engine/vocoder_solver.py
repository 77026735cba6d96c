"""MelGAN vocoder training: the hinge GAN + feature-matching step (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/engine/vocoder_solver.py`` (reference
``Diffsound/vocoder/scripts/train.py:120-180``). Per batch:

1. the discriminator on the current generator's output (detached) and on
   the real wav: the hinge loss summed over the scales; Adam on D;
2. the generator against the just-updated D: -sum over scales of E[D(fake)]
   + lambda_feat (10) x the weighted L1 feature matching
   (``ops/gan.py::feature_matching_l1``), whose targets are the D phase's
   real activations, those of D before its update (the reference reuses its
   ``D_real`` after ``optD.step()``, train.py:145, 161-173); Adam on G;
3. the mel reconstruction L1 of that output, a diagnostic.

The mel is the canonical [0, 1] spec (``TRANSFORMS``), trimmed to T // 256
frames: this fork trains the vocoder on what the generation pipeline feeds
it. Both optimizers are Adam(1e-4, (0.5, 0.9)) (``build_vocoder_optimizer``).
Layout is NCW: wav (B, T), mel (B, 80, frames). The metrics stay on the
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..ops.gan import feature_matching_l1
from ..ops.signal import wav_to_mel
from .vqgan_solver import _frozen_params

__all__ = ["VocoderTrainState", "build_vocoder_optimizer", "make_vocoder_train_step",
           "mel_for_vocoder"]


def build_vocoder_optimizer(module: nn.Module, lr: float = 1e-4, betas=(0.5, 0.9)):
    """Adam(1e-4, (0.5, 0.9)) (train.py's optG / optD)."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=tuple(betas), eps=1e-8)


@dataclass
class VocoderTrainState:
    gen: nn.Module
    g_opt: torch.optim.Optimizer
    disc: nn.Module
    d_opt: torch.optim.Optimizer
    step: int = 0

    @classmethod
    def create(cls, gen: nn.Module, disc: nn.Module, lr: float = 1e-4) -> "VocoderTrainState":
        return cls(gen, build_vocoder_optimizer(gen, lr), disc, build_vocoder_optimizer(disc, lr))


def mel_for_vocoder(wav: torch.Tensor, hop: int = 256) -> torch.Tensor:
    """(B, T) waveform -> (B, 80, T // hop) canonical [0, 1] spec
    (train.py:133-135 through TRANSFORMS)."""
    return wav_to_mel(wav)[..., : wav.shape[-1] // hop]


def make_vocoder_train_step(lambda_feat: float = 10.0) -> Callable:
    """Returns ``step(state, wav) -> (state, metrics)``; ``wav`` (B, T) on
    the models' device."""

    def step(state: VocoderTrainState, wav: torch.Tensor):
        gen, disc = state.gen, state.disc
        gen.train()
        disc.train()
        mel = mel_for_vocoder(wav)
        x_real = wav[:, None, :]
        with torch.no_grad():
            x_fake = gen(mel)

        # ---- discriminator -----------------------------------------------------
        state.d_opt.zero_grad(set_to_none=True)
        fake_feats = disc(x_fake)
        real_feats = disc(x_real)
        loss_d = 0.0
        for scale in fake_feats:
            loss_d = loss_d + torch.relu(1.0 + scale[-1]).mean()
        for scale in real_feats:
            loss_d = loss_d + torch.relu(1.0 - scale[-1]).mean()
        loss_d.backward()
        state.d_opt.step()

        # ---- generator, against the updated D; FM targets from D before it ------
        real_feats = [[f.detach() for f in scale] for scale in real_feats]
        state.g_opt.zero_grad(set_to_none=True)
        fake = gen(mel)
        with _frozen_params(disc):
            fake_feats = disc(fake)
        adv = 0.0
        for scale in fake_feats:
            adv = adv - scale[-1].mean()
        fm = feature_matching_l1(real_feats, fake_feats)
        (adv + lambda_feat * fm).backward()
        state.g_opt.step()
        state.step += 1

        with torch.no_grad():     # the diagnostic of the pre-update generator's output
            s_error = (mel - mel_for_vocoder(fake.detach()[:, 0])).abs().mean()
        return state, {"loss_D": loss_d.detach(), "loss_G": adv.detach(),
                       "loss_feat": fm.detach(), "mel_reconstruction": s_error}

    return step
