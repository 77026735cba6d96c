"""Vocoder interface: load a trained MelGAN and synthesize waveforms (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/melgan/interface.py`` (reference
``Diffsound/vocoder/mel2wav/interface.py:21-99``: ``load_model(root)``
reading ``args.yml`` + ``best_netG.pt``, ``MelVocoder``'s wav <-> mel
helpers). ``load_vocoder`` reads the released torch ``best_netG.pt``, its
weight norm folded into the generator's plain weights; the JAX package's
orbax tree (``melgan_params``) needs JAX to read and is refused.
"""

from __future__ import annotations

import os

import torch

from ...convert.checkpoint import fold_weight_norm, load_torch_state_dict
from ...ops.signal import wav_to_mel
from .generator import MelGANGenerator

__all__ = ["load_vocoder", "Vocoder"]


def _read_args_yml(root: str) -> dict:
    path = os.path.join(root, "args.yml")
    args = {}
    if os.path.exists(path):
        import yaml

        with open(path) as f:
            try:
                args = dict(yaml.safe_load(f) or {})
            except yaml.YAMLError:
                # reference args.yml may carry python-object tags; fall back to
                # a line parser for the three fields we need
                f.seek(0)
                for line in f:
                    for key in ("n_mel_channels", "ngf", "n_residual_layers"):
                        if line.strip().startswith(key):
                            args[key] = int(line.split(":")[1].strip())
    return args


def load_vocoder(root: str, device="cuda") -> "Vocoder":
    """``root`` holds ``args.yml`` + ``best_netG.pt`` (the reference's
    layout: weight-normed ``model.N`` convs). Builds the generator on
    ``device`` (the card unless the caller asks for another) and loads every
    weight; a missing or unexpected key raises."""
    torch_ckpt = os.path.join(root, "best_netG.pt")
    if not os.path.exists(torch_ckpt):
        if os.path.isdir(os.path.join(root, "melgan_params")):
            raise ValueError(
                f"{root}/melgan_params is an orbax tree (the JAX package's layout), which the "
                "port cannot read without JAX; it waits for the training port (ROADMAP, port "
                "queue). Give the directory of the released best_netG.pt")
        raise FileNotFoundError(f"no vocoder checkpoint under {root}")
    args = _read_args_yml(root)
    with torch.device("meta"):
        gen = MelGANGenerator(input_size=int(args.get("n_mel_channels", 80)),
                              ngf=int(args.get("ngf", 32)),
                              n_residual_layers=int(args.get("n_residual_layers", 3)))
    gen = gen.to_empty(device=device)
    sd = load_torch_state_dict(torch_ckpt)
    bases = {k[:-len(".weight_g")] for k in sd if k.endswith(".weight_g")}
    folded = {k: v for k, v in sd.items() if not k.endswith((".weight_g", ".weight_v"))}
    folded.update({b + ".weight": fold_weight_norm(sd, b) for b in bases})
    gen.load_state_dict(folded)
    return Vocoder(gen)


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

    @torch.no_grad()
    def wav2mel(self, wav) -> torch.Tensor:
        """(B, T) waveform (a tensor or an array) -> (B, 80, frames) f32
        training-convention [0,1] spec, on the generator's device."""
        w = next(self.gen.parameters())
        return wav_to_mel(torch.as_tensor(wav, dtype=torch.float32, device=w.device))
