"""Text-to-sound generation CLI of the port.

    python -m text_to_sound_synthesis_torch.tools.generate \\
        --config_file configs/diffsound_audiocaps.yaml --ckpt diffsound_ckpt.pth \\
        --vocoder vocoder_logs_dir --csv val.csv --outdir samples/ \\
        [--replicate 2] [--sample_type top0.85r] [--batch 5] [--device cuda]
    python -m text_to_sound_synthesis_torch.tools.generate ... --caption "a dog barks"
    python -m text_to_sound_synthesis_torch.tools.generate ... --caption "rolling thunder" \\
        --duration 25 --batch 1 [--int8]

The port of ``tools/generate.py`` (reference
``Diffsound/evaluation/generate_samples_batch.py``, class ``Diffsound:42-205``):
rows of (name, caption) from ``--csv`` or ``--caption``, each caption
repeated ``--replicate`` times, batched by ``--batch`` rows; each sample is
written as ``<name>_sample_<i>.npy`` (the [0, 1] spectrogram) and, with
``--vocoder`` (MelGAN: ``args.yml`` + ``best_netG.pt``) or ``--griffin_lim``,
as a PCM_24 wav at 22 050 Hz. The engine is the model in its config's
compute dtype (``Diffsound.generate``), the int8 serving engine with
``--int8`` (``quantize_for_serving`` -> ``generate_int8``; W4A8 by default),
or long-form generation on either with ``--duration`` / ``--duration_frames``
(``generate_long``). One generator seeded ``--seed`` serves every batch, in
order. The card unless ``--device cpu``; without a card the tool exits
nonzero.

``--ckpt`` is ``random`` (seeded random weights, the config's codec
checkpoint loaded), or a torch ``.pth`` / ``.ckpt`` / ``.pt``: the
reference's Stage-2 file or the port's ``Solver`` checkpoint, its EMA
weights preferred. Captions need the CLIP BPE merge table
(``$T2S_CLIP_BPE``).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys

# the canonical mel recipe (ops/signal.py CANONICAL): 22 050 Hz, hop 256
SAMPLE_RATE = 22050
HOP_LENGTH = 256


def get_args(argv=None):
    p = argparse.ArgumentParser(description="text-to-sound generation (PyTorch port)")
    p.add_argument("--config_file", required=True)
    p.add_argument("--ckpt", required=True,
                   help="torch .pth / .ckpt / .pt (reference or Solver layout), or 'random'")
    p.add_argument("--vocoder", default=None, help="MelGAN logdir (args.yml + best_netG.pt)")
    p.add_argument("--griffin_lim", action="store_true",
                   help="Griffin-Lim vocoder when no MelGAN is given")
    p.add_argument("--csv", default=None, help="AudioCaps val csv: rows of name,caption")
    p.add_argument("--caption", action="append", default=None)
    p.add_argument("--outdir", default="samples")
    p.add_argument("--replicate", type=int, default=2)
    p.add_argument("--sample_type", default="top0.85r")
    p.add_argument("--int8", action="store_true",
                   help="serve the denoiser through the int8 engine "
                        "(models/diffusion/int8_runtime)")
    p.add_argument("--weight_bits", type=int, default=4, choices=[8, 4],
                   help="with --int8: weight storage width. 4 (default) = nibble-packed W4A8; "
                        "8 = plain int8")
    p.add_argument("--batch", type=int, default=5)
    p.add_argument("--duration", type=float, default=None,
                   help="target clip length in SECONDS; beyond the codec's window this is "
                        "chunked long-form generation (Diffsound.generate_long: overlapping "
                        "segments cross-faded in the mel domain). Each caption costs "
                        "n_segments sampler rows, so lower --batch accordingly")
    p.add_argument("--duration_frames", type=int, default=None,
                   help="target length in mel FRAMES directly (overrides --duration; "
                        "1 frame = 256/22050 s)")
    p.add_argument("--overlap_frames", type=int, default=160,
                   help="cross-fade overlap between long-form segments")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def load_model(config, ckpt: str, seed: int, device):
    """The composite of ``config`` on ``device``: seeded random weights for
    ``ckpt == "random"`` (the config's codec checkpoint loaded), else the
    torch checkpoint's, the denoiser's EMA preferred. The JAX package's
    orbax directories need JAX to read and are refused."""
    from ..engine.checkpoint import load_checkpoint, load_weights
    from ..models.diffsound import build_model

    if ckpt == "random":
        return build_model(config, device=device, seed=seed, load_codec=True)
    if os.path.isdir(ckpt) or not ckpt.endswith((".pth", ".ckpt", ".pt")):
        raise ValueError(
            f"checkpoint {ckpt!r}: the port reads a torch .pth / .ckpt / .pt (the reference's "
            "Stage-2 file or the port's Solver checkpoint) or 'random'; an orbax directory (the "
            "JAX package's layout) needs JAX to read")
    model = build_model(config, device=device, seed=seed, load_codec=False)
    load_weights(model, load_checkpoint(ckpt), prefer_ema=True)
    return model


def make_vocoder(args, device):
    """``spec (B, n_mels, T) [0, 1] array -> wav (B, T * 256) array``: the
    MelGAN of ``--vocoder``, Griffin-Lim with ``--griffin_lim``, else None."""
    import numpy as np
    import torch

    if args.vocoder:
        from ..models.melgan.interface import load_vocoder

        melgan = load_vocoder(args.vocoder, device=device)
        return lambda spec: melgan(torch.as_tensor(spec, device=device)).float().cpu().numpy()
    if args.griffin_lim:
        from ..ops.signal import mel_to_wav_np

        # the reference's VocoderGriffinLim path (Codebook/train.py:358-381):
        # audible, but below MelGAN's quality
        return lambda spec: np.stack([mel_to_wav_np(s, device=device) for s in spec])
    return None


def make_runner(model, args):
    """``run(generator, cond_tokens) -> mel (B, H, W, 1)``: the engine the
    flags pick."""
    frames = args.duration_frames
    if frames is None and args.duration is not None:
        frames = int(round(args.duration * SAMPLE_RATE / HOP_LENGTH))
    qp = model.quantize_for_serving(weight_bits=args.weight_bits) if args.int8 else None
    if frames is not None:
        return lambda g, toks: model.generate_long(
            g, toks, duration_frames=frames, overlap_frames=args.overlap_frames,
            sample_type=args.sample_type, qp=qp)
    if qp is not None:
        return lambda g, toks: model.generate_int8(qp, g, toks, sample_type=args.sample_type)
    return lambda g, toks: model.generate(g, toks, sample_type=args.sample_type)


def to_spec(mel):
    """mel (B, H, W, 1) in [-1, 1] -> the [0, 1] spectrogram (B, H, W) in
    f32, on the mel's device."""
    return (mel[..., 0].float() + 1.0) / 2.0


def main(argv=None) -> int:
    args = get_args(argv)
    import numpy as np
    import torch

    from ..parallel.distributed import local_device
    from ..utils.config import load_yaml_config
    from ..utils.io import write_wav

    device = local_device(args.device)
    model = load_model(load_yaml_config(args.config_file), args.ckpt, args.seed, device)
    vocoder = make_vocoder(args, device)

    if args.csv:
        with open(args.csv) as f:
            rows = [(r[0], r[1]) for r in csv.reader(f) if len(r) >= 2]
    else:
        caps = args.caption or ["a dog barking"]
        rows = [(f"caption{i}", c) for i, c in enumerate(caps)]

    os.makedirs(args.outdir, exist_ok=True)
    run = make_runner(model, args)
    generator = torch.Generator(device).manual_seed(args.seed)
    for start in range(0, len(rows), args.batch):
        chunk = rows[start:start + args.batch]
        names = [n for n, _ in chunk for _ in range(args.replicate)]
        caps = [c for _, c in chunk for _ in range(args.replicate)]
        toks = torch.from_numpy(model.text_to_tokens(caps)["token"]).to(device)
        spec = to_spec(run(generator, toks)).cpu().numpy()     # (B, 80, T) in [0, 1]
        counters = {}
        for i, name in enumerate(names):
            idx = counters.get(name, 0)
            counters[name] = idx + 1
            base = os.path.join(args.outdir, f"{name}_sample_{idx}")
            np.save(base + ".npy", spec[i])
            if vocoder is not None:
                wav = vocoder(spec[i:i + 1])[0]
                write_wav(base + ".wav", SAMPLE_RATE, wav, subtype="PCM_24")
        print(f"[{start + len(chunk)}/{len(rows)}] wrote {len(names)} samples")
    return 0


if __name__ == "__main__":
    sys.exit(main())
