"""Codebook visualizer of the port: wav -> tokens -> reconstruction + bitrate.

    python -m text_to_sound_synthesis_torch.tools.vis_codebook --wav clip.wav \\
        --config configs/diffsound_audiocaps.yaml --ckpt codec.ckpt \\
        [--vocoder VOCODER_DIR] [--outdir vis/] [--device cuda]

The port of ``tools/vis_codebook.py`` (reference ``Codebook/vis_codebook.py:17-60``
and the bitrate helper, ``feature_extraction/demo_utils.py:401``): the wav,
read at 22 050 Hz and cut or padded to 10 s, becomes the 80 x 848 mel
(``ops.signal.wav_to_mel_np``), the trained codec encodes it
(``VQModel.encode``) and the 5 x 53 token grid is printed; the grid is
decoded back, the codebook bitrate (tokens x log2(codebook size) over the
clip's seconds) and the reconstruction's L1 against the mel are printed,
and ``tokens.npy`` and ``reconstruction.npy`` (the [0, 1] mel) are written to
``--outdir``; with ``--vocoder`` (a MelGAN directory, ``load_vocoder``) also
``reconstruction.wav`` and ``original.wav``.

``--config`` is a Diffsound config (its ``content_codec_config``) or a codec
config; ``--ckpt`` is a torch ``.ckpt`` / ``.pth`` / ``.pt`` holding the
reference's ``VQModel`` state dict, bare or under ``state_dict`` (its
``loss.*`` entries are dropped). The JAX tool also reads an orbax tree, the
JAX trainers' layout; the port has no counterpart: reading one needs JAX.
The codec runs in full f32 (no TF32), so its tokens on the card are the
CPU's.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np

SR, SECONDS, HOP = 22050, 10, 256


def get_args(argv=None):
    p = argparse.ArgumentParser(description="codebook visualizer (PyTorch port)")
    p.add_argument("--wav", required=True)
    p.add_argument("--config", default="configs/diffsound_audiocaps.yaml")
    p.add_argument("--ckpt", required=True, help="the codec's torch .ckpt / .pth / .pt")
    p.add_argument("--vocoder", default=None)
    p.add_argument("--outdir", default="vis")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def codec_params(cfg) -> dict:
    mp = cfg["model"]["params"]
    return mp.get("content_codec_config", {"params": mp})["params"]


def load_codec(ccfg, ckpt: str, device):
    """The config's ``VQModel`` on ``device`` with the checkpoint's weights, in eval mode."""
    import torch

    from ..convert.checkpoint import load_torch_state_dict
    from ..models.vqgan.model import VQModel

    with torch.device("meta"):
        codec = VQModel(ccfg["ddconfig"], n_embed=ccfg["n_embed"], embed_dim=ccfg["embed_dim"])
    codec = codec.to_empty(device=device)
    sd = {k: v for k, v in load_torch_state_dict(ckpt).items() if not k.startswith("loss.")}
    codec.load_state_dict(sd)
    return codec.eval()


def clip_mel(wav: np.ndarray, frames: int) -> tuple:
    """(the wav cut or padded to 10 s, its [0, 1] mel's first ``frames`` frames (80, frames))."""
    from ..ops.signal import wav_to_mel_np

    y = np.zeros(SR * SECONDS, np.float32)
    y[: min(len(wav), len(y))] = wav[: len(y)]
    return y, wav_to_mel_np(y)[:, :frames]


def visualize(codec, spec: np.ndarray, n_embed: int):
    """``spec`` (80, W) [0, 1] -> (tokens (h, w) int, reconstruction (80, W)
    in [0, 1], the report's lines)."""
    import torch

    from ..utils.dtype import full_f32

    dev = next(codec.parameters()).device
    mel = torch.from_numpy(2 * spec - 1).to(dev)[None, :, :, None]
    with torch.no_grad(), full_f32():
        quant, vq = codec.encode(mel)
        rec = codec.decode(quant)[0, :, :, 0].float().cpu().numpy()
    tokens = vq.indices[0].cpu().numpy()
    rec01 = np.clip((rec + 1) / 2, 0, 1)
    lines = ["token grid (5 x 53):"] + [" ".join(f"{t:4d}" for t in row) for row in tokens]
    duration_s = spec.shape[1] * HOP / SR
    bits = tokens.size * math.log2(n_embed)
    lines.append(f"codebook bitrate: {bits / duration_s:.1f} bit/s "
                 f"({tokens.size} tokens x log2({n_embed}) / {duration_s:.2f}s)")
    lines.append(f"reconstruction L1: {float(np.abs(rec01 - spec).mean()):.5f}")
    return tokens, rec01, lines


def main(argv=None) -> int:
    args = get_args(argv)
    import torch

    from ..models.melgan.interface import load_vocoder
    from ..parallel.distributed import local_device
    from ..utils.config import load_yaml_config
    from ..utils.io import read_wav, write_wav

    device = local_device(args.device)
    ccfg = codec_params(load_yaml_config(args.config))
    codec = load_codec(ccfg, args.ckpt, device)
    wav, _ = read_wav(args.wav, SR)
    y, spec = clip_mel(wav, ccfg["ddconfig"]["resolution"])
    tokens, rec01, lines = visualize(codec, spec, ccfg["n_embed"])
    print("\n".join(lines))
    os.makedirs(args.outdir, exist_ok=True)
    np.save(os.path.join(args.outdir, "tokens.npy"), tokens)
    np.save(os.path.join(args.outdir, "reconstruction.npy"), rec01)
    if args.vocoder:
        voc = load_vocoder(args.vocoder, device=device)
        write_wav(os.path.join(args.outdir, "reconstruction.wav"), SR,
                  voc(torch.from_numpy(rec01[None]))[0].float().cpu().numpy())
        write_wav(os.path.join(args.outdir, "original.wav"), SR, y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
