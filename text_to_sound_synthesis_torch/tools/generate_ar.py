"""AR-baseline sampling CLI of the port (text-feature-conditioned Net2Net GPT).

    python -m text_to_sound_synthesis_torch.tools.generate_ar \\
        --config configs/ar_audiocaps.yaml --ckpt OUTPUT/ar_gpt/checkpoint/last.ckpt \\
        --feats_dir cls_token_512/ --outdir samples_ar/ [--vocoder VOCODER_DIR] \\
        [--samples_per_video 2] [--top_k 100] [--temperature 1.0] [--batch 8] [--seed 0] \\
        [--device cuda]

The port of ``tools/generate_ar.py`` (reference
``Codebook/evaluation/generate_samples_caps.py``): each ``<vid>.txt`` of
``--feats_dir`` (a per-clip CLIP text-feature vector, its first
``in_channels`` values) conditions ``--samples_per_video`` samples, drawn
top-k by the KV-cached sampler (``models/gpt/model.py::ar_sample``) and
decoded by the codec; each is written as ``<vid>_sample_<i>.npy`` (the
(80, 848) [0, 1] spectrogram) and, with ``--vocoder`` (a directory with
``args.yml`` and ``best_netG.pt``, ``load_vocoder``), ``<vid>_sample_<i>.wav``
at 22 050 Hz. ``--ckpt`` is ``train_ar``'s checkpoint or any torch file that
holds the whole model's state dict under the reference's names
(``first_stage_model.*``, ``transformer.*``).
"""

from __future__ import annotations

import argparse
import os
import sys
from glob import glob


def get_args(argv=None):
    p = argparse.ArgumentParser(description="AR baseline sampling (PyTorch port)")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True, help="the model's torch checkpoint")
    p.add_argument("--feats_dir", required=True,
                   help="dir of per-clip text-feature .txt vectors (CLIP 512-d)")
    p.add_argument("--outdir", default="samples_ar")
    p.add_argument("--vocoder", default=None)
    p.add_argument("--samples_per_video", type=int, default=2)
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    import numpy as np
    import torch

    from ..convert.checkpoint import load_torch_state_dict
    from ..models.melgan.interface import load_vocoder
    from ..parallel.distributed import local_device
    from ..utils.config import instantiate_from_config, load_yaml_config
    from ..utils.io import write_wav

    device = local_device(args.device)
    cfg = load_yaml_config(args.config)
    with torch.device("meta"):
        model = instantiate_from_config(cfg["model"])
    model = model.to_empty(device=device)
    model.load_state_dict(load_torch_state_dict(args.ckpt))
    model.eval()
    fcfg = cfg["model"]["params"]["transformer_config"]["params"]
    feat_dim = int(fcfg["feat_embedding_config"]["params"]["in_channels"])
    vocoder = load_vocoder(args.vocoder, device=device) if args.vocoder else None

    # the token grid: the permuter's when it has one (ColumnMajor), else the
    # codec's flagship 16x-downsampled latent (80 / 16, 848 / 16)
    hw = (model.permuter.H, model.permuter.W)
    if hw[0] * hw[1] <= 1:
        hw = (5, 53)
        print(f"[generate_ar] permuter has no grid shape; assuming {hw}", file=sys.stderr)
    feat_files = sorted(glob(os.path.join(args.feats_dir, "*.txt")))
    os.makedirs(args.outdir, exist_ok=True)
    generator = torch.Generator(device).manual_seed(args.seed)
    for start in range(0, len(feat_files), args.batch):
        chunk = feat_files[start:start + args.batch]
        feats = np.stack([np.loadtxt(f, dtype=np.float32).reshape(-1)[:feat_dim]
                          for f in chunk])[:, :, None]               # (B, feat_dim, 1)
        feats = torch.from_numpy(feats).to(device)
        for s in range(args.samples_per_video):
            mel = model.sample(feats, hw, top_k=args.top_k, temperature=args.temperature,
                               generator=generator)
            spec = (mel[..., 0] + 1.0) / 2.0
            wavs = vocoder(spec).cpu().numpy() if vocoder is not None else None
            spec = spec.cpu().numpy()
            for i, f in enumerate(chunk):
                base = os.path.join(args.outdir,
                                    f"{os.path.splitext(os.path.basename(f))[0]}_sample_{s}")
                np.save(base + ".npy", spec[i])
                if wavs is not None:
                    write_wav(base + ".wav", 22050, wavs[i])
        print(f"[{start + len(chunk)}/{len(feat_files)}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
