"""MelGAN vocoder training CLI of the port.

    python -m text_to_sound_synthesis_torch.tools.train_vocoder --save_path OUT \\
        --data_path DATA [--batch_size 16] [--seq_len 8192] [--epochs 3000] \\
        [--log_interval 100] [--save_interval 1000] [--seed 0] [--device cuda] [...]

The port of ``tools/train_vocoder.py`` (reference
``Diffsound/vocoder/scripts/train.py``, its flags and defaults: ngf 32, 3
residual layers, num_D 3, ndf 16, n_layers_D 4, lambda_feat 10, batch 16,
8192-sample crops): ``DATA/train_files.txt`` lists the wavs (paths relative
to it), ``WavCropDataset`` draws random crops with a numpy generator seeded
by ``--seed``, and ``engine/vocoder_solver.py``'s step trains G and D.

Written to ``<save_path>/melgan``, the reference's layout, which
``models/melgan/interface.py::load_vocoder`` reads: ``args.yml`` (these
flags) at the start; every ``--save_interval`` steps ``netG.pt``,
``netD.pt``, ``optG.pt``, ``optD.pt`` (state dicts, the generator's convs
plain), and ``best_netG.pt`` / ``best_netD.pt`` whenever the step's mel
reconstruction L1 is the best so far.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(description="MelGAN vocoder training (PyTorch port)")
    p.add_argument("--save_path", required=True)
    p.add_argument("--data_path", required=True,
                   help="dir with train_files.txt (wav paths, one per line)")
    p.add_argument("--n_mel_channels", type=int, default=80)
    p.add_argument("--ngf", type=int, default=32)
    p.add_argument("--n_residual_layers", type=int, default=3)
    p.add_argument("--ndf", type=int, default=16)
    p.add_argument("--num_D", type=int, default=3)
    p.add_argument("--n_layers_D", type=int, default=4)
    p.add_argument("--downsamp_factor", type=int, default=4)
    p.add_argument("--lambda_feat", type=float, default=10.0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seq_len", type=int, default=8192)
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--log_interval", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


class WavCropDataset:
    """Random fixed-length crops of the listed wavs (mel2wav/dataset.py)."""

    def __init__(self, file_list: str, seq_len: int, sr: int = 22050):
        from ..utils.io import read_wav

        self._read = read_wav
        base = os.path.dirname(file_list)
        with open(file_list) as f:
            self.files = [os.path.join(base, line.strip()) for line in f if line.strip()]
        self.seq_len = seq_len
        self.sr = sr

    def __len__(self):
        return len(self.files)

    def sample_batch(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        out = np.zeros((batch, self.seq_len), np.float32)
        for i in range(batch):
            y, _ = self._read(self.files[int(rng.integers(0, len(self.files)))], self.sr)
            if len(y) >= self.seq_len:
                s = int(rng.integers(0, len(y) - self.seq_len + 1))
                out[i] = y[s: s + self.seq_len]
            else:
                out[i, : len(y)] = y
        return out


def main(argv=None) -> int:
    args = get_args(argv)
    import torch

    from ..engine.logger import Logger
    from ..engine.vocoder_solver import VocoderTrainState, make_vocoder_train_step
    from ..models.melgan import MelGANDiscriminator, MelGANGenerator
    from ..parallel.distributed import local_device
    from ..utils.init import init_random_

    device = local_device(args.device)
    logger = Logger(args.save_path, "melgan")
    with open(os.path.join(logger.run_dir, "args.yml"), "w") as f:
        for k, v in vars(args).items():
            f.write(f"{k}: {v}\n")
    with torch.device(device):
        gen = MelGANGenerator(args.n_mel_channels, args.ngf, args.n_residual_layers)
        disc = MelGANDiscriminator(args.num_D, args.ndf, args.n_layers_D, args.downsamp_factor)
    init_random_(gen, torch.Generator(device).manual_seed(args.seed))
    init_random_(disc, torch.Generator(device).manual_seed(args.seed + 1))
    state = VocoderTrainState.create(gen, disc)
    step = make_vocoder_train_step(args.lambda_feat)

    rng = np.random.default_rng(args.seed)
    ds = WavCropDataset(os.path.join(args.data_path, "train_files.txt"), args.seq_len)
    save = lambda name, obj: torch.save(obj, os.path.join(logger.run_dir, name))
    best = float("inf")
    steps_per_epoch = max(1, len(ds) // args.batch_size)
    for epoch in range(args.epochs):
        for _ in range(steps_per_epoch):
            wav = torch.from_numpy(ds.sample_batch(rng, args.batch_size)).to(device)
            state, metrics = step(state, wav)
            it = state.step
            if it % args.log_interval == 0:
                msg = " ".join(f"{k} {float(v):.4f}" for k, v in metrics.items())
                logger.log_info(f"e{epoch} it{it} {msg}")
                for k, v in metrics.items():
                    logger.add_scalar(f"loss/{k}", float(v), it)
            if it % args.save_interval == 0:
                save("netG.pt", gen.state_dict())
                save("netD.pt", disc.state_dict())
                save("optG.pt", state.g_opt.state_dict())
                save("optD.pt", state.d_opt.state_dict())
                s_err = float(metrics["mel_reconstruction"])
                if s_err < best:
                    best = s_err
                    save("best_netG.pt", gen.state_dict())
                    save("best_netD.pt", disc.state_dict())
                    logger.log_info(f"new best mel_reconstruction {s_err:.4f} at it{it}")
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
