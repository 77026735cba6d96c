"""Stage-1 and vocoder training throughput on a CUDA card.

    python -m text_to_sound_synthesis_torch.tools.bench_train_stage1 [vqgan] [melgan] [--steps N]

The port of ``tools/bench_train_stage1.py``. Two rows, each one JSON line
with the card's name and power limit, in f32 under PyTorch's default
precision (f32 matmuls, TF32 cuDNN convolutions):

- ``vqgan_train_step_batch8``: the full adversarial SpecVQGAN step
  (``engine/vqgan_solver.py``) at ``configs/vqgan_caps.yaml``'s geometry (ch
  128, ch_mult [1, 1, 2, 2, 4], 2 res blocks, attention at 53, a 256 x 256
  codebook), its PatchGAN (ndf 64, 3 layers, BatchNorm), a seeded random
  LPAPS, batch 8 of 80 x 848 mels in [-1, 1], ``disc_start`` 0 (both phases
  active), both optimizers, lr 8 x 1e-6 (the reference's scaling);
- ``melgan_train_step_batch16``: the MelGAN step
  (``engine/vocoder_solver.py``) at the reference's flags (ngf 32, 3
  residual layers, 3 scales of ndf 16, 4 layers), batch 16 of 8192-sample
  crops.

Each row: two warm-up steps, then ``--steps`` steps (10 and 20 by default)
timed on the host clock up to a synchronize; the median step, samples/s
and the peak memory; then one more step under ``torch.utils.flop_counter``
for the step's floating-point operations (the convolutions', matmuls' and
their gradients'; element-wise work is not counted) and their rate at the
median step. Weights are random, made from a seed. Without a card it exits
nonzero.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from . import card_line, require_card

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VQGAN_CONFIG = os.path.join(REPO, "configs", "vqgan_caps.yaml")
VQGAN_BATCH, MEL = 8, (80, 848)
MELGAN_BATCH, MELGAN_LEN = 16, 8192


def vqgan_trainer(dev, seed: int = 0):
    """(state, step, mel, lr): ``VQGAN_CONFIG``'s codec and PatchGAN from the
    JAX package's initialisers, a seeded random LPAPS, one seeded batch of
    ``VQGAN_BATCH`` mels of ``MEL``, ``disc_start`` 0. The module's constants
    are read at the call."""
    from ..engine.vqgan_solver import (VQGANTrainState, disc_kwargs, loss_config,
                                       make_vqgan_train_step)
    from ..models.discriminator import NLayerDiscriminator, init_discriminator_
    from ..models.lpaps import LPAPS
    from ..models.vqgan.model import VQModel, init_codec_
    from ..utils.config import load_yaml_config
    from ..utils.init import init_random_

    mp = load_yaml_config(VQGAN_CONFIG)["model"]["params"]
    loss_p = (mp.get("lossconfig") or {}).get("params") or {}
    input_nc, n_layers, ndf, actnorm = disc_kwargs(loss_p)
    gen = torch.Generator(dev).manual_seed(seed)
    with torch.device(dev):
        codec = init_codec_(VQModel(mp["ddconfig"], n_embed=mp["n_embed"],
                                    embed_dim=mp["embed_dim"]), gen)
        disc = init_discriminator_(NLayerDiscriminator(input_nc, ndf, n_layers, actnorm), gen)
        lpaps = LPAPS(n_mels=MEL[0])
    init_random_(lpaps.net, gen)
    lpaps.init_heads_()
    lr = 1e-6 * VQGAN_BATCH
    cfg = loss_config(loss_p)._replace(disc_start=0)
    mel = torch.rand((VQGAN_BATCH, *MEL, 1), generator=gen, device=dev) * 2 - 1
    return VQGANTrainState.create(codec, disc, lr), make_vqgan_train_step(lpaps, cfg), mel, lr


def melgan_trainer(dev, seed: int = 0):
    """(state, step, wav): the reference's generator and discriminator with
    random weights, one seeded batch of ``MELGAN_BATCH`` crops of
    ``MELGAN_LEN`` samples in [-0.5, 0.5]."""
    from ..engine.vocoder_solver import VocoderTrainState, make_vocoder_train_step
    from ..models.melgan import MelGANDiscriminator, MelGANGenerator
    from ..utils.init import init_random_

    gen = torch.Generator(dev).manual_seed(seed)
    with torch.device(dev):
        g = init_random_(MelGANGenerator(), gen)
        d = init_random_(MelGANDiscriminator(), gen)
    wav = torch.rand((MELGAN_BATCH, MELGAN_LEN), generator=gen, device=dev) - 0.5
    return VocoderTrainState.create(g, d), make_vocoder_train_step(), wav


def time_steps(run: Callable[[], object], n: int, warmup: int = 2) -> Tuple[List[float], float]:
    """(seconds of each of ``n`` steps after ``warmup``, peak GiB over them)."""
    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs, torch.cuda.max_memory_allocated() / 2 ** 30


def count_tflop(run: Callable[[], object]) -> float:
    """TFLOP of one ``run()``, as ``torch.utils.flop_counter`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run()
    torch.cuda.synchronize()
    return counter.get_total_flops() / 1e12


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not require_card("bench_train_stage1"):
        return 1
    rows = [a for a in args if a in ("vqgan", "melgan")] or ["vqgan", "melgan"]
    steps = int(args[args.index("--steps") + 1]) if "--steps" in args else None
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, file=sys.stderr)
    if "vqgan" in rows:
        state, step, mel, lr = vqgan_trainer(dev)
        secs, peak = time_steps(lambda: step(state, mel, lr), steps or 10)
        med = float(np.median(secs))
        tflop = count_tflop(lambda: step(state, mel, lr))
        print(json.dumps({"config": f"vqgan_train_step_batch{VQGAN_BATCH}_float32",
                          "step_s": med, "samples_per_sec": VQGAN_BATCH / med,
                          "peak_gib": peak, "tflop_per_step": tflop,
                          "tflop_per_s": tflop / med, "steps": len(secs), "card": card}))
        del state, step, mel
        torch.cuda.empty_cache()
    if "melgan" in rows:
        state, step, wav = melgan_trainer(dev)
        secs, peak = time_steps(lambda: step(state, wav), steps or 20)
        med = float(np.median(secs))
        tflop = count_tflop(lambda: step(state, wav))
        print(json.dumps({"config": f"melgan_train_step_batch{MELGAN_BATCH}_float32",
                          "step_s": med, "samples_per_sec": MELGAN_BATCH / med,
                          "audio_secs_per_sec": MELGAN_BATCH * MELGAN_LEN / 22050 / med,
                          "peak_gib": peak, "tflop_per_step": tflop,
                          "tflop_per_s": tflop / med, "steps": len(secs), "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
