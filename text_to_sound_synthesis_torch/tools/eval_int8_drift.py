"""Quantify int8-serving drift end to end: FID/ISc between bf16-generated and
int8-generated sample sets, against the seed-to-seed noise floor.

Port of the JAX package's ``tools/eval_int8_drift.py``. The int8 engine is
gated numerically by kernel-vs-twin and logit-agreement checks; this tool
closes the loop at the DISTRIBUTION level, the way the paper's metrics see it:

  1. generate N clips with the bf16 fused path (seed A),
  2. generate N clips with the int8 engine (seed A'),
  3. generate N clips with the bf16 fused path again (seed B),
  4. decode each set with the VQGAN and extract its Melception features,
  5. report FID(bf16_A, int8) against the floor FID(bf16_A, bf16_B).

int8 drift is acceptable when row 5's two numbers are comparable — the
quantization then moves the sample distribution no further than resampling
does (the JAX package's gate: ``drift_ratio <= 1.5``). With no released
checkpoint the tool runs the model on random weights (still a valid relative
comparison), drawn as the port's seeded init draws them, the JAX
package's flax defaults (Linear and Conv weights ``lecun_normal``, truncated
at two standard deviations: the W4 grid's step is each output channel's
largest weight over 7, so the tails decide the int8 engine's error); pass ``--ckpt`` / ``--melception`` for the
real gate.

The sets are drawn on the model's bf16 compute dtype (the served bf16 path)
and its W8A8 or W4A8 engine, quantized from those bf16 weights. The whole
protocol runs in full f32 (``utils.dtype.full_f32``: no TF32 in matmuls or
cuDNN's convs, whatever the caller set), so a seed gives the same numbers
alone and inside a larger program: the f32 training step's codec encode
otherwise follows ``torch.backends.cudnn.allow_tf32``. The
conditioning is BPE ids: with ``--captions`` the captions go through the
lazy tokenizer, which needs the CLIP BPE merge table and raises without it;
without, seeded ids of the tokenizer's form (SOT, word ids, EOT, zero
padding; ``caption_ids``), eight rows cycled as the JAX tool cycles its
eight default captions.

Usage:
  python -m text_to_sound_synthesis_torch.tools.eval_int8_drift \\
      --config_file configs/diffsound_audiocaps.yaml [--ckpt model.pth] \\
      [--melception melception.pt] [--clips 64] [--batch 8] [--captions caps.txt] \\
      [--static] [--w4] [--train_steps 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

SOT, EOT = 49406, 49407       # the CLIP BPE vocabulary's start and end ids
N_CAPTIONS = 8                # rows cycled, as the JAX tool's eight default captions
SEEDS = {"bf16_a": 100, "int8": 200, "bf16_b": 300}
TRAIN_BATCH = 20
TRAIN_LR = 3e-6


def caption_ids(rng: np.random.Generator, n: int, context_length: int = 77) -> torch.Tensor:
    """(n, context_length) BPE ids of the form the tokenizer emits: SOT,
    3-11 word ids in [256, 49000), EOT, zero padding."""
    ids = np.zeros((n, context_length), np.int32)
    for b in range(n):
        k = int(rng.integers(3, 12))
        ids[b, 0], ids[b, k + 1] = SOT, EOT
        ids[b, 1:k + 1] = rng.integers(256, 49000, k)
    return torch.from_numpy(ids)


def train_denoiser(model, steps: int, seed: int) -> float:
    """``steps`` steps of the port's Stage-2 recipe on one synthetic batch
    (the JAX tool's: batch 20 of standard-normal mels and random ids, AdamW
    (0.9, 0.96), weight decay 0.045, lr 3e-6, ``ClipGradNorm(0, 5000,
    0.5)``, EMA 0.99 every 25 steps); the denoiser's weights are the trained
    ones after it (the EMA is not read). -> seconds."""
    from ..engine import ClipGradNorm, DiffusionTrainState, build_optimizer, make_train_step

    den = model.diffusion.transformer
    opt = build_optimizer({"target": "adamw", "params": {"betas": (0.9, 0.96),
                                                         "weight_decay": 0.045}},
                          den, TRAIN_LR)
    step = make_train_step(model, ClipGradNorm(0, 5000, 0.5), ema_decay=0.99, ema_interval=25)
    state = DiffusionTrainState.create(den, opt, model.diffusion.diffusion_step)
    dev = next(den.parameters()).device
    f = model.time_downsample
    H, W = model.token_hw
    gen = torch.Generator(dev).manual_seed(seed)
    batch = {"image": torch.randn((TRAIN_BATCH, H * f, W * f, 1), generator=gen, device=dev),
             "condition_token": torch.randint(0, EOT + 1,
                                              (TRAIN_BATCH, model.text_codec.context_length),
                                              generator=gen, device=dev)}
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch, TRAIN_LR, generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def sample_set(model, ids: torch.Tensor, clips: int, batch: int, seed: int, *, qp=None,
               sample_type: str = "top0.85r") -> list:
    """``clips`` mels as (n_mels, frames) numpy arrays, the decoder's [-1, 1]
    range mapped to [0, 1] (as the JAX tool maps it, unclipped): batches of
    ``batch`` rows cycled from ``ids``, each through ``generate`` (the fused
    bf16 path) or, with ``qp``, ``generate_int8`` on that engine, then the
    VQGAN decode; one generator seeded ``seed`` on the model's device for
    the whole set."""
    dev = ids.device
    gen = torch.Generator(dev).manual_seed(seed)
    specs, i = [], 0
    while len(specs) < clips:
        rows = ids[[(i + j) % len(ids) for j in range(batch)]]
        i += batch
        if qp is None:
            mel = model.generate(gen, rows, sample_type=sample_type)
        else:
            mel = model.generate_int8(qp, gen, rows, sample_type=sample_type)
        mel = ((mel[..., 0].float() + 1.0) / 2.0).cpu().numpy()
        specs.extend(mel[j] for j in range(mel.shape[0]))
    return specs[:clips]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", required=True)
    p.add_argument("--ckpt", default="random",
                   help="a Stage-2 checkpoint in the reference's layout (.pth; its EMA "
                        "preferred), or 'random' (seeded weights)")
    p.add_argument("--melception", default=None,
                   help="a released melception .pt (default: random init)")
    p.add_argument("--clips", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--captions", default=None, help="txt file, one caption/line")
    p.add_argument("--sample_type", default="top0.85r")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--static", action="store_true",
                   help="calibrate static activation scales on the first "
                        "caption batch and evaluate the static-quant engine")
    p.add_argument("--w4", action="store_true",
                   help="nibble-packed W4A8 weight storage (the served engine)")
    p.add_argument("--train_steps", type=int, default=0,
                   help="briefly train the denoiser on a synthetic batch first "
                        "(random init draws near-degenerate samples; a few dozen "
                        "optimizer steps give the weights realistic statistics)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..utils.dtype import full_f32

    with full_f32():
        return run(args)


def run(args) -> dict:
    """The protocol of the module docstring for ``main``'s parsed flags."""
    from ..engine.checkpoint import load_checkpoint, load_weights
    from ..evaluation.features import extract_features
    from ..evaluation.metrics import calculate_fid, calculate_isc
    from ..models import build_model
    from ..models.melception import Melception, load_melception_checkpoint
    from ..parallel.distributed import local_device
    from ..utils.config import load_yaml_config
    from ..utils.init import init_random_

    # one parser for the whole flag; the int8 engine takes top-r heads only
    head = args.sample_type.split(",")[0]
    if not (head.startswith("top") and head.endswith("r")):
        raise SystemExit(f"drift eval supports top-r heads, got {head!r}")

    device = local_device(args.device)
    model = build_model(load_yaml_config(args.config_file), device=device, seed=args.seed,
                        load_codec=args.ckpt == "random")
    if args.ckpt != "random":
        load_weights(model, load_checkpoint(args.ckpt), prefer_ema=True)
    if args.train_steps:
        secs = train_denoiser(model, args.train_steps, args.seed)
        print(f"trained {args.train_steps} steps in {secs:.1f}s", file=sys.stderr)

    model.dtype = torch.bfloat16          # the served bf16 path's compute dtype
    qp = model.quantize_for_serving(weight_bits=4 if args.w4 else 8)

    if args.captions:
        with open(args.captions) as f:
            caps = [ln.strip() for ln in f if ln.strip()]
        ids = torch.as_tensor(model.text_to_tokens(caps)["token"])
    else:
        ids = caption_ids(np.random.default_rng(args.seed), N_CAPTIONS,
                          model.text_codec.context_length)
    ids = ids.to(device)

    if args.static:
        t0 = time.perf_counter()
        model.calibrate_serving_engine(
            qp, torch.Generator(device).manual_seed(args.seed + 777),
            ids[[j % len(ids) for j in range(args.batch)]], sample_type=args.sample_type)
        print(f"static calibration in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    sets = {name: sample_set(model, ids, args.clips, args.batch, seed,
                             qp=qp if name == "int8" else None, sample_type=args.sample_type)
            for name, seed in SEEDS.items()}
    print(f"generated 3x{args.clips} clips in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    with torch.device(device):
        mel_model = Melception(num_classes=309)
    if args.melception:
        load_melception_checkpoint(mel_model, args.melception)
    else:
        init_random_(mel_model, torch.Generator(device).manual_seed(1))
        print("WARNING: random Melception (relative comparison only)", file=sys.stderr)

    feats = {
        name: extract_features(mel_model, [(s, f"mem://{name}/{i}") for i, s in enumerate(specs)],
                               batch_size=min(16, args.clips))
        for name, specs in sets.items()
    }

    out = {
        "clips_per_set": args.clips,
        "fid_bf16_vs_int8": calculate_fid(
            feats["bf16_a"]["2048"], feats["int8"]["2048"])["frechet_inception_distance"],
        "fid_bf16_seed_floor": calculate_fid(
            feats["bf16_a"]["2048"], feats["bf16_b"]["2048"])["frechet_inception_distance"],
        "isc_bf16": calculate_isc(feats["bf16_a"]["logits"], splits=2)["inception_score_mean"],
        "isc_int8": calculate_isc(feats["int8"]["logits"], splits=2)["inception_score_mean"],
    }
    out["drift_ratio"] = out["fid_bf16_vs_int8"] / max(out["fid_bf16_seed_floor"], 1e-9)
    print(json.dumps({k: float(f"{v:.3e}") if isinstance(v, float) else v
                      for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
