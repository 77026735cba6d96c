"""AR-baseline (Net2Net GPT) training CLI of the port.

    python -m text_to_sound_synthesis_torch.tools.train_ar -b configs/ar_audiocaps.yaml \\
        --output OUTPUT [--name ar_gpt] [--codec CODEC.ckpt] [--max_steps N] [--seed 0] \\
        [--log_every 100] [--device cuda] [key value ...]

The port of ``tools/train_ar.py`` (reference ``Net2NetTransformer.shared_step``,
``Codebook/specvqgan/models/cond_transformer.py:353``, with
``caps_transformer.yaml``): the config's ``Net2NetTransformer``, its codec
frozen, next-token cross entropy on the codec's tokens of each batch's
``image`` given its ``feature`` vectors, AdamW (betas 0.9 / 0.95, weight decay
0.01 on the Linear and Conv weights only: the minGPT split,
``engine/optimizers.py::param_groups``) at lr = cards x batch x
``base_learning_rate``, on one card (the JAX tool's card count is its device
count). The weights start from the JAX package's initialisers, seeded by
``--seed``; ``--codec`` names the trained codec, a torch ``.ckpt`` / ``.pth``
/ ``.pt`` holding the reference's ``VQModel`` state dict bare or under
``state_dict`` (``train_vqgan``'s ``last.ckpt``; its ``loss.*`` entries are
dropped).

A checkpoint, ``<output>/<name>/checkpoint/last.ckpt``, written at each
epoch's end and at the end, is the reference's Lightning layout:
``state_dict`` holds the codec (``first_stage_model.*``) and the GPT
(``transformer.*``), ``optimizer_states`` the AdamW, ``epoch`` and
``global_step`` the position; ``generate_ar --ckpt`` reads it.
"""

from __future__ import annotations

import argparse
import os
import sys

BETAS, WEIGHT_DECAY = (0.9, 0.95), 0.01


def get_args(argv=None):
    p = argparse.ArgumentParser(description="AR baseline (Net2Net GPT) training (PyTorch port)")
    p.add_argument("-b", "--base", required=True, help="model/data config yaml")
    p.add_argument("--output", default="OUTPUT")
    p.add_argument("--name", default="ar_gpt")
    p.add_argument("--codec", default=None, help="the trained codec's torch checkpoint")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: key value [key value ...]")
    return p.parse_args(argv)


def build_model(config, device, seed: int, codec_path=None):
    """The config's ``Net2NetTransformer`` on ``device``, seeded as the JAX
    package's ``init_params``, its codec loaded from ``codec_path`` if given,
    frozen and in eval mode."""
    import torch

    from ..convert.checkpoint import load_torch_state_dict
    from ..utils.config import instantiate_from_config

    with torch.device("meta"):
        model = instantiate_from_config(config["model"])
    model = model.to_empty(device=device).init_params(torch.Generator(device).manual_seed(seed))
    if codec_path:
        sd = {k: v for k, v in load_torch_state_dict(codec_path).items()
              if not k.startswith("loss.")}
        model.codec.load_state_dict(sd)
    model.codec.requires_grad_(False).eval()
    return model


def build_optimizer(model, lr: float):
    """AdamW over the GPT's two groups, decay (Linear and Conv weights) first."""
    import torch

    from ..engine.optimizers import param_groups

    return torch.optim.AdamW(param_groups(model.gpt, WEIGHT_DECAY), lr=lr, betas=BETAS, eps=1e-8)


def train_step(model, optimizer, mel, cond, generator=None):
    """One step: the loss, its gradients (left in ``.grad``) and the AdamW
    update; returns the loss, detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, _ = model.loss(mel, cond, generator)
    loss.backward()
    optimizer.step()
    return loss.detach()


def checkpoint_payload(model, optimizer, epoch: int, step: int) -> dict:
    return {"epoch": int(epoch), "global_step": int(step), "state_dict": model.state_dict(),
            "optimizer_states": [optimizer.state_dict()]}


def main(argv=None) -> int:
    args = get_args(argv)
    import torch

    from ..data.loader import build_dataloader
    from ..engine.checkpoint import save_checkpoint
    from ..engine.logger import Logger
    from ..parallel.distributed import local_device
    from ..utils.config import load_yaml_config, merge_opts_to_config
    from .train_vqgan import to_nhwc

    device = local_device(args.device)
    config = merge_opts_to_config(load_yaml_config(args.base), args.opts)
    logger = Logger(args.output, args.name, is_primary=True)
    logger.save_config(config)
    model = build_model(config, device, args.seed, args.codec)
    model.gpt.train()
    bs = int(config["dataloader"]["batch_size"])
    base_lr = float(config["model"].get("base_learning_rate", 1e-6))
    lr = 1 * bs * base_lr
    logger.log_info(f"lr = 1 x {bs} x {base_lr} = {lr:.2e} on {device}")
    optimizer = build_optimizer(model, lr)
    generator = torch.Generator(device).manual_seed(args.seed + 1)   # pkeep's corruption

    loader = build_dataloader(config, seed=args.seed)["train_loader"]
    max_steps = args.max_steps or 10 ** 9
    it = epoch = 0
    while it < max_steps:
        loader.set_epoch(epoch)
        for batch in loader:
            mel = torch.from_numpy(to_nhwc(batch["image"])).to(device)
            cond = torch.as_tensor(batch["feature"], dtype=torch.float32, device=device)
            loss = train_step(model, optimizer, mel, cond, generator)
            it += 1
            if it % args.log_every == 0:
                logger.log_info(f"e{epoch} it{it} ce_loss {float(loss):.4f}")
                logger.add_scalar("train/loss", float(loss), it)
            if it >= max_steps:
                break
        epoch += 1
        save_checkpoint(os.path.join(logger.ckpt_dir, "last.ckpt"),
                        checkpoint_payload(model, optimizer, epoch, it))
    logger.log_info("done")
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
