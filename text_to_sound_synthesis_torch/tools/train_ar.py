"""AR-baseline (Net2Net GPT) training CLI of the port.

    python -m text_to_sound_synthesis_torch.tools.train_ar -b configs/ar_audiocaps.yaml \\
        --output OUTPUT [--name ar_gpt] [--codec CODEC.ckpt] [--max_steps N] [--seed 0] \\
        [--log_every 100] [--device cuda] [key value ...]
    torchrun --nproc_per_node N -m text_to_sound_synthesis_torch.tools.train_ar ...

The port of ``tools/train_ar.py`` (reference ``Net2NetTransformer.shared_step``,
``Codebook/specvqgan/models/cond_transformer.py:353``, with
``caps_transformer.yaml``): the config's ``Net2NetTransformer``, its codec
frozen, next-token cross entropy on the codec's tokens of each batch's
``image`` given its ``feature`` vectors, AdamW (betas 0.9 / 0.95, weight decay
0.01 on the Linear and Conv weights only: the minGPT split,
``engine/optimizers.py::param_groups``) at lr = world size x batch x
``base_learning_rate``, the JAX tool's rule with its device count. The
config's ``batch_size`` is the global batch, as the JAX tool shards it over
its devices: under ``torchrun`` each of the N processes takes its card
(``LOCAL_RANK``), joins the NCCL group (gloo with ``--device cpu``), loads
batch / N of each step's samples from its slice of the data and runs the
GPT under DDP, which averages the gradients, so a step is the step on the
whole batch; the frozen codec stays outside DDP. The config's
``model.params.dtype`` (e.g. ``bfloat16``) is the compute dtype, f32 by
default (``models/gpt/net2net.py``). The weights start from the JAX package's initialisers, seeded by
``--seed``; ``--codec`` names the trained codec, a torch ``.ckpt`` / ``.pth``
/ ``.pt`` holding the reference's ``VQModel`` state dict bare or under
``state_dict`` (``train_vqgan``'s ``last.ckpt``; its ``loss.*`` entries are
dropped).

A checkpoint, ``<output>/<name>/checkpoint/last.ckpt``, written by the
first rank at each epoch's end and at the end, is the reference's Lightning layout:
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


def learning_rate(config, world: int) -> float:
    """lr = world size x the config's (global) batch x ``base_learning_rate``:
    the JAX tool's rule, its device count the world size."""
    bs = int(config["dataloader"]["batch_size"])
    return world * bs * float(config["model"].get("base_learning_rate", 1e-6))


def build_optimizer(model, lr: float):
    """AdamW over the GPT's two groups, decay (Linear and Conv weights) first."""
    import torch

    from ..engine.optimizers import param_groups

    return torch.optim.AdamW(param_groups(model.gpt, WEIGHT_DECAY), lr=lr, betas=BETAS, eps=1e-8)


def train_step(model, optimizer, mel, cond, generator=None, gpt=None):
    """One step: the loss, its gradients (left in ``.grad``) and the AdamW
    update; returns the loss, detached. ``gpt`` is the GPT's DDP wrapper
    under a process group (``parallel.wrap_ddp``): the step then takes this
    rank's share of the batch and the gradients averaged over the ranks."""
    optimizer.zero_grad(set_to_none=True)
    loss, _ = model.loss(mel, cond, generator, gpt)
    loss.backward()
    optimizer.step()
    return loss.detach()


def checkpoint_payload(model, optimizer, epoch: int, step: int) -> dict:
    return {"epoch": int(epoch), "global_step": int(step), "state_dict": model.state_dict(),
            "optimizer_states": [optimizer.state_dict()]}


def main(argv=None) -> int:
    args = get_args(argv)
    import torch
    import torch.distributed as dist

    from ..data.loader import build_dataloader
    from ..engine.checkpoint import save_checkpoint
    from ..engine.logger import Logger
    from ..parallel.distributed import (get_rank, get_world_size, init_distributed,
                                        is_primary, local_device, wrap_ddp)
    from ..utils.config import load_yaml_config, merge_opts_to_config
    from .train_vqgan import to_nhwc

    device = local_device(args.device)
    if "RANK" in os.environ:     # started by torchrun
        init_distributed(device)
    try:
        config = merge_opts_to_config(load_yaml_config(args.base), args.opts)
        logger = Logger(args.output, args.name)
        logger.save_config(config)
        model = build_model(config, device, args.seed, args.codec)
        model.gpt.train()
        gpt = wrap_ddp(model.gpt, device)
        world = get_world_size()
        bs = int(config["dataloader"]["batch_size"])
        if bs % world:
            raise ValueError(f"batch_size {bs} must be a multiple of the world size {world}")
        base_lr = float(config["model"].get("base_learning_rate", 1e-6))
        lr = learning_rate(config, world)
        logger.log_info(f"lr = {world} x {bs} x {base_lr} = {lr:.2e} on {device}, "
                        f"{bs // world} samples a rank")
        optimizer = build_optimizer(model, lr)
        # pkeep's corruption, a stream a rank
        generator = torch.Generator(device).manual_seed(args.seed + 1 + get_rank())

        config["dataloader"]["batch_size"] = bs // world    # this rank's share
        loader = build_dataloader(config, seed=args.seed)["train_loader"]
        max_steps = args.max_steps or 10 ** 9
        it = epoch = 0
        while it < max_steps:
            loader.set_epoch(epoch)
            for batch in loader:
                mel = torch.from_numpy(to_nhwc(batch["image"])).to(device)
                cond = torch.as_tensor(batch["feature"], dtype=torch.float32, device=device)
                loss = train_step(model, optimizer, mel, cond, generator, gpt)
                it += 1
                if it % args.log_every == 0:
                    logger.log_info(f"e{epoch} it{it} ce_loss {float(loss):.4f}")
                    logger.add_scalar("train/loss", float(loss), it)
                if it >= max_steps:
                    break
            epoch += 1
            if is_primary():
                save_checkpoint(os.path.join(logger.ckpt_dir, "last.ckpt"),
                                checkpoint_payload(model, optimizer, epoch, it))
        logger.log_info("done")
        logger.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
