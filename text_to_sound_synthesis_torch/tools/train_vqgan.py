"""Stage-1 SpecVQGAN training CLI of the port.

    python -m text_to_sound_synthesis_torch.tools.train_vqgan -b configs/vqgan_caps.yaml \\
        --output OUTPUT --name codebook [--max_steps N] [--lpaps LPAPS.pth] [--auto_resume] \\
        [--val_every_epochs 1] [--log_every 100] [--seed 0] [--device cuda] [key value ...]
    torchrun --nproc_per_node N -m text_to_sound_synthesis_torch.tools.train_vqgan ...

The port of ``tools/train_vqgan.py`` (reference ``Codebook/train.py``): the
config's codec, its lossconfig's PatchGAN and loss weights, the adversarial
two-optimizer step (``engine/vqgan_solver.py``) at lr = world size x batch x
``base_learning_rate`` (the config's batch is per card; train.py:771-782),
validation (reconstruction L1 and codebook usage) every
``--val_every_epochs``, and checkpoints at each epoch's end (the ping-pong
slots ``auto_a`` / ``auto_b``) and at the end (``last``). One process per
card: under ``torchrun`` each rank takes its shard of the data, and the step
averages the gradients over the ranks and takes the PatchGAN's BatchNorm
statistics over the global batch.

``--lpaps`` names a state dict of the whole LPAPS under the reference's
names (``scaling_layer.*``, ``net.slice*``, ``lin*``); without it the
perceptual weight defaults to 0, as in the JAX tool. The codec and the
discriminator start from the JAX package's initialisers, seeded by
``--seed`` (the codebook U(-1/n_e, 1/n_e)).

A checkpoint is a Lightning-layout ``.ckpt`` in ``<output>/<name>/checkpoint``:
``state_dict`` holds the codec under the reference's names and the
discriminator under ``loss.discriminator.``, so ``build_model``'s codec
loader (``content_codec_config.params.ckpt_path``) reads it as it is;
``optimizer_states`` holds both Adams, ``epoch`` and ``global_step`` the
position. ``--auto_resume`` continues from the newest slot bit for bit (the
loader's shuffle is a function of the seed and the epoch).
"""

from __future__ import annotations

import argparse
import os
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description="SpecVQGAN Stage-1 training (PyTorch port)")
    p.add_argument("-b", "--base", required=True, help="model/data config yaml")
    p.add_argument("--output", default="OUTPUT")
    p.add_argument("--name", default="vqgan")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--lpaps", default=None, help="the LPAPS state dict for the perceptual loss")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--val_every_epochs", type=int, default=1)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; this process's card under torchrun) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: key value [key value ...]")
    return p.parse_args(argv)


def to_nhwc(image) -> "np.ndarray":
    """A batch's ``image`` (B, H, W) or (B, 1, H, W) -> (B, H, W, 1) f32."""
    import numpy as np

    v = np.asarray(image, np.float32)
    if v.ndim == 3:
        return v[..., None]
    if v.shape[1] == 1:
        return np.transpose(v, (0, 2, 3, 1))
    return v


def checkpoint_payload(state, epoch: int) -> dict:
    """The Lightning-layout checkpoint of a run (module docstring)."""
    sd = dict(state.codec.state_dict())
    sd.update({f"loss.discriminator.{k}": v for k, v in state.disc.state_dict().items()})
    return {"epoch": int(epoch), "global_step": int(state.step), "state_dict": sd,
            "optimizer_states": [state.ae_opt.state_dict(), state.disc_opt.state_dict()]}


def restore(payload: dict, state) -> int:
    """Load a ``checkpoint_payload`` into ``state``; returns its epoch."""
    sd = payload["state_dict"]
    pre = "loss.discriminator."
    state.codec.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    state.disc.load_state_dict({k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)})
    state.ae_opt.load_state_dict(payload["optimizer_states"][0])
    state.disc_opt.load_state_dict(payload["optimizer_states"][1])
    state.step = int(payload["global_step"])
    return int(payload["epoch"])


def latest(ckpt_dir: str):
    """The path of the slot with the most steps (``last`` wins a tie), or None."""
    from ..engine.checkpoint import load_checkpoint

    cands = []
    for name in ("last", "auto_a", "auto_b"):
        path = os.path.join(ckpt_dir, name + ".ckpt")
        if os.path.exists(path):
            step = int(load_checkpoint(path, mmap=True)["global_step"])
            cands.append((step, name == "last", path))
    return max(cands)[2] if cands else None


def load_lpaps(path: str, device):
    """The frozen LPAPS from a whole state dict under the reference's names
    (its mel-bin count read off ``scaling_layer.shift``); a missing or
    unexpected tensor raises."""
    from ..convert.checkpoint import load_torch_state_dict
    from ..models.lpaps import LPAPS

    sd = dict(load_torch_state_dict(path))
    for k in ("scaling_layer.shift", "scaling_layer.scale"):
        if k in sd:
            sd[k] = sd[k].reshape(-1)
    lpaps = LPAPS(n_mels=int(sd["scaling_layer.shift"].numel()))
    lpaps.load_state_dict(sd)
    return lpaps.to(device).eval()


def main(argv=None) -> int:
    args = get_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..data.loader import build_dataloader
    from ..engine.checkpoint import load_checkpoint, save_checkpoint
    from ..engine.logger import Logger
    from ..engine.vqgan_solver import (VQGANTrainState, disc_kwargs, loss_config,
                                       make_vqgan_train_step)
    from ..models.discriminator import NLayerDiscriminator, init_discriminator_
    from ..models.vqgan.model import VQModel, init_codec_
    from ..parallel.distributed import get_world_size, init_distributed, local_device
    from ..utils.config import load_yaml_config, merge_opts_to_config

    device = local_device(args.device)
    if "RANK" in os.environ:     # started by torchrun
        init_distributed(device)
    try:
        config = merge_opts_to_config(load_yaml_config(args.base), args.opts)
        logger = Logger(args.output, args.name)
        logger.save_config(config)
        mp = config["model"]["params"]
        dd = mp["ddconfig"]
        loss_p = (mp.get("lossconfig") or {}).get("params") or {}
        cfg = loss_config(loss_p, perceptual_default=1.0 if args.lpaps else 0.0)
        input_nc, n_layers, ndf, actnorm = disc_kwargs(loss_p)
        with torch.device(device):
            codec = VQModel(dd, n_embed=mp["n_embed"], embed_dim=mp["embed_dim"])
            disc = NLayerDiscriminator(input_nc, ndf, n_layers, actnorm)
        init_codec_(codec, torch.Generator(device).manual_seed(args.seed))
        init_discriminator_(disc, torch.Generator(device).manual_seed(args.seed + 1))
        lpaps = None
        if args.lpaps and cfg.perceptual_weight > 0:
            lpaps = load_lpaps(args.lpaps, device)

        world = get_world_size()
        base_lr = float(config["model"].get("base_learning_rate", 1e-6))
        bs = int((config.get("data") or {}).get("params", {}).get(
            "batch_size", (config.get("dataloader") or {}).get("batch_size", 8)))
        lr = world * bs * base_lr
        logger.log_info(f"lr = {world} x {bs} x {base_lr} = {lr:.2e} on {device}")
        state = VQGANTrainState.create(codec, disc, lr)
        step = make_vqgan_train_step(lpaps, cfg,
                                     group=dist.group.WORLD if dist.is_initialized() else None)

        loaders = build_dataloader(config, seed=args.seed)
        train_loader = loaders["train_loader"]
        max_steps = args.max_steps or 10 ** 9
        epoch = 0
        if args.auto_resume:
            path = latest(logger.ckpt_dir)
            if path:
                epoch = restore(load_checkpoint(path, map_location=device), state)
                logger.log_info(f"resumed {path} at epoch {epoch}, iter {state.step}")

        def validate():
            vloader = loaders.get("validation_loader")
            if vloader is None:
                return
            codec.eval()
            l1, idx = [], []
            with torch.no_grad():
                for batch in vloader:
                    v = torch.from_numpy(to_nhwc(batch["image"])).to(device)
                    xrec, vq = codec(v)
                    l1.append(float((v - xrec).abs().mean()))
                    idx.append(vq.indices.reshape(-1).cpu().numpy())
            codec.train()
            if l1:
                usage = len(np.unique(np.concatenate(idx)))
                logger.log_info(f"val epoch {epoch}: recon_l1 {np.mean(l1):.5f} codebook usage "
                                f"{usage}/{mp['n_embed']}")
                logger.add_scalar("val/recon_l1", float(np.mean(l1)), state.step)
                logger.add_scalar("val/codebook_usage", usage, state.step)

        done = state.step >= max_steps
        while not done:
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                mel = torch.from_numpy(to_nhwc(batch["image"])).to(device)
                state, metrics = step(state, mel, lr)
                if state.step % args.log_every == 0:
                    used = len(torch.unique(metrics["indices"]))
                    logger.log_info(
                        f"e{epoch} it{state.step} total {float(metrics['total_loss']):.4f} nll "
                        f"{float(metrics['nll_loss']):.4f} perp {float(metrics['perplexity']):.1f}"
                        f" d {float(metrics['disc_loss']):.4f} codes_used {used}/{mp['n_embed']}")
                    for k in ("total_loss", "nll_loss", "quant_loss", "perplexity", "disc_loss"):
                        logger.add_scalar(f"train/{k}", float(metrics[k]), state.step)
                if state.step >= max_steps:
                    done = True
                    break
            epoch += 1
            if logger.is_primary:
                save_checkpoint(os.path.join(logger.ckpt_dir,
                                             ("auto_a" if epoch % 2 == 0 else "auto_b") + ".ckpt"),
                                checkpoint_payload(state, epoch))
            if epoch % args.val_every_epochs == 0:
                validate()
        if logger.is_primary:
            save_checkpoint(os.path.join(logger.ckpt_dir, "last.ckpt"),
                            checkpoint_payload(state, epoch))
        logger.log_info("training done")
        logger.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
