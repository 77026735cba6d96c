"""Train the mel classifiers behind evaluation and the perceptual loss (PyTorch port).

    python -m text_to_sound_synthesis_torch.tools.train_classifier --arch vggishish \\
        --spec_dir 'feats/*/melspec_10s_22050hz' [--split_path split_train.txt] \\
        [--stats means_stds.txt] [--num_classes 309] [--mel_num 80] [--crop_len 848] \\
        [--batch_size 16] [--lr 3e-4] [--weight_decay 1e-4] [--epochs 100] \\
        [--weighted_ce | --no-weighted_ce] [--conv_layers 8,MP,16] \\
        [--out OUTPUT] [--seed 0] [--device cuda]

The port of ``tools/train_classifier.py`` (reference
``Codebook/specvqgan/modules/losses/vggishish/train_vggishish.py``,
``train_melception.py``), with its flags plus ``--device``: the ``SpecsDataset``
layout (``<class>/<vid>`` split rows, class-wildcard mel dirs), standardised
with the train set's per-bin mean / std (``--stats``, [0, 1] domain), the
inverse-frequency weighted cross entropy, AdamW over every parameter
(``engine/classifier_solver.py``), validation metrics (accuracy@1 / 5, mAP,
mROCAUC, d-prime) each epoch. ``--arch melception`` trains its BatchNorms as
the JAX package's folded affine: their running statistics stay 0 and
1 - eps.

The weights start from the JAX package's initialisers, seeded by ``--seed``.
Checkpoints are single files in ``<out>/<arch>/checkpoint/``: ``last.pth``
each epoch and ``best.pth`` at the best validation accuracy@1, each
``{"model": state_dict, "epoch": ..., <metrics>}`` (a released melception
``.pt``'s layout, so ``load_melception_checkpoint`` reads ``best.pth``).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def get_args(argv=None):
    p = argparse.ArgumentParser(description="mel classifier training (PyTorch port)")
    p.add_argument("--arch", choices=["vggishish", "melception"], default="vggishish")
    p.add_argument("--spec_dir", required=True)
    p.add_argument("--split_path", default=None)
    p.add_argument("--stats", default=None, help="per-bin mean/std txt ([0,1] domain)")
    p.add_argument("--num_classes", type=int, default=309)
    p.add_argument("--mel_num", type=int, default=80)
    p.add_argument("--crop_len", type=int, default=848)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--weighted_ce", action=argparse.BooleanOptionalAction, default=True,
                   help="inverse-frequency class weights (--no-weighted_ce to disable)")
    p.add_argument("--conv_layers", default=None,
                   help="vggishish conv stack override, comma list of widths and MP tokens "
                        "(e.g. '8,MP,16') - small-geometry runs")
    p.add_argument("--out", default="OUTPUT")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def standardize(image, means, stds) -> np.ndarray:
    """A batch's ``image`` (B, H, W) or (B, 1, H, W) -> (B, H, W) f32,
    standardised per mel bin when ``means`` is given."""
    mel = np.asarray(image, np.float32)
    if mel.ndim == 4:
        mel = mel[:, 0]
    if means is not None:
        mel = (mel - means[None, :, None]) / stds[None, :, None]
    return mel


def build_classifier(arch: str, num_classes: int, conv_layers=None, use_bn: bool = False):
    """The classifier (on the meta device: materialise it with ``to_empty``)."""
    import torch

    with torch.device("meta"):
        if arch == "vggishish":
            from ..models.lpaps.vggishish import VGG16_LAYERS, VGGishish

            return VGGishish(conv_layers or VGG16_LAYERS, use_bn=use_bn, num_classes=num_classes)
        from ..models.melception import Melception

        return Melception(num_classes=num_classes, features_list=("logits",))


def init_classifier_(model, generator):
    """The JAX package's initialisers (``utils.init.init_random_``); the
    BatchNorms' running statistics at torch's defaults (0, 1), Melception's
    at the folded affine's (``unit_batch_stats_``)."""
    from torch import nn

    from ..models.melception import Melception, unit_batch_stats_
    from ..utils.init import init_random_

    init_random_(model, generator)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
    if isinstance(model, Melception):
        unit_batch_stats_(model)
    return model


def parse_conv_layers(text):
    return tuple(t if t == "MP" else int(t) for t in text.split(",")) if text else None


def main(argv=None) -> int:
    args = get_args(argv)
    import torch

    from ..data.datasets import SpecsDataset
    from ..data.loader import ShardedLoader
    from ..engine.checkpoint import checkpoint_path, save_checkpoint
    from ..engine.classifier_solver import (ClassifierTrainState, classification_metrics,
                                            logits_of, make_classifier_train_step)
    from ..engine.logger import Logger
    from ..parallel.distributed import local_device

    device = local_device(args.device)
    logger = Logger(args.out, args.arch)
    train_ds = SpecsDataset("train", args.spec_dir, split_path=args.split_path,
                            mel_num=args.mel_num, spec_crop_len=args.crop_len, random_crop=True)
    val_ds = SpecsDataset("valid", args.spec_dir, split_path=args.split_path,
                          mel_num=args.mel_num, spec_crop_len=args.crop_len)
    means = stds = None
    if args.stats:
        means, stds = np.loadtxt(args.stats, dtype=np.float32).T
        means, stds = 2 * means - 1, 2 * stds      # [0, 1] stats -> the [-1, 1] domain

    model = build_classifier(args.arch, args.num_classes,
                             parse_conv_layers(args.conv_layers)).to_empty(device=device)
    init_classifier_(model, torch.Generator(device).manual_seed(args.seed))
    weights = None
    if args.weighted_ce:
        counts = np.bincount([train_ds.label2target[r.split("/")[0]] for r in train_ds.rows],
                             minlength=args.num_classes).astype(np.float32)
        weights = torch.as_tensor(counts.sum() / np.maximum(counts, 1.0), device=device)
    state = ClassifierTrainState.create(model, args.lr, args.weight_decay)
    step = make_classifier_train_step(weights)
    logger.log_info(f"{args.arch}: {sum(p.numel() for p in model.parameters())} parameters "
                    f"on {device}")

    loader = ShardedLoader(train_ds, args.batch_size, seed=args.seed)
    best = 0.0
    for epoch in range(args.epochs):
        loader.set_epoch(epoch)
        for batch in loader:
            mel = torch.from_numpy(standardize(batch["image"], means, stds)).to(device)
            target = torch.as_tensor(np.asarray(batch["target"]), device=device).long()
            metrics = step(state, mel, target)
            if state.step % 100 == 0:
                logger.log_info(f"e{epoch} it{state.step} loss {float(metrics['loss']):.4f} "
                                f"acc {float(metrics['accuracy']):.3f}")
        model.eval()
        logits, targets = [], []
        with torch.no_grad():
            for batch in ShardedLoader(val_ds, args.batch_size, shuffle=False, drop_last=False):
                mel = torch.from_numpy(standardize(batch["image"], means, stds)).to(device)
                logits.append(logits_of(model(mel)).float().cpu().numpy())
                targets.append(np.asarray(batch["target"]))
        m = classification_metrics(np.concatenate(targets), np.concatenate(logits))
        logger.log_info(f"epoch {epoch} val: {m}")
        payload = {"model": model.state_dict(), "epoch": epoch, **m}
        if m["accuracy_1"] > best:
            best = m["accuracy_1"]
            save_checkpoint(checkpoint_path(logger.ckpt_dir, "best"), payload)
        save_checkpoint(checkpoint_path(logger.ckpt_dir, "last"), payload)
    logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
