"""Stage-1 SpecVQGAN training: the adversarial two-optimizer step (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/engine/vqgan_solver.py`` (reference
``VQModel.training_step`` / ``configure_optimizers``, ``vqgan.py:88-144``,
and ``VQLPAPSWithDiscriminator``, ``vqperceptual.py:255-395``). One step, in
the JAX step's order:

1. the AE phase: the codec's forward, L1 + the frozen LPAPS, the PatchGAN's
   logits on the reconstruction (batch statistics, the running ones left as
   they are: JAX discards that forward's updates); the adaptive
   discriminator weight ||grad nll|| / (||grad g|| + 1e-4) at the decoder's
   last conv, clamped to [min, max]_adapt_weight, times ``disc_weight`` (a
   constant, with no extra pass, when min == max); the loss nll +
   d_weight * adopt_weight(disc_factor, step, disc_start) * g + codebook
   weight * VQ loss; Adam on the codec;
2. the D phase: a fresh codec forward with the updated weights, the hinge
   (or vanilla) loss on the real batch then the reconstruction, each forward
   updating the BatchNorm running statistics; Adam on the discriminator;
3. the step count, once.

The adaptive weight's two gradients come from the AE forward's graph (as
the reference takes them), where the JAX step runs one more codec forward
for them: the same values, one forward fewer. Both optimizers are Adam with
betas (0.5, 0.9) (``build_gan_optimizer``) at the rate the caller passes
each step.

Data parallel over a process group (``group``): each rank takes its slice
of the global batch; the gradients, the adaptive weight's two gradients and
the metrics are averaged over the ranks (``parallel.all_reduce_mean_``), the
code counts summed for the perplexity, and the PatchGAN's BatchNorm
statistics are the global batch's (``set_batch_stats_group``), so a step is
the JAX package's SPMD step over the global batch. (DDP's hooks expect one
backward a forward; the step's extra gradients do not fit them.)

The metrics stay on the device; nothing in the step waits for it.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.discriminator import frozen_batch_stats, set_batch_stats_group
from ..models.vqgan.quantize import code_counts, perplexity
from ..ops.gan import adopt_weight, hinge_d_loss, hinge_g_loss, vanilla_d_loss
from ..parallel.distributed import all_reduce_mean_
from .optimizers import set_learning_rate

__all__ = ["VQGANLossConfig", "VQGANTrainState", "build_gan_optimizer", "make_vqgan_train_step",
           "make_vqgan_nodisc_train_step", "make_vqgan_segmentation_train_step", "loss_config",
           "disc_kwargs"]


class VQGANLossConfig(NamedTuple):
    """The reference's lossconfig params (audioset_codebook.yaml:19-29)."""

    disc_start: int = 60001
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    disc_factor: float = 1.0
    disc_weight: float = 0.8
    perceptual_weight: float = 1.0
    min_adapt_weight: float = 1.0
    max_adapt_weight: float = 1.0
    disc_loss: str = "hinge"


def build_gan_optimizer(module: nn.Module, lr: float, betas=(0.5, 0.9)) -> torch.optim.Adam:
    """Adam(0.5, 0.9) over ``module``'s parameters (vqgan.py:133-144, both
    optimizers); the rate is set before each step."""
    return torch.optim.Adam(module.parameters(), lr=lr, betas=tuple(betas), eps=1e-8)


@dataclass
class VQGANTrainState:
    codec: nn.Module
    ae_opt: torch.optim.Optimizer
    disc: Optional[nn.Module] = None         # None for the AE-only steps
    disc_opt: Optional[torch.optim.Optimizer] = None
    step: int = 0

    @classmethod
    def create(cls, codec: nn.Module, disc: Optional[nn.Module], lr: float,
               betas=(0.5, 0.9)) -> "VQGANTrainState":
        return cls(codec, build_gan_optimizer(codec, lr, betas), disc,
                   None if disc is None else build_gan_optimizer(disc, lr, betas))


@contextlib.contextmanager
def _frozen_params(module: nn.Module) -> Iterator[None]:
    """``module``'s parameters take no gradient in the block (its activations still pass one)."""
    flags = [(p, p.requires_grad) for p in module.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in flags:
            p.requires_grad_(f)


def _grads(module: nn.Module):
    return [p.grad for p in module.parameters() if p.grad is not None]


def _global(metrics: Dict[str, torch.Tensor], indices: torch.Tensor, n_e: int,
            group) -> Dict[str, torch.Tensor]:
    """The scalar metrics averaged over the ranks, the perplexity of the summed code counts."""
    names = [k for k, v in metrics.items() if k != "perplexity" and v.dim() == 0]
    vals = torch.stack([metrics[k].detach().float() for k in names])
    all_reduce_mean_([vals], group)
    out = dict(metrics, **dict(zip(names, vals.unbind())))
    counts = code_counts(indices, n_e)
    dist.all_reduce(counts, group=group)
    out["perplexity"] = perplexity(counts, indices.numel() * dist.get_world_size(group))
    return out


def _nll(cfg: VQGANLossConfig, lpaps: Optional[nn.Module], mel, xrec):
    """(L1 * pixelloss_weight + perceptual_weight * mean LPAPS, the LPAPS term)."""
    rec = (mel - xrec).abs().mean() * cfg.pixelloss_weight
    if lpaps is not None and cfg.perceptual_weight > 0:
        p = lpaps(mel, xrec).mean()
        return rec + cfg.perceptual_weight * p, p
    return rec, torch.zeros((), device=mel.device)


def make_vqgan_train_step(lpaps: Optional[nn.Module], cfg: VQGANLossConfig = VQGANLossConfig(),
                          *, group=None) -> Callable:
    """Returns ``step(state, mel, lr) -> (state, metrics)``: ``mel`` (B, H, W,
    1) in [-1, 1] on the codec's device, ``lr`` the rate of both optimizers.
    ``lpaps`` is frozen (None: no perceptual term); ``group`` a process
    group for data parallelism (module docstring)."""
    d_loss_fn = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss}[cfg.disc_loss]
    adaptive = cfg.min_adapt_weight != cfg.max_adapt_weight
    if lpaps is not None:
        lpaps.eval()

    def step(state: VQGANTrainState, mel: torch.Tensor, lr: float):
        codec, disc = state.codec, state.disc
        codec.train()
        disc.train()
        if group is not None:
            set_batch_stats_group(disc, group)
        disc_factor = adopt_weight(cfg.disc_factor, state.step, cfg.disc_start)

        # ---- AE phase --------------------------------------------------------
        state.ae_opt.zero_grad(set_to_none=True)
        with frozen_batch_stats(disc), _frozen_params(disc):
            xrec, vq = codec(mel)
            nll, p_loss = _nll(cfg, lpaps, mel, xrec)
            logits_fake = disc(xrec)
        g_loss = hinge_g_loss(logits_fake)
        if adaptive:
            last = codec.decoder.conv_out.weight
            nll_g = torch.autograd.grad(nll, last, retain_graph=True)[0]
            g_g = torch.autograd.grad(g_loss, last, retain_graph=True)[0]
            if group is not None:
                all_reduce_mean_([nll_g, g_g], group)
            d_weight = nll_g.norm() / (g_g.norm() + 1e-4)
            d_weight = d_weight.clamp(cfg.min_adapt_weight, cfg.max_adapt_weight).detach()
            d_weight = d_weight * cfg.disc_weight
        else:
            d_weight = torch.tensor(cfg.min_adapt_weight * cfg.disc_weight, device=mel.device)
        total = nll + d_weight * disc_factor * g_loss + cfg.codebook_weight * vq.loss
        total.backward()
        if group is not None:
            all_reduce_mean_(_grads(codec), group)
        set_learning_rate(state.ae_opt, lr)
        state.ae_opt.step()

        # ---- D phase: a fresh forward with the updated AE ---------------------
        with torch.no_grad():
            xrec_new, _ = codec(mel)
        state.disc_opt.zero_grad(set_to_none=True)
        logits_real = disc(mel)
        logits_fake = disc(xrec_new)
        d_loss = disc_factor * d_loss_fn(logits_real, logits_fake)
        d_loss.backward()
        if group is not None:
            all_reduce_mean_(_grads(disc), group)
        set_learning_rate(state.disc_opt, lr)
        state.disc_opt.step()
        state.step += 1

        metrics = {
            "total_loss": total.detach(), "nll_loss": nll.detach(), "p_loss": p_loss.detach(),
            "g_loss": g_loss.detach(), "quant_loss": vq.loss.detach(),
            "perplexity": vq.perplexity, "d_weight": d_weight.detach(),
            "disc_factor": torch.tensor(float(disc_factor), device=mel.device),
            "disc_loss": torch.as_tensor(d_loss).detach(),
            "logits_real": logits_real.detach().mean(), "logits_fake": logits_fake.detach().mean(),
        }
        if group is not None:
            metrics = _global(metrics, vq.indices, codec.quantize.n_e, group)
        metrics["indices"] = vq.indices
        return state, metrics

    return step


def _make_ae_only_train_step(loss_fn: Callable, group) -> Callable:
    """The single-optimizer (AE-only) step around ``loss_fn(codec, x) -> (loss, aux)``."""

    def step(state: VQGANTrainState, x: torch.Tensor, lr: float):
        state.codec.train()
        state.ae_opt.zero_grad(set_to_none=True)
        loss, aux, vq = loss_fn(state.codec, x)
        loss.backward()
        if group is not None:
            all_reduce_mean_(_grads(state.codec), group)
        set_learning_rate(state.ae_opt, lr)
        state.ae_opt.step()
        state.step += 1
        metrics = {"total_loss": loss.detach(), **{k: v.detach() for k, v in aux.items()},
                   "perplexity": vq.perplexity}
        if group is not None:
            metrics = _global(metrics, vq.indices, state.codec.quantize.n_e, group)
        metrics["indices"] = vq.indices
        return state, metrics

    return step


def make_vqgan_nodisc_train_step(lpaps: Optional[nn.Module],
                                 cfg: VQGANLossConfig = VQGANLossConfig(), *,
                                 group=None) -> Callable:
    """AE-only training (``VQNoDiscModel.training_step``, vqgan.py:302-312):
    L1 (+ LPAPS) + the codebook loss, one Adam. ``step(state, mel, lr)``;
    the state's ``disc`` is None."""
    if lpaps is not None:
        lpaps.eval()

    def loss_fn(codec, mel):
        xrec, vq = codec(mel)
        nll, p_loss = _nll(cfg, lpaps, mel, xrec)
        loss = nll + cfg.codebook_weight * vq.loss
        return loss, {"nll_loss": nll, "p_loss": p_loss, "quant_loss": vq.loss}, vq

    return _make_ae_only_train_step(loss_fn, group)


def make_vqgan_segmentation_train_step(cfg: VQGANLossConfig = VQGANLossConfig(), *,
                                       group=None) -> Callable:
    """Segmentation training (``VQSegmentationModel.training_step``,
    vqgan.py:248-253): the pixel-wise binary cross-entropy of the decoder's
    label logits against the (B, H, W, n_labels) one-hot input, in f32, +
    the codebook loss; one Adam. ``step(state, target, lr)``."""

    def loss_fn(codec, target):
        logits, vq = codec(target)
        bce = F.binary_cross_entropy_with_logits(logits.float(), target.float())
        loss = bce + cfg.codebook_weight * vq.loss
        return loss, {"nll_loss": bce, "quant_loss": vq.loss}, vq

    return _make_ae_only_train_step(loss_fn, group)


def loss_config(params: Optional[dict], perceptual_default: float = 1.0) -> VQGANLossConfig:
    """A config's ``lossconfig.params`` -> ``VQGANLossConfig``, the keys the
    JAX trainer reads (``tools/train_vqgan.py``); the others keep their defaults."""
    p = dict(params or {})
    return VQGANLossConfig(
        disc_start=int(p.get("disc_start", 60001)),
        codebook_weight=float(p.get("codebook_weight", 1.0)),
        disc_weight=float(p.get("disc_weight", 0.8)),
        perceptual_weight=float(p.get("perceptual_weight", perceptual_default)),
        min_adapt_weight=float(p.get("min_adapt_weight", 1.0)),
        max_adapt_weight=float(p.get("max_adapt_weight", 1.0)))


def disc_kwargs(params: Optional[dict]) -> Tuple[int, int, int, bool]:
    """(input_nc, n_layers, ndf, use_actnorm) of the PatchGAN a lossconfig names."""
    p = dict(params or {})
    return (int(p.get("disc_in_channels", 1)), int(p.get("disc_num_layers", 3)),
            int(p.get("disc_ndf", 64)), bool(p.get("use_actnorm", False)))
