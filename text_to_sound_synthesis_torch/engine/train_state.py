"""The Stage-2 train state and its train step.

Port of ``text_to_sound_synthesis_tpu/engine/train_state.py``. The JAX
package jits one pure step over a state pytree; here the state holds the
trainable denoiser (its parameters are the params), the optimizer (its
moments), the EMA shadow and the timestep sampler's buffers, and the step
updates them in place. One step, in the JAX step's order: sample t -> the
loss and its gradient (autograd) -> clip (at the step count before the
update) -> AdamW at the given learning rate -> ``step += 1`` -> EMA when
``step % ema_interval == 0`` -> the timestep state.

The frozen codec and text tower run under ``no_grad`` inside the loss and
are not in the optimizer. Under DDP the loss's forward runs through the
wrapped denoiser (its gradients are averaged over the data ranks), and each
step's t, kl and diagnostics are gathered from every data rank, so the
timestep state and the metrics are the whole batch's on every rank, as in
the JAX package's global batch. On a mesh with a model axis
(``parallel/mesh.py``, ``parallel/sharding.py``) the denoiser is split over
the model group: those gathers and DDP run over the data group only (each
model rank holds the same rows), and the clip's norm is the whole model's.
The metrics stay on the device; nothing in the step waits for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models.diffusion.process import (DiscreteDiffusion, TimestepDraws, TimestepSamplerState,
                                        sample_timesteps, update_timestep_state)
from ..parallel.distributed import all_gather_cat
from .clip_grad import ClipGradNorm, clip_by_global_norm
from .ema import ema_copy, ema_update
from .optimizers import set_learning_rate

__all__ = ["DiffusionTrainState", "TrainDraws", "TrainMetrics", "make_train_step"]


class TrainMetrics(NamedTuple):
    loss: torch.Tensor       # scalar (the mean over the data ranks under DDP)
    grad_norm: torch.Tensor  # scalar, before clipping
    acc_x0: torch.Tensor     # (B,) per-sample diagnostics (the whole batch under DDP)
    acc_keep: torch.Tensor   # (B,)
    t: torch.Tensor          # (B,)


class TrainDraws(NamedTuple):
    """A step's random draws, supplied in place of the generator's."""

    timesteps: TimestepDraws
    gumbel: torch.Tensor     # (B, L, K): q_sample's noise


@dataclass
class DiffusionTrainState:
    denoiser: nn.Module                         # trainable; its parameters are the params
    optimizer: torch.optim.Optimizer
    ema_params: Optional[List[torch.Tensor]]    # shadow of named_params(), in its order
    lt: TimestepSamplerState
    step: int = 0

    @classmethod
    def create(cls, denoiser: nn.Module, optimizer: torch.optim.Optimizer,
               num_timesteps: int, with_ema: bool = True) -> "DiffusionTrainState":
        params = [p for _, p in _trainable(denoiser)]
        return cls(denoiser, optimizer, ema_copy(params) if with_ema else None,
                   TimestepSamplerState.create(num_timesteps, params[0].device))

    def named_params(self) -> List[Tuple[str, torch.Tensor]]:
        """The trainable parameters, by name, in the module's order."""
        return _trainable(self.denoiser)


def _trainable(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    return [(n, p) for n, p in module.named_parameters() if p.requires_grad]


def make_train_step(model, clip_grad: Optional[ClipGradNorm] = None, ema_decay: float = 0.99,
                    ema_interval: int = 25, *, ddp: Optional[nn.Module] = None,
                    mesh=None) -> Callable:
    """Returns ``step(state, batch, lr, *, generator=None, draws=None) ->
    (state, TrainMetrics)``.

    ``model`` is the port's ``Diffsound``, ``batch`` ``{content key: mel
    (B, H, W, 1) in [-1, 1], 'condition_token': (B, S) BPE ids}``; or a
    ``DiscreteDiffusion`` (the dry run's), ``batch`` ``{'x0': (B, L) token
    ids, 'cond': (B, S, D) features}``; on the model's device. ``lr`` is the
    host-side scheduler's rate. The draws (t's, then ``q_sample``'s noise)
    come from ``generator`` unless ``draws`` supplies them: on a model axis
    every rank of a model group must draw the same (seed by the data
    index). ``ddp`` runs the loss's forward: the denoiser under DDP
    (``parallel.wrap_ddp``), or a split one. ``mesh``: the step's grid; its
    data group gathers the step's t, kl and metrics (the default group
    without one), and a state whose denoiser is a ``MegatronText2Spec`` clips
    by the whole model's norm."""
    if isinstance(model, DiscreteDiffusion):
        def loss_of(batch, t, pt, **kw):
            return model.train_loss(batch["x0"], batch["cond"], t, pt, **kw)

        rows = "x0"
    else:
        rows = model.content_info["key"]

        def loss_of(batch, t, pt, **kw):
            return model.loss(batch[rows], batch["condition_token"], t, pt, **kw)

    gather = mesh is not None or ddp is not None
    group = None if mesh is None else mesh.data_group

    def step(state: DiffusionTrainState, batch: Mapping[str, torch.Tensor], lr: float, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[TrainDraws] = None):
        B = batch[rows].shape[0]
        t, pt = sample_timesteps(state.lt, B, generator=generator,
                                 draws=None if draws is None else draws.timesteps)
        named = state.named_params()
        params = [p for _, p in named]
        state.optimizer.zero_grad(set_to_none=True)
        out = loss_of(batch, t, pt, generator=generator,
                      gumbel=None if draws is None else draws.gumbel.to(t.device),
                      denoiser=ddp)
        out.loss.backward()
        grads = [p.grad for p in params]
        if any(g is None for g in grads):
            raise RuntimeError("a trainable parameter took no gradient")
        model_axis = {}
        if hasattr(state.denoiser, "sharded_mask"):      # split over a model axis
            model_axis = dict(sharded=state.denoiser.sharded_mask([n for n, _ in named]),
                              reduce=state.denoiser.axis.all_reduce_)
        if clip_grad is not None:
            gnorm = clip_grad(grads, state.step, **model_axis)
        else:
            gnorm = clip_by_global_norm(grads, 1.0, False, **model_axis)
        set_learning_rate(state.optimizer, lr)
        state.optimizer.step()
        state.step += 1
        if state.ema_params is not None and state.step % ema_interval == 0:
            ema_update(state.ema_params, params, ema_decay)

        loss = out.loss.detach()
        t_all, kl, acc_x0, acc_keep = t, out.kl_loss.detach(), out.acc_x0, out.acc_keep
        if gather and dist.is_initialized():
            cols = all_gather_cat(torch.stack([t.float(), kl, acc_x0, acc_keep,
                                               loss.expand_as(kl)], dim=1), group)
            t_all, kl, acc_x0, acc_keep = cols[:, 0].long(), cols[:, 1], cols[:, 2], cols[:, 3]
            loss = cols[::B, 4].mean()   # one entry a rank: the mean of the ranks' losses
        state.lt = update_timestep_state(state.lt, t_all, kl)
        return state, TrainMetrics(loss, gnorm, acc_x0, acc_keep, t_all)

    return step
