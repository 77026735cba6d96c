"""Discrete (multinomial) diffusion algebra in log space — PyTorch port.

Port of ``text_to_sound_synthesis_tpu/ops/diffusion.py``: the mask-and-replace
schedule of VQ-Diffusion and the pieces of its algebra that the
index-carrying sampler needs (``q_pred``, ``q_sample`` for the
``filter_ratio > 0`` start, the one-hot helpers). Layout is
``(batch, positions L, classes K)`` with classes last, as in the JAX package.

The schedule is built in float64 numpy and cast to float32 exactly as the JAX
package does, so its coefficients match the JAX ones bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "LOG_EPS",
    "MIN_LOGP",
    "DiffusionSchedule",
    "linear_alpha_schedule",
    "make_schedule",
    "index_to_log_onehot",
    "log_onehot_to_index",
    "log_add_exp",
    "q_pred",
    "log_sample_categorical",
    "q_sample",
    "gumbel_from_uniform",
]

#: log(1e-30) — the "log zero" used when converting one-hots to log space.
LOG_EPS = float(np.log(1e-30))
#: hard floor applied to model log-probabilities (reference clamps at -70).
MIN_LOGP = -70.0


class DiffusionSchedule(NamedTuple):
    """Log-space transition coefficients (float32 tensors).

    Per-step arrays have length T; cumulative arrays have length T+1, index T
    encoding the identity transition (``att[T]=1, btt[T]=ctt[T]=0``).
    """

    log_at: torch.Tensor
    log_bt: torch.Tensor
    log_ct: torch.Tensor
    log_1_min_ct: torch.Tensor
    log_cumprod_at: torch.Tensor
    log_cumprod_bt: torch.Tensor
    log_cumprod_ct: torch.Tensor
    log_1_min_cumprod_ct: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.log_at.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(a.to(device) for a in self))


def linear_alpha_schedule(time_step: int, N: int, att_1: float = 0.99999,
                          att_T: float = 0.000009, ctt_1: float = 0.000009,
                          ctt_T: float = 0.9):
    """Linear keep/mask probability schedule in float64 numpy
    (``alpha_schedule``, diffusion_transformer.py:122-151)."""
    steps = np.arange(time_step, dtype=np.float64) / (time_step - 1)
    att_lin = steps * (att_T - att_1) + att_1
    att_full = np.concatenate(([1.0], att_lin))
    at = att_full[1:] / att_full[:-1]

    ctt_lin = steps * (ctt_T - ctt_1) + ctt_1
    ctt_full = np.concatenate(([0.0], ctt_lin))
    one_minus_ct = (1.0 - ctt_full[1:]) / (1.0 - ctt_full[:-1])
    ct = 1.0 - one_minus_ct

    bt = (1.0 - at - ct) / N
    att = np.concatenate((att_full[1:], [1.0]))
    ctt = np.concatenate((ctt_full[1:], [0.0]))
    btt = (1.0 - att - ctt) / N
    return at, bt, ct, att, btt, ctt


_SCHEDULE_KINDS = {
    # kind -> ctt_T (terminal mask probability)
    "mask_and_uniform": 0.9,
    "mask_only": 0.99999,
    "uniform_only": 0.1,
}


def make_schedule(time_step: int, num_classes: int, kind: str = "mask_and_uniform",
                  device: Optional[torch.device] = None) -> DiffusionSchedule:
    """Build the log-space schedule. ``num_classes`` includes the MASK class."""
    if kind not in _SCHEDULE_KINDS:
        raise ValueError(f"unknown schedule kind {kind!r}; options: {sorted(_SCHEDULE_KINDS)}")
    at, bt, ct, att, btt, ctt = linear_alpha_schedule(
        time_step, N=num_classes, ctt_T=_SCHEDULE_KINDS[kind])
    with np.errstate(divide="ignore"):
        arrays = (
            np.log(at), np.log(bt), np.log(ct),
            np.log(1.0 - np.exp(np.log(ct)) + 1e-40),
            np.log(att), np.log(btt), np.log(ctt),
            np.log(1.0 - np.exp(np.log(ctt)) + 1e-40),
        )
    return DiffusionSchedule(*(torch.tensor(a.astype(np.float32), device=device)
                               for a in arrays))


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable log(exp(a) + exp(b)); tolerates -inf in either argument."""
    m = torch.maximum(a, b)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def index_to_log_onehot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, L) int -> (B, L, K) float32 log one-hot, off-class value log(1e-30).

    The reference asserts ``x.max() < num_classes`` (diffusion_transformer.py:46-47);
    an out-of-range id would one-hot to an all-zeros row that the posterior
    silently renormalizes, so the range is checked on the host first."""
    mx = int(x.max())
    if mx >= num_classes:
        raise ValueError(f"token id {mx} out of range for {num_classes} classes")
    onehot = torch.nn.functional.one_hot(x.long(), num_classes).float()
    return torch.log(onehot.clamp(min=1e-30))


def log_onehot_to_index(log_x: torch.Tensor) -> torch.Tensor:
    """(B, L, K) -> (B, L) int32 argmax over classes."""
    return log_x.argmax(dim=-1).to(torch.int32)


def q_pred(sched: DiffusionSchedule, log_x_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log q(x_t | x_0) for ``t`` (B,) in [-1, T-1]; t=-1 is the identity."""
    T = sched.num_timesteps
    t = ((t + (T + 1)) % (T + 1)).long()

    def gather(coef):
        return coef[t][:, None, None]

    tok = log_add_exp(log_x_start[..., :-1] + gather(sched.log_cumprod_at),
                      gather(sched.log_cumprod_bt))
    msk = log_add_exp(log_x_start[..., -1:] + gather(sched.log_1_min_cumprod_ct),
                      gather(sched.log_cumprod_ct))
    return torch.cat([tok, msk], dim=-1)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise from uniforms in [0, 1), the transform the fused
    sampler kernel applies to its Philox draws."""
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


def log_sample_categorical(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-argmax sample from per-position log-probs; returns a log one-hot."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    sample = (gumbel_from_uniform(u) + logits).argmax(dim=-1)
    return index_to_log_onehot(sample, logits.shape[-1])


def q_sample(sched: DiffusionSchedule, generator: torch.Generator,
             log_x_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x_0) as a log one-hot (forward corruption)."""
    return log_sample_categorical(generator, q_pred(sched, log_x_start, t))
