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
    "q_pred_one_timestep",
    "q_posterior",
    "log_sample_categorical",
    "q_sample",
    "gumbel_from_uniform",
    "multinomial_kl",
    "log_categorical",
    "clip",
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


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``x.clamp(lo, hi)``'s values with ``jnp.clip``'s gradient: at a bound
    the gradient is halved (a tie of max / min), where ``clamp`` passes all of
    it. The training loss's gradients then match the JAX package's wherever
    a value lands on a bound exactly."""
    bound = lambda v: torch.full((), v, dtype=x.dtype, device=x.device)   # no host copy
    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def log_add_exp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable log(exp(a) + exp(b)); tolerates -inf in either argument."""
    m = torch.maximum(a, b)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def index_to_log_onehot(x: torch.Tensor, num_classes: int, *, check: bool = True) -> torch.Tensor:
    """(B, L) int -> (B, L, K) float32 log one-hot, off-class value log(1e-30).

    The reference asserts ``x.max() < num_classes`` (diffusion_transformer.py:46-47);
    an out-of-range id would one-hot to an all-zeros row that the posterior
    silently renormalizes, so the range is checked on the host first.
    ``check=False`` skips that check and its wait for the device, for ids in
    range by construction (the codec's, in the training loss)."""
    if check:
        mx = int(x.max())
        if mx >= num_classes:
            raise ValueError(f"token id {mx} out of range for {num_classes} classes")
    onehot = torch.nn.functional.one_hot(x.long(), num_classes).float()
    return torch.log(onehot.clamp(min=1e-30))


def log_onehot_to_index(log_x: torch.Tensor) -> torch.Tensor:
    """(B, L, K) -> (B, L) int32 argmax over classes."""
    return log_x.argmax(dim=-1).to(torch.int32)


def _gather_t(coef: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-batch coefficient lookup -> (B, 1, 1), broadcast over (B, L, K)."""
    return coef[t.long()][:, None, None]


def q_pred(sched: DiffusionSchedule, log_x_start: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """log q(x_t | x_0) for ``t`` (B,) in [-1, T-1]; t=-1 is the identity."""
    T = sched.num_timesteps
    t = (t.long() + (T + 1)) % (T + 1)
    tok = log_add_exp(log_x_start[..., :-1] + _gather_t(sched.log_cumprod_at, t),
                      _gather_t(sched.log_cumprod_bt, t))
    msk = log_add_exp(log_x_start[..., -1:] + _gather_t(sched.log_1_min_cumprod_ct, t),
                      _gather_t(sched.log_cumprod_ct, t))
    return torch.cat([tok, msk], dim=-1)


def q_pred_one_timestep(sched: DiffusionSchedule, log_x_t: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """log q(x_t | x_{t-1}) applied to the distribution at x_t (one forward step)."""
    tok = log_add_exp(log_x_t[..., :-1] + _gather_t(sched.log_at, t), _gather_t(sched.log_bt, t))
    msk = log_add_exp(log_x_t[..., -1:] + _gather_t(sched.log_1_min_ct, t),
                      _gather_t(sched.log_ct, t))
    return torch.cat([tok, msk], dim=-1)


def q_posterior(sched: DiffusionSchedule, log_x_start: torch.Tensor, log_x_t: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """log p(x_{t-1} | x_t) given a (possibly soft) x0 prediction, (B, L, K).

    The mask-aware factorization (diffusion_transformer.py:293-339):
    log q(x_{t-1}|x_t, x0) = log p(x0|x_t) + log q(x_t|x_{t-1}) + log q(x_{t-1}|x0)
    - log q(x_t|x0), where positions that hold MASK take the closed-form ``ctt``
    column. Off MASK, the MASK column of both x_t factors is the placeholder
    LOG_EPS, not log 0, and the mass it leaks is kept, as in the reference.
    ``log_x_t`` must be a log one-hot. Clamped to [-70, 0]."""
    K = log_x_start.shape[-1]
    is_mask = (log_onehot_to_index(log_x_t) == K - 1)[..., None]     # (B, L, 1)
    is_tok = torch.arange(K, device=log_x_t.device) < K - 1

    def at_x_t(log_q, log_c):
        # the factor as a function of the class; MASK rows take (c, ..., c, 0)
        log_q = torch.where(is_tok, log_q, LOG_EPS)
        return torch.where(is_mask, torch.where(is_tok, log_c, 0.0), log_q)

    log_qt = at_x_t(q_pred(sched, log_x_t, t), _gather_t(sched.log_cumprod_ct, t))
    log_qt1 = at_x_t(q_pred_one_timestep(sched, log_x_t, t), _gather_t(sched.log_ct, t))
    q = log_x_start - log_qt
    q_norm = torch.logsumexp(q, dim=-1, keepdim=True)
    q = q - q_norm
    out = q_pred(sched, q, t.long() - 1) + log_qt1 + q_norm
    return clip(out, MIN_LOGP, 0.0)


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise from uniforms in [0, 1), the transform the fused
    sampler kernel applies to its Philox draws."""
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


def log_sample_categorical(generator: Optional[torch.Generator], logits: torch.Tensor,
                           gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-argmax sample from per-position log-probs; returns a log one-hot.
    ``gumbel`` (the logits' shape) supplies the noise in place of draws from
    ``generator``."""
    if gumbel is None:
        gumbel = gumbel_from_uniform(
            torch.rand(logits.shape, generator=generator, device=logits.device))
    sample = (gumbel + logits).argmax(dim=-1)
    return index_to_log_onehot(sample, logits.shape[-1])


def q_sample(sched: DiffusionSchedule, generator: Optional[torch.Generator],
             log_x_start: torch.Tensor, t: torch.Tensor,
             gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample x_t ~ q(x_t | x_0) as a log one-hot (forward corruption);
    ``gumbel`` as in ``log_sample_categorical``."""
    return log_sample_categorical(generator, q_pred(sched, log_x_start, t), gumbel)


def multinomial_kl(log_prob1: torch.Tensor, log_prob2: torch.Tensor) -> torch.Tensor:
    """KL(p1 || p2) per position: (B, L, K) -> (B, L)."""
    return (log_prob1.exp() * (log_prob1 - log_prob2)).sum(dim=-1)


def log_categorical(log_x_start: torch.Tensor, log_prob: torch.Tensor) -> torch.Tensor:
    """E_{x0}[log p(x0)] per position (the decoder NLL's numerator): (B, L, K) -> (B, L)."""
    return (log_x_start.exp() * log_prob).sum(dim=-1)
