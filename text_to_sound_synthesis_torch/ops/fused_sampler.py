"""Fused reverse-diffusion sampler step (K1) — plain PyTorch + Hopper CUDA kernel.

Port of ``text_to_sound_synthesis_tpu/ops/fused_sampler.py`` (``StepCoeffs``,
``step_coeffs``, ``p_sample_from_indices``, ``fused_p_sample``). Everything in
a sampler step except the transformer forward:

  logits -> log_softmax -> [-70] MASK column -> top-r truncation (bisection
  threshold, no sort) -> mask-aware q_posterior from token INDICES ->
  Gumbel-argmax -> next token indices.

``p_sample_from_indices`` is the plain PyTorch version and defines the
semantics. ``fused_p_sample`` launches the hand-written kernel
``csrc/fused_sampler.cu`` for a CUDA tensor and takes the plain version only
for a CPU tensor; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..utils.cuda_build import load_library
from .diffusion import LOG_EPS, MIN_LOGP, DiffusionSchedule, gumbel_from_uniform, log_add_exp

__all__ = ["StepCoeffs", "step_coeffs", "p_sample_from_indices", "fused_p_sample",
           "load_kernel"]

_BISECT_ITERS = 24


class StepCoeffs(NamedTuple):
    """Schedule coefficients for one sampler step (posterior at t_post), in the
    order the kernel reads them."""

    log_at: torch.Tensor
    log_bt: torch.Tensor
    log_ct: torch.Tensor
    log_cum_at: torch.Tensor
    log_cum_bt: torch.Tensor
    log_cum_ct: torch.Tensor
    log_cum_at_prev: torch.Tensor       # at t_post - 1 (identity when t_post == 0)
    log_cum_bt_prev: torch.Tensor
    log_cum_ct_prev: torch.Tensor
    log_1_min_cum_ct_prev: torch.Tensor

    def as_array(self) -> torch.Tensor:
        """(..., 10) float32: one row per step when ``t_post`` was a vector."""
        return torch.stack(list(self), dim=-1)


def step_coeffs(sched: DiffusionSchedule, t_post: Union[int, torch.Tensor]) -> StepCoeffs:
    """Gather the 10 coefficients for posterior time ``t_post`` (an int, or a
    vector of steps for a whole ``(n_steps, 10)`` table)."""
    T = sched.num_timesteps
    tp = torch.as_tensor(t_post, dtype=torch.long, device=sched.log_at.device)
    tprev = (tp - 1 + (T + 1)) % (T + 1)
    return StepCoeffs(
        log_at=sched.log_at[tp],
        log_bt=sched.log_bt[tp],
        log_ct=sched.log_ct[tp],
        log_cum_at=sched.log_cumprod_at[tp],
        log_cum_bt=sched.log_cumprod_bt[tp],
        log_cum_ct=sched.log_cumprod_ct[tp],
        log_cum_at_prev=sched.log_cumprod_at[tprev],
        log_cum_bt_prev=sched.log_cumprod_bt[tprev],
        log_cum_ct_prev=sched.log_cumprod_ct[tprev],
        log_1_min_cum_ct_prev=sched.log_1_min_cumprod_ct[tprev],
    )


def _posterior_rows(lp, xt, c: StepCoeffs, K: int, col):
    """Posterior log-probs over (..., K) given token indices xt (..., 1)."""
    is_tok = col < K - 1
    onehot_log = torch.where(col == xt, 0.0, LOG_EPS)
    state_is_mask = xt == K - 1

    log_qt = torch.where(is_tok, log_add_exp(onehot_log + c.log_cum_at, c.log_cum_bt), LOG_EPS)
    log_qt = torch.where(state_is_mask, torch.where(is_tok, c.log_cum_ct, 0.0), log_qt)
    log_qt1 = torch.where(is_tok, log_add_exp(onehot_log + c.log_at, c.log_bt), LOG_EPS)
    log_qt1 = torch.where(state_is_mask, torch.where(is_tok, c.log_ct, 0.0), log_qt1)

    q = lp - log_qt
    qlse = torch.logsumexp(q, dim=-1, keepdim=True)
    qn = q - qlse
    prev_tok = log_add_exp(qn + c.log_cum_at_prev, c.log_cum_bt_prev)
    prev_msk = log_add_exp(qn + c.log_1_min_cum_ct_prev, c.log_cum_ct_prev)
    out = torch.where(is_tok, prev_tok, prev_msk) + log_qt1 + qlse
    return out.clamp(MIN_LOGP, 0.0)


def _truncate_rows(lp, r: float, iters: int = _BISECT_ITERS):
    """Bisection top-r nucleus over the class axis (keep p > tau, + argmax)."""
    p = torch.exp(lp)
    lo = torch.zeros(lp.shape[:-1] + (1,), dtype=lp.dtype, device=lp.device)
    hi = torch.ones_like(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = torch.where(p > mid, p, 0.0).sum(dim=-1, keepdim=True)
        take = above < r
        hi = torch.where(take, mid, hi)
        lo = torch.where(take, lo, mid)
    amax = lp.amax(dim=-1, keepdim=True)
    keep = (p > hi) | (lp == amax)
    return torch.where(keep, lp, MIN_LOGP)


def _as_coeffs(coeffs) -> StepCoeffs:
    return coeffs if isinstance(coeffs, StepCoeffs) else StepCoeffs(*coeffs.float().unbind(-1))


def p_sample_from_indices(
    logits: torch.Tensor,            # (B, L, K-1) raw denoiser logits
    xt: torch.Tensor,                # (B, L) current token indices
    coeffs,                          # StepCoeffs or a (10,) tensor
    *,
    generator: Optional[torch.Generator] = None,
    gumbel: Optional[torch.Tensor] = None,   # (B, L, K) noise in place of draws
    truncation_r: float = 0.0,       # 0 disables
    return_log_probs: bool = False,
):
    """Plain PyTorch version of the fused step; returns next token indices
    (B, L) int32 (+ the posterior log-probs (B, L, K) when asked)."""
    c = _as_coeffs(coeffs)
    K = logits.shape[-1] + 1
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp = torch.cat([lp, torch.full_like(lp[..., :1], MIN_LOGP)], dim=-1).clamp(MIN_LOGP, 0.0)
    if truncation_r > 0.0:
        lp = _truncate_rows(lp, truncation_r)
    col = torch.arange(K, device=lp.device)
    out = _posterior_rows(lp, xt[..., None].long(), c, K, col)
    if gumbel is None:
        gumbel = gumbel_from_uniform(
            torch.rand(out.shape, generator=generator, device=out.device))
    tokens = (out + gumbel).argmax(dim=-1).to(torch.int32)
    if return_log_probs:
        return tokens, out
    return tokens


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/fused_sampler.cu``; later calls
    return the loaded library without touching the sources."""
    lib = load_library("fused_sampler", ["fused_sampler.cu"])
    P = ctypes.c_void_p
    lib.t2s_fused_p_sample.argtypes = [P, ctypes.c_int, P, P, P, P, P, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_float, ctypes.c_uint,
                                       ctypes.c_uint, P]
    lib.t2s_fused_p_sample.restype = ctypes.c_int
    lib.t2s_fused_p_sample_max_classes.argtypes = []
    lib.t2s_fused_p_sample_max_classes.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, logits on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_p_sample(
    logits: torch.Tensor,       # (B, L, K-1) bf16 or f32
    xt: torch.Tensor,           # (B, L) int32
    coeffs: torch.Tensor,       # (10,) f32, StepCoeffs order, on the logits' device
    seed: int,                  # seed_base of the request
    step: int = 0,              # step index: the second Philox key word
    *,
    truncation_r: float = 0.0,
    gumbel: Optional[torch.Tensor] = None,   # (B, L, K) f32 in place of Philox
    return_log_probs: bool = False,
):
    """One fused sampler step; returns next token indices (B, L) int32
    (+ the posterior log-probs (B, L, K) f32 when ``return_log_probs``).

    A CUDA tensor launches the kernel (and counts it in
    ``fused_p_sample.launches``); a CPU tensor runs ``p_sample_from_indices``
    with Gumbel noise from numpy's Philox keyed on ``(seed, step)``."""
    B, L, Km1 = logits.shape
    K = Km1 + 1
    if not (0 <= seed < 2**32 and 0 <= step < 2**32):
        raise ValueError(f"seed {seed} and step {step} must fit in 32 bits")
    if logits.device.type == "cpu":
        if gumbel is None:  # keyed on both words, as the kernel's Philox is
            rng = np.random.Generator(np.random.Philox(key=(seed << 32) | step))
            gumbel = gumbel_from_uniform(torch.from_numpy(rng.random((B, L, K), np.float32)))
        return p_sample_from_indices(logits, xt, coeffs, gumbel=gumbel,
                                     truncation_r=truncation_r,
                                     return_log_probs=return_log_probs)
    if logits.device.type != "cuda":
        raise ValueError(f"fused_p_sample runs on cpu or cuda, got {logits.device}")

    dev = logits.device
    _check("logits", logits, (B, L, Km1), (torch.bfloat16, torch.float32), dev)
    _check("xt", xt, (B, L), (torch.int32,), dev)
    _check("coeffs", coeffs, (10,), (torch.float32,), dev)
    if gumbel is not None:
        _check("gumbel", gumbel, (B, L, K), (torch.float32,), dev)
    lib = load_kernel()
    if K > lib.t2s_fused_p_sample_max_classes():
        raise ValueError(f"{K} classes exceed the kernel's limit")
    tokens = torch.empty((B, L), dtype=torch.int32, device=dev)
    post = torch.empty((B, L, K), dtype=torch.float32, device=dev) if return_log_probs else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.t2s_fused_p_sample(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16), xt.data_ptr(),
            coeffs.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
            tokens.data_ptr(), None if post is None else post.data_ptr(),
            B * L, Km1, float(truncation_r), seed, step, stream)
    if err != 0:
        raise RuntimeError(f"fused_p_sample kernel launch failed: cudaError {err}")
    fused_p_sample.launches += 1
    if return_log_probs:
        return tokens, post
    return tokens


fused_p_sample.launches = 0
