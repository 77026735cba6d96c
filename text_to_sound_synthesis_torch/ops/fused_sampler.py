"""Fused reverse-diffusion sampler step (K1) and the int8 engine's fused step
tail (K2) — plain PyTorch + Hopper CUDA kernels.

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

``fused_head_sample`` (K2, ``csrc/fused_head_sample.cu``) adds the final
LayerNorm and the logits head in front of the same step, with the logits kept
in f32; its plain version is ``head_sample_reference``. Both kernels key
their Philox on ``(seed, step)`` and count on ``(row, class)``, so on the same
logits K2 draws what K1 draws. ``seed`` and ``step`` are each a Python int or,
as the TPU kernels' seed is, a one-element int32 tensor on the logits'
device, which the kernel reads there (no host sync; a CUDA graph can replay
the step).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..utils.cuda_build import load_library
from .diffusion import LOG_EPS, MIN_LOGP, DiffusionSchedule, gumbel_from_uniform, log_add_exp
from .quant import LN_EPS

__all__ = ["StepCoeffs", "step_coeffs", "p_sample_from_indices", "fused_p_sample",
           "load_kernel", "head_sample_reference", "fused_head_sample", "load_head_kernel"]

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


def _bisect_threshold(p, r: float, iters: int = _BISECT_ITERS):
    """The top-r threshold tau of rows of probabilities p (..., C): the hi of
    an ``iters``-step bisection of [0, 1] on sum(p > mid) < r, as the
    kernels take it (``csrc/sampler_body.cuh::search_threshold``)."""
    lo = torch.zeros(p.shape[:-1] + (1,), dtype=p.dtype, device=p.device)
    hi = torch.ones_like(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        above = torch.where(p > mid, p, 0.0).sum(dim=-1, keepdim=True)
        take = above < r
        hi = torch.where(take, mid, hi)
        lo = torch.where(take, lo, mid)
    return hi


def _truncate_rows(lp, r: float, iters: int = _BISECT_ITERS):
    """Top-r nucleus over the class axis (keep p > tau, + argmax), no sort."""
    p = torch.exp(lp)
    hi = _bisect_threshold(p, r, iters)
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
                                       ctypes.c_uint, P, P, P]
    lib.t2s_fused_p_sample.restype = ctypes.c_int
    lib.t2s_fused_p_sample_max_classes.argtypes = []
    lib.t2s_fused_p_sample_max_classes.restype = ctypes.c_int
    return lib


KeyWord = Union[int, torch.Tensor]


def _key_word(name: str, v: KeyWord, device: torch.device):
    """A Philox key word as a kernel takes it: (host value, device pointer or
    None). An int must fit in 32 bits; a tensor is one int32 on ``device``."""
    if isinstance(v, torch.Tensor):
        if v.device != device or v.dtype != torch.int32 or v.numel() != 1:
            raise ValueError(f"{name} must be one int32 on {device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
        return 0, v.data_ptr()
    if not 0 <= v < 2**32:
        raise ValueError(f"{name} {v} must fit in 32 bits")
    return v, None


def _host_word(v: KeyWord) -> int:
    """The key word's value as the kernel reads it (an int32 as its 32 bits)."""
    return int(v) & 0xFFFFFFFF if isinstance(v, torch.Tensor) else v


def _cpu_gumbel(shape, seed: int, step: int) -> torch.Tensor:
    """Gumbel noise for the CPU path, from numpy's Philox keyed on both words
    (seed, step) as the kernels' Philox is (the bits differ from the card's)."""
    rng = np.random.Generator(np.random.Philox(key=(seed << 32) | step))
    return gumbel_from_uniform(torch.from_numpy(rng.random(shape, np.float32)))


def _check(name: str, t: torch.Tensor, shape, dtypes, device, contiguous: bool = True):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_p_sample(
    logits: torch.Tensor,       # (B, L, K-1) bf16 or f32
    xt: torch.Tensor,           # (B, L) int32
    coeffs: torch.Tensor,       # (10,) f32, StepCoeffs order, on the logits' device
    seed: KeyWord,              # seed_base of the request
    step: KeyWord = 0,          # step index: the second Philox key word
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
    seed_v, seed_p = _key_word("seed", seed, logits.device)
    step_v, step_p = _key_word("step", step, logits.device)
    if logits.device.type == "cpu":
        if gumbel is None:
            gumbel = _cpu_gumbel((B, L, K), _host_word(seed), _host_word(step))
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
            B * L, Km1, float(truncation_r), seed_v, step_v, seed_p, step_p, stream)
    if err != 0:
        raise RuntimeError(f"fused_p_sample kernel launch failed: cudaError {err}")
    fused_p_sample.launches += 1
    if return_log_probs:
        return tokens, post
    return tokens


fused_p_sample.launches = 0


# ---------------------------------------------------------------------------
# K2: final LayerNorm + logits head + the sampler step
# ---------------------------------------------------------------------------

def head_logits(x: torch.Tensor, norm_out: torch.Tensor, head_w: torch.Tensor,
                head_b: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm (f32, eps 1e-6) -> bf16 -> head dot with an f32 sum +
    bias: (M, D) -> (M, K-1) f32 logits, as K2 computes them."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + LN_EPS)
    xn = xn * norm_out[0].float() + norm_out[1].float()
    return xn.bfloat16().float() @ head_w.float() + head_b.float()


def head_sample_reference(x, xt, norm_out, head_w, head_b, coeffs, *,
                          generator: Optional[torch.Generator] = None,
                          gumbel: Optional[torch.Tensor] = None,
                          truncation_r: float = 0.0):
    """Plain version of K2: x (M, D) bf16, xt (M,) tokens, norm_out (2, D),
    head_w (D, K-1) bf16, head_b (K-1,) -> (tokens (M,) int32, posterior
    log-probs (M, K) f32). ``gumbel`` (M, K) in place of draws."""
    logits = head_logits(x, norm_out, head_w, head_b)
    tokens, post = p_sample_from_indices(
        logits[None], xt.reshape(1, -1), coeffs, generator=generator,
        gumbel=None if gumbel is None else gumbel[None], truncation_r=truncation_r,
        return_log_probs=True)
    return tokens[0], post[0]


@functools.cache
def load_head_kernel() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/fused_head_sample.cu``."""
    lib = load_library("fused_head_sample", ["fused_head_sample.cu"])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.t2s_fused_head_sample.argtypes = [P, P, P, P, I, P, P, P, P, P, P, I, I, I,
                                          ctypes.c_float, ctypes.c_uint, ctypes.c_uint, P, P, P]
    lib.t2s_fused_head_sample.restype = I
    for fn in ("max_classes", "max_width", "pass_classes"):
        getattr(lib, f"t2s_head_sample_{fn}").restype = I
    return lib


def head_weight_rows(head_w: torch.Tensor) -> torch.Tensor:
    """``head_w`` (D, K-1) as K2 loads it by TMA: unit column stride, a row
    pitch of a multiple of 8 classes (16 bytes) and a 16-byte-aligned base.
    The tensor itself when it is so, else a (D, K-1) view of a copy whose
    rows are zero-padded to a multiple of 8 classes. ``fused_head_sample``
    makes the copy per call; a caller that serves a codebook whose K-1 is
    not a multiple of 8 pads once (``sample_tokens_int8`` does)."""
    D, km1 = head_w.shape
    if (head_w.stride(1) == 1 and head_w.stride(0) >= km1 and head_w.stride(0) % 8 == 0
            and head_w.data_ptr() % 16 == 0):
        return head_w
    padded = head_w.new_zeros((D, -(-km1 // 8) * 8))
    padded[:, :km1] = head_w
    return padded[:, :km1]


def fused_head_sample(
    x: torch.Tensor,            # (M, D) bf16 final backbone activations
    xt: torch.Tensor,           # (M,) int32 current tokens
    norm_out: torch.Tensor,     # (2, D) f32: final LayerNorm gamma; beta
    head_w: torch.Tensor,       # (D, K-1) bf16
    head_b: torch.Tensor,       # (K-1,) f32
    coeffs: torch.Tensor,       # (10,) f32, StepCoeffs order
    seed: KeyWord,
    step: KeyWord = 0,
    *,
    truncation_r: float = 0.0,
    gumbel: Optional[torch.Tensor] = None,   # (M, K) f32 in place of Philox
    return_log_probs: bool = False,
):
    """The whole tail of an int8 sampler step in one launch: final LN ->
    logits head (f32, never stored) -> the K1 step. Returns next tokens (M,)
    int32 (+ the posterior log-probs (M, K) f32).

    A CUDA tensor launches the kernel (counted in ``fused_head_sample.launches``);
    a CPU tensor runs ``head_sample_reference`` with numpy Philox noise keyed
    on ``(seed, step)``. The kernel takes up to 2079 classes and D a multiple
    of 32 up to 4096; above 256 classes its logits pass through an f32 (M,
    K - 1) scratch. ``head_w`` may be a view with a padded row pitch
    (``head_weight_rows``)."""
    M, D = x.shape
    Km1 = head_w.shape[1]
    K = Km1 + 1
    seed_v, seed_p = _key_word("seed", seed, x.device)
    step_v, step_p = _key_word("step", step, x.device)
    if x.device.type == "cpu":
        if gumbel is None:
            gumbel = _cpu_gumbel((M, K), _host_word(seed), _host_word(step))
        tokens, post = head_sample_reference(x, xt, norm_out, head_w, head_b, coeffs,
                                             gumbel=gumbel, truncation_r=truncation_r)
        return (tokens, post) if return_log_probs else tokens
    if x.device.type != "cuda":
        raise ValueError(f"fused_head_sample runs on cpu or cuda, got {x.device}")

    dev = x.device
    _check("x", x, (M, D), (torch.bfloat16,), dev)
    _check("xt", xt, (M,), (torch.int32,), dev)
    _check("norm_out", norm_out, (2, D), (torch.float32,), dev)
    _check("head_w", head_w, (D, Km1), (torch.bfloat16,), dev, contiguous=False)
    _check("head_b", head_b, (Km1,), (torch.float32,), dev)
    _check("coeffs", coeffs, (10,), (torch.float32,), dev)
    if gumbel is not None:
        _check("gumbel", gumbel, (M, K), (torch.float32,), dev)
    lib = load_head_kernel()
    if K > lib.t2s_head_sample_max_classes() or D > lib.t2s_head_sample_max_width() or D % 32:
        raise ValueError(f"{K} classes or width {D} outside the kernel's range (K <= "
                         f"{lib.t2s_head_sample_max_classes()}; D a multiple of 32, D <= "
                         f"{lib.t2s_head_sample_max_width()})")
    # 16-byte loads, the bulk copy of norm_out and the weight's TMA map
    x, norm_out = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, norm_out))
    head_w = head_weight_rows(head_w)
    tokens = torch.empty((M,), dtype=torch.int32, device=dev)
    post = torch.empty((M, K), dtype=torch.float32, device=dev) if return_log_probs else None
    scratch = (torch.empty((M, Km1), dtype=torch.float32, device=dev)
               if Km1 > lib.t2s_head_sample_pass_classes() else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.t2s_fused_head_sample(
            x.data_ptr(), xt.data_ptr(), norm_out.data_ptr(), head_w.data_ptr(),
            head_w.stride(0), head_b.data_ptr(), coeffs.data_ptr(), None if gumbel is None else gumbel.data_ptr(),
            tokens.data_ptr(), None if post is None else post.data_ptr(),
            None if scratch is None else scratch.data_ptr(), M, D, Km1, float(truncation_r),
            seed_v, step_v, seed_p, step_p, stream)
    if err != 0:
        raise RuntimeError(f"fused_head_sample kernel launch failed: cudaError {err}")
    fused_head_sample.launches += 1
    if return_log_probs:
        return tokens, post
    return tokens


fused_head_sample.launches = 0
