"""VQ-Diffusion's reverse step, written from the paper and the sampler's documented noise.

The "alpha1" mask-and-uniform schedule (Gu et al., VQ-Diffusion, eq. 7-8;
Diffsound's ``alpha_schedule``), the mask-aware posterior
q(x_{t-1} | x_t, x0) from a soft x0 prediction, top-r truncation of the x0
prediction (keep the classes whose inclusive cumulative probability, in
descending order, stays below r, and always the most probable one), and the
Gumbel noise of the program's sampler kernels: Philox4x32-10 (Salmon et al.,
SC'11) keyed on (seed, step), the uniform of class c of row ``row`` being word
(c/32)%4 of Philox(counter = (row, c%32, (c/32)/4, 0)), u = (bits >> 8) 2^-24.
"""

import numpy as np
import torch

LOG_EPS = float(np.log(1e-30))
MIN_LOGP = -70.0


def schedule(T: int, K: int, device, att_1=0.99999, att_T=0.000009, ctt_1=0.000009,
             ctt_T=0.9):
    """Log coefficients of the linear schedule over ``T`` steps and ``K`` classes
    (the last one MASK), float32 on ``device``: a dict of (T,) per-step and
    (T + 1,) cumulative arrays, index T the identity."""
    s = np.arange(T, dtype=np.float64) / (T - 1)
    att = np.concatenate(([1.0], s * (att_T - att_1) + att_1))
    ctt = np.concatenate(([0.0], s * (ctt_T - ctt_1) + ctt_1))
    at = att[1:] / att[:-1]
    ct = 1.0 - (1.0 - ctt[1:]) / (1.0 - ctt[:-1])
    bt = (1.0 - at - ct) / K
    cum_at = np.concatenate((att[1:], [1.0]))
    cum_ct = np.concatenate((ctt[1:], [0.0]))
    cum_bt = (1.0 - cum_at - cum_ct) / K
    with np.errstate(divide="ignore"):
        arrays = dict(log_at=np.log(at), log_bt=np.log(bt), log_ct=np.log(ct),
                      log_1_min_ct=np.log(1.0 - ct + 1e-40), log_cum_at=np.log(cum_at),
                      log_cum_bt=np.log(cum_bt), log_cum_ct=np.log(cum_ct),
                      log_1_min_cum_ct=np.log(1.0 - cum_ct + 1e-40))
    return {k: torch.tensor(v.astype(np.float32), device=device) for k, v in arrays.items()}


def log_add_exp(a, b):
    m = torch.maximum(a, b)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def log_onehot(x, K):
    return torch.log(torch.nn.functional.one_hot(x.long(), K).float().clamp(min=1e-30))


def _at(coef, t):
    return coef[t.long()][:, None, None]


def q_pred(sch, log_x0, t):
    """log q(x_t | x0) for (B,) t in [-1, T - 1]; -1 is the identity."""
    T = sch["log_at"].shape[0]
    t = (t.long() + T + 1) % (T + 1)
    tok = log_add_exp(log_x0[..., :-1] + _at(sch["log_cum_at"], t), _at(sch["log_cum_bt"], t))
    msk = log_add_exp(log_x0[..., -1:] + _at(sch["log_1_min_cum_ct"], t),
                      _at(sch["log_cum_ct"], t))
    return torch.cat([tok, msk], dim=-1)


def q_pred_one(sch, log_xt, t):
    tok = log_add_exp(log_xt[..., :-1] + _at(sch["log_at"], t), _at(sch["log_bt"], t))
    msk = log_add_exp(log_xt[..., -1:] + _at(sch["log_1_min_ct"], t), _at(sch["log_ct"], t))
    return torch.cat([tok, msk], dim=-1)


def q_posterior(sch, log_x0, xt, t):
    """log p(x_{t-1} | x_t) (B, L, K) from a soft x0 prediction ``log_x0`` (B, L, K),
    token ids ``xt`` (B, L) and (B,) timesteps ``t``; clamped to [-70, 0]."""
    K = log_x0.shape[-1]
    log_xt = log_onehot(xt, K)
    is_mask = (xt.long() == K - 1)[..., None]
    is_tok = torch.arange(K, device=xt.device) < K - 1

    def factor(log_q, log_c):
        log_q = torch.where(is_tok, log_q, LOG_EPS)
        return torch.where(is_mask, torch.where(is_tok, log_c, 0.0), log_q)

    log_qt = factor(q_pred(sch, log_xt, t), _at(sch["log_cum_ct"], t))
    log_qt1 = factor(q_pred_one(sch, log_xt, t), _at(sch["log_ct"], t))
    q = log_x0 - log_qt
    norm = torch.logsumexp(q, dim=-1, keepdim=True)
    out = q_pred(sch, q - norm, t.long() - 1) + log_qt1 + norm
    return out.clamp(MIN_LOGP, 0.0)


def log_x0_from_logits(logits, truncation_r: float = 0.0):
    """Denoiser logits (B, L, K - 1) -> log p(x0) (B, L, K): log-softmax, the MASK
    column at -70, clamped; with ``truncation_r`` the top-r nucleus kept and the
    rest at -70."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp = torch.cat([lp, torch.full_like(lp[..., :1], MIN_LOGP)], dim=-1).clamp(MIN_LOGP, 0.0)
    if truncation_r <= 0.0:
        return lp
    p_sorted, order = torch.exp(lp).sort(dim=-1, descending=True)
    keep_sorted = p_sorted.cumsum(dim=-1) < truncation_r
    keep_sorted[..., 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, lp, MIN_LOGP)


def gumbel_from_uniform(u):
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


_M32 = 0xFFFFFFFF


def _mul_hi_lo(a: int, c):
    """(a * c) >> 32 and (a * c) mod 2^32 for a 32-bit constant and int64 c < 2^32."""
    ch, cl = c >> 16, c & 0xFFFF
    p1, p0 = a * ch, a * cl
    return (p1 + (p0 >> 16)) >> 16, (((p1 & 0xFFFF) << 16) + p0) & _M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words."""
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(0xD2511F53, c0)
        hi1, lo1 = _mul_hi_lo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def kernel_gumbel(rows: int, K: int, seed: int, step: int, device) -> torch.Tensor:
    """(rows, K) float32 Gumbel noise as the sampler kernels draw it for (seed,
    step); on the CPU, where the program runs its plain sampler, as that draws
    it: numpy's Philox keyed on (seed << 32) | step."""
    if torch.device(device).type == "cpu":
        rng = np.random.Generator(np.random.Philox(key=(seed << 32) | step))
        return gumbel_from_uniform(torch.from_numpy(rng.random((rows, K), np.float32)))
    nblk = -(-K // 128)
    row = torch.arange(rows, device=device, dtype=torch.int64)[:, None, None]
    lane = torch.arange(32, device=device, dtype=torch.int64)[None, :, None]
    blk = torch.arange(nblk, device=device, dtype=torch.int64)[None, None, :]
    shape = (rows, 32, nblk)
    words = philox4x32_10(row.expand(shape), lane.expand(shape), blk.expand(shape),
                          torch.zeros(shape, dtype=torch.int64, device=device),
                          seed & _M32, step & _M32)
    bits = torch.stack(words, dim=-1)                      # (rows, lane, blk, word)
    bits = bits.permute(0, 2, 3, 1).reshape(rows, nblk * 128)[:, :K]   # c = 32 (4 blk + w) + lane
    u = (bits >> 8).float() * (1.0 / 16777216.0)
    return gumbel_from_uniform(u)
