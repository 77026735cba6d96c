"""Diffsound's Stage-2 training step, plain float32.

VQ-Diffusion's loss (Gu et al. 2022, sec. 3.2 and the ``vb_stochastic``
objective): x_t drawn from q(x_t | x0) by Gumbel-argmax, the denoiser's x0
prediction, the KL between the true and the model's posterior (the decoder
NLL at t = 0), each position weighted by ``mask_weight``, divided by the
importance weight pt, plus the auxiliary x0 KL at (t / T + 1) x
``auxiliary_loss_weight``; the sum over the batch over B L. Then global-norm
clipping and AdamW (Loshchilov and Hutter: decoupled decay on the Linear
weights only, bias-corrected moments, eps after the square root).
"""

import torch

from . import denoiser as rden
from . import sampler as rsamp


def diffusion_loss(w, x0, cond, t, pt, gumbel, sch, *, dims: dict, aux_weight: float,
                   mask_weight=(1.0, 1.0)):
    K = gumbel.shape[-1]
    T = sch["log_at"].shape[0]
    B, L = x0.shape
    log_x0 = rsamp.log_onehot(x0, K)
    xt = (gumbel + rsamp.q_pred(sch, log_x0, t)).argmax(-1)
    logits = rden.head_logits(w, rden.denoiser(w, xt, t, cond, **dims))
    lp = torch.log_softmax(logits, dim=-1)
    lp = torch.cat([lp, torch.full_like(lp[..., :1], rsamp.MIN_LOGP)], dim=-1)
    recon = torch.minimum(torch.maximum(lp, torch.tensor(rsamp.MIN_LOGP, device=lp.device)),
                          torch.tensor(0.0, device=lp.device))
    model_post = rsamp.q_posterior(sch, recon, xt, t)
    true_post = rsamp.q_posterior(sch, log_x0, xt, t)
    kl = (true_post.exp() * (true_post - model_post)).sum(-1)
    is_mask = (xt == K - 1).float()
    mw = is_mask * mask_weight[0] + (1.0 - is_mask) * mask_weight[1]
    kl = (kl * mw).sum(-1)
    nll = -(log_x0.exp() * model_post).sum(-1).sum(-1)
    t0 = (t == 0).float()
    vb = (t0 * nll + (1.0 - t0) * kl) / pt
    kl_aux = (log_x0[..., :-1].exp() * (log_x0[..., :-1] - recon[..., :-1])).sum(-1)
    kl_aux = (kl_aux * mw).sum(-1)
    vb = vb + (t.float() / T + 1.0) * aux_weight * (t0 * nll + (1.0 - t0) * kl_aux) / pt
    return vb.sum() / (B * L)


def decays(name: str, p) -> bool:
    """AdamW's decay falls on the Linear weights: the 2-D weights that are not
    embedding tables."""
    return p.dim() == 2 and not name.endswith("emb.weight")


class AdamW:
    """The update of ``torch.optim.AdamW`` on a dict of leaves, written out."""

    def __init__(self, params: dict, *, betas, weight_decay: float, eps: float = 1e-8):
        self.params = params
        self.b1, self.b2 = betas
        self.wd, self.eps = weight_decay, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.k = 0

    @torch.no_grad()
    def step(self, grads: dict, lr: float):
        self.k += 1
        c1, c2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        for n, p in self.params.items():
            g = grads[n]
            if decays(n, p):
                p.mul_(1 - lr * self.wd)
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.addcdiv_(self.m[n], (self.v[n].sqrt() / c2 ** 0.5).add_(self.eps), value=-lr / c1)


def clip_global(grads: dict, max_norm: float):
    total = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()]))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """{leaf: the gap between two norms}: |prog - ref| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = torch.tensor([ref[n] for n in ref]).median().item()
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in ref if keep is None or keep(n)}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keep).values())
