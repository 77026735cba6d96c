"""DiscreteDiffusion, its training loss, and the reverse samplers (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/diffusion/process.py``: the
denoiser plus its schedule (``DiscreteDiffusion``) and its VLB training loss
(``train_loss``) with the importance sampler of the timesteps
(``TimestepSamplerState``, ``sample_timesteps``, ``update_timestep_state``),
the timestep plan of the full and the strided (``fast<k>``) sampler,
``sample_tokens_fused``, whose per-step work outside the transformer is the
fused sampler kernel (``ops/fused_sampler.py``), its data-parallel form
``sample_tokens_fused_sharded``, and ``sample_tokens``, the one-hot reference
sampler (plain PyTorch: ``predict_start`` -> a truncation filter ->
``q_posterior`` -> Gumbel argmax, on a (B, L, K) log one-hot state).

The step loops are Python loops (the JAX package's ``lax.scan``). In the
fused one, as there, the AdaLN tables and the cross-attention K/V are
computed once before it, and all steps' coefficients sit in one
``(n_steps, 10)`` device tensor, so the loop makes no host round trip. The
one-hot loop is the reference's algorithm as the JAX package runs it: the
whole denoiser every step, nothing hoisted.

Every random draw of the training loss can be supplied: the timesteps'
(``TimestepDraws``) and ``q_sample``'s Gumbel noise. Nothing in the loss or
the timestep sampler waits for the device.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops import diffusion as dd
from ...ops import fused_sampler as fs
from ...parallel.distributed import replica, run_sharded
from ...utils.config import instantiate_from_config, register
from .backbone import Text2SpecTransformer

__all__ = ["DiscreteDiffusion", "DiffusionLossOutput", "TimestepSamplerState", "TimestepDraws",
           "sample_timesteps", "update_timestep_state", "OneHotDraws", "sample_tokens",
           "sample_tokens_fused", "sample_tokens_fused_sharded"]


class DiffusionLossOutput(NamedTuple):
    loss: torch.Tensor            # scalar: vb_loss.sum() / (B * L)
    kl_loss: torch.Tensor         # (B,) per-sample kl (the decoder nll at t = 0)
    t: torch.Tensor               # (B,) the timesteps
    acc_x0: torch.Tensor          # (B,) share of positions where argmax x0_recon == x0
    acc_keep: torch.Tensor        # (B,) share where the posterior's argmax == x_t
    log_model_prob: torch.Tensor  # (B, L, K)


class TimestepSamplerState(NamedTuple):
    """Importance-sampling buffers (diffusion_transformer.py:233-234, 379-406),
    f32 tensors on the training device."""

    Lt_history: torch.Tensor  # (T,) EMA of the squared kl per timestep
    Lt_count: torch.Tensor    # (T,) visits

    @classmethod
    def create(cls, num_timesteps: int, device=None) -> "TimestepSamplerState":
        return cls(torch.zeros(num_timesteps, device=device),
                   torch.zeros(num_timesteps, device=device))


class TimestepDraws(NamedTuple):
    """The draws of ``sample_timesteps``, supplied in place of the generator's."""

    gumbel: torch.Tensor    # (B, T) Gumbel noise of the importance draw
    uniform: torch.Tensor   # (B,) ints in [0, T): the uniform draw


def timestep_probs(state: TimestepSamplerState) -> torch.Tensor:
    """(T,) importance probabilities: sqrt(Lt_history + 1e-10) + 1e-4, its
    first entry (the decoder term) overwritten by the second, normalised."""
    lt_sqrt = torch.sqrt(state.Lt_history + 1e-10) + 1e-4
    lt_sqrt = torch.cat([lt_sqrt[1:2], lt_sqrt[1:]])
    return lt_sqrt / lt_sqrt.sum()


def sample_timesteps(state: TimestepSamplerState, batch: int, *,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[TimestepDraws] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, pt), each (B,): importance-sampled t once every timestep has more
    than 10 visits, uniform before. Both draws are made and one is selected on
    the device (no wait for the switch), as the JAX package does: t from
    argmax(log pt + Gumbel noise) (``jax.random.categorical``) or uniform."""
    hist = state.Lt_history
    T, dev = hist.shape[0], hist.device
    if draws is None:
        if generator is None:
            raise ValueError("sample_timesteps needs a generator or the draws")
        gumbel = dd.gumbel_from_uniform(torch.rand((batch, T), generator=generator, device=dev))
        uniform = torch.randint(0, T, (batch,), generator=generator, device=dev)
    else:
        gumbel, uniform = draws.gumbel.to(dev), draws.uniform.to(dev)
    use_importance = (state.Lt_count > 10).all()
    pt_all = timestep_probs(state)
    t_imp = (pt_all.log() + gumbel).argmax(dim=-1)
    t = torch.where(use_importance, t_imp, uniform.long())
    pt = torch.where(use_importance, pt_all[t_imp], torch.full((batch,), 1.0 / T, device=dev))
    return t, pt


def update_timestep_state(state: TimestepSamplerState, t: torch.Tensor,
                          kl_loss: torch.Tensor) -> TimestepSamplerState:
    """EMA(0.9) of the squared loss into ``Lt_history`` and one visit per
    sample into ``Lt_count``, at ``t``.

    Where a batch repeats a timestep, the count adds every copy, and the
    history takes the LAST copy in batch order: 0.1 kl[i]^2 + 0.9 history[t],
    i the last sample at t, the old history read by all. (The JAX package's
    ``.at[t].set`` leaves the copy to the backend; CUDA's ``index_put_`` does
    not fix it either.) The last copies are scattered alone, the others into
    a spare slot, so the result does not depend on the order of the writes."""
    T = state.Lt_history.shape[0]
    t = t.long()
    Lt2 = kl_loss.detach().float() ** 2
    new = 0.1 * Lt2 + 0.9 * state.Lt_history[t]
    i = torch.arange(t.shape[0], device=t.device)
    later_copy = ((t[None, :] == t[:, None]) & (i[None, :] > i[:, None])).any(dim=1)
    dest = torch.where(later_copy, T, t)
    hist = torch.cat([state.Lt_history, state.Lt_history.new_zeros(1)]).scatter(0, dest, new)[:T]
    count = state.Lt_count.index_add(0, t, torch.ones_like(Lt2))
    return TimestepSamplerState(hist, count)


@register(
    "text_to_sound_synthesis_tpu.models.diffusion.DiscreteDiffusion",
    "sound_synthesis.modeling.transformers.diffusion_transformer.DiffusionTransformer",
)
class DiscreteDiffusion(nn.Module):
    """Denoiser + schedule. As in the reference ``DiffusionTransformer``, the
    frozen condition embedding is a child (``condition_emb``) when
    ``condition_emb_config`` is given; the denoiser is ``transformer``."""

    def __init__(self, *, transformer_config: Optional[Mapping[str, Any]] = None,
                 condition_emb_config: Optional[Mapping[str, Any]] = None,
                 content_emb_config: Optional[Mapping[str, Any]] = None,
                 diffusion_step: int = 100, alpha_init_type: str = "alpha1",
                 auxiliary_loss_weight: float = 5.0e-4,
                 adaptive_auxiliary_loss: bool = True,
                 mask_weight: Tuple[float, float] = (1.0, 1.0),
                 schedule_kind: str = "mask_and_uniform"):
        super().__init__()
        if alpha_init_type != "alpha1":
            raise ValueError(f"unsupported alpha_init_type {alpha_init_type!r}")
        self.transformer_config = transformer_config
        self.content_emb_config = content_emb_config
        self.diffusion_step = diffusion_step
        self.schedule_kind = schedule_kind
        self.auxiliary_loss_weight = auxiliary_loss_weight
        self.adaptive_auxiliary_loss = adaptive_auxiliary_loss
        self.mask_weight = tuple(float(w) for w in mask_weight)
        self._schedules = {}   # built once per device: no host copy per training step
        tcfg = dict((transformer_config or {}).get("params", {}))
        tcfg.pop("checkpoint", None)       # as the JAX package: no config turns on the remat
        tcfg["content_emb_config"] = content_emb_config or tcfg.get("content_emb_config")
        tcfg["diffusion_step"] = diffusion_step  # owned by this module
        accepted = inspect.signature(Text2SpecTransformer).parameters
        self.transformer = Text2SpecTransformer(
            **{k: v for k, v in tcfg.items() if k in accepted})
        self.condition_emb = instantiate_from_config(condition_emb_config)

    def _emb_params(self) -> dict:
        cfg = self.content_emb_config or (self.transformer_config or {}).get(
            "params", {}).get("content_emb_config")
        return dict((cfg or {}).get("params", {}))

    @property
    def num_classes(self) -> int:
        return self.transformer.num_classes

    @property
    def content_seq_len(self) -> int:
        return int((self.transformer_config or {}).get("params", {}).get("content_seq_len", 265))

    def schedule(self, device=None) -> dd.DiffusionSchedule:
        key = (str(torch.device(device or "cpu")), self.diffusion_step, self.schedule_kind)
        if key not in self._schedules:
            self._schedules[key] = dd.make_schedule(self.diffusion_step, self.num_classes,
                                                    self.schedule_kind, device=device)
        return self._schedules[key]

    def ada_tables(self):
        """Hoistable AdaLN tables (see Text2SpecTransformer.ada_tables)."""
        return self.transformer.ada_tables()

    def cond_kvs(self, cond_emb):
        """Hoistable cross-attention K/V (see Text2SpecTransformer.cond_kvs)."""
        return self.transformer.cond_kvs(cond_emb)

    def backbone_logits(self, tokens, cond_emb, t, *, mods=None, cond_kvs=None):
        """Raw denoiser logits (B, L, K-1) — the sampler hook."""
        return self.transformer(tokens, cond_emb, t, mods=mods, cond_kvs=cond_kvs)

    def predict_start(self, tokens, cond_emb, t, *, mods=None, cond_kvs=None):
        """Token ids (B, L) -> log p(x0 | x_t) over K classes (B, L, K), f32:
        log_softmax over the K-1 real classes (the reference does it in f64,
        diffusion_transformer.py:285), the MASK column at -70, clamped to
        [-70, 0]."""
        return _log_pred(self.backbone_logits(tokens, cond_emb, t, mods=mods, cond_kvs=cond_kvs))

    def forward(self, tokens, cond_emb, t):
        """= ``predict_start``, as the JAX module's ``__call__``."""
        return self.predict_start(tokens, cond_emb, t)

    def train_loss(self, x0: torch.Tensor, cond_emb: torch.Tensor, t: torch.Tensor,
                   pt: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                   gumbel: Optional[torch.Tensor] = None, is_train: bool = True,
                   denoiser: Optional[nn.Module] = None) -> DiffusionLossOutput:
        """The vb_stochastic loss (diffusion_transformer.py:408-476), as the
        JAX package's ``train_loss``: q_sample -> predict_start -> the model's
        and the true posterior -> the mask-weighted KL (the decoder NLL at
        t = 0) / pt, plus, in training, the auxiliary x0 KL weighted
        (t/T + 1) * ``auxiliary_loss_weight`` (adaptive) / pt; loss =
        sum / (B * L).

        ``x0`` (B, L) token ids (in range: not checked, no wait), ``t`` and
        ``pt`` (B,) from ``sample_timesteps``. ``q_sample``'s Gumbel noise
        (B, L, K) comes from ``generator`` unless ``gumbel`` supplies it.
        ``denoiser`` runs the forward in place of ``self.transformer`` (the
        same module wrapped, e.g. by DDP). Dropout acts iff ``is_train``."""
        sched = self.schedule(x0.device)
        K = self.num_classes
        B, L = x0.shape
        log_x_start = dd.index_to_log_onehot(x0, K, check=False)
        log_xt = dd.q_sample(sched, generator, log_x_start, t, gumbel)
        xt = dd.log_onehot_to_index(log_xt)

        net = denoiser if denoiser is not None else self.transformer
        was_training = net.training
        net.train(is_train)
        try:
            log_x0_recon = _log_pred(net(xt, cond_emb, t))
        finally:
            net.train(was_training)
        log_model_prob = dd.q_posterior(sched, log_x0_recon, log_xt, t)
        log_true_prob = dd.q_posterior(sched, log_x_start, log_xt, t)

        kl = dd.multinomial_kl(log_true_prob, log_model_prob)               # (B, L)
        mask_region = (xt == K - 1).float()
        mw = mask_region * self.mask_weight[0] + (1.0 - mask_region) * self.mask_weight[1]
        kl = (kl * mw).sum(dim=-1)                                          # (B,)
        decoder_nll = -dd.log_categorical(log_x_start, log_model_prob).sum(dim=-1)

        is_t0 = (t == 0).float()
        kl_loss = is_t0 * decoder_nll + (1.0 - is_t0) * kl
        vb_loss = kl_loss / pt
        if self.auxiliary_loss_weight != 0 and is_train:
            kl_aux = dd.multinomial_kl(log_x_start[..., :-1], log_x0_recon[..., :-1])
            kl_aux = (kl_aux * mw).sum(dim=-1)
            kl_aux_loss = is_t0 * decoder_nll + (1.0 - is_t0) * kl_aux
            weight = (t.float() / self.diffusion_step + 1.0 if self.adaptive_auxiliary_loss
                      else 1.0)
            vb_loss = vb_loss + weight * self.auxiliary_loss_weight * kl_aux_loss / pt
        loss = vb_loss.sum() / (B * L)

        x0_recon = dd.log_onehot_to_index(log_x0_recon.detach())
        xtm1_recon = dd.log_onehot_to_index(log_model_prob.detach())
        acc_x0 = (x0_recon == x0).float().mean(dim=-1)
        acc_keep = (xtm1_recon == xt).float().mean(dim=-1)
        return DiffusionLossOutput(loss, kl_loss, t, acc_x0, acc_keep, log_model_prob)


def _log_pred(logits: torch.Tensor) -> torch.Tensor:
    """Denoiser logits (B, L, K-1) -> log p(x0 | x_t) (B, L, K), f32: the
    log_softmax over the real classes, the MASK column at -70, clipped to
    [-70, 0]."""
    log_pred = torch.log_softmax(logits.float(), dim=-1)
    log_pred = torch.cat([log_pred, torch.full_like(log_pred[..., :1], dd.MIN_LOGP)], dim=-1)
    return dd.clip(log_pred, dd.MIN_LOGP, 0.0)


def _timestep_plan(num_timesteps: int, start_step: int, skip_step: int
                   ) -> Tuple[List[int], List[int]]:
    """(ts, t_post) step lists.

    Full sampling: ts = [start-1 .. 0], posterior at ts. Fast sampling
    (diffusion_transformer.py:748-812): stride 1+skip with a final forced 0;
    the posterior jumps to t - skip while t > skip, else t.
    """
    if skip_step == 0:
        ts = list(range(start_step - 1, -1, -1))
        return ts, list(ts)
    ts = list(range(start_step - 1, -1, -(1 + skip_step)))
    if ts[-1] != 0:
        ts.append(0)
    return ts, [t - skip_step if t > skip_step else t for t in ts]


class OneHotDraws(NamedTuple):
    """Every random draw of ``sample_tokens``, supplied in place of the
    generator's (``n_steps`` = the steps of the timestep plan)."""

    gumbel: torch.Tensor                     # (n_steps, B, L, K): each step's p_sample
    coin: Optional[torch.Tensor] = None      # (n_steps,) uniforms: the q-resample's coin
    gumbel2: Optional[torch.Tensor] = None   # (n_steps, B, L, K): the resample's p_sample
    # the start: (B, L) token ids for ``uniform_start``, or (B, L, K) Gumbel
    # noise of the q_sample of ``content_tokens`` when ``filter_ratio`` > 0
    start: Optional[torch.Tensor] = None


@torch.no_grad()
def sample_tokens(
    model: DiscreteDiffusion,
    cond_emb: torch.Tensor,             # (B, S, Dc)
    *,
    generator: Optional[torch.Generator] = None,
    content_tokens: Optional[torch.Tensor] = None,
    filter_ratio: float = 0.0,
    skip_step: int = 0,
    filter_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    resample_q: float = 0.0,
    return_logits: bool = False,
    uniform_start: bool = False,
    draws: Optional[OneHotDraws] = None,
):
    """The one-hot reverse sampler (the JAX package's ``sample_tokens``);
    returns (B, L) int32 tokens, and with ``return_logits`` also the final
    state's probabilities (B, L, K).

    ``filter_ratio`` > 0 starts from a q_sample corruption of
    ``content_tokens`` at t = filter_ratio*T - 1 (the reference ``sample``'s
    partial mode, diffusion_transformer.py:643-651); 0 starts from all-MASK,
    or with ``uniform_start`` from uniformly random tokens (the reference's
    ``sample_uniform_only``, diffusion_transformer.py:661-744, the x_T of a
    ``uniform_only`` schedule), whose randint upper bound K-2 (exclusive,
    ``:704``: the last real class is never drawn) is kept as it is.
    ``filter_fn`` truncates log p(x0|x_t) each step (e.g.
    ``partial(truncate_top_r, r=0.85)``). ``resample_q`` > 0 re-applies the
    step to its own output with probability q (the reference's ``q<rate>``
    wrapper, dalle_spec.py:135-143). Draws come from ``generator`` (on the
    device of ``cond_emb``) unless ``draws`` supplies them all.
    """
    device = cond_emb.device
    sched = model.schedule(device)
    K = model.num_classes
    T = model.diffusion_step
    L = model.content_seq_len
    B = cond_emb.shape[0]
    if draws is None and generator is None:
        raise ValueError("sample_tokens needs a generator or the draws")

    start_step = int(T * filter_ratio)
    if draws is not None and draws.start is None and (uniform_start or start_step > 0):
        raise ValueError("this start needs draws.start")
    if start_step == 0:
        if uniform_start:
            x_init = (draws.start if draws is not None else
                      torch.randint(0, K - 2, (B, L), generator=generator, device=device))
            log_z = dd.index_to_log_onehot(x_init.to(device), K)
        else:
            log_z = torch.full((B, L, K), -torch.inf, device=device)   # all-MASK
            log_z[..., -1] = 0.0
        plan_start = T
    else:
        if content_tokens is None:
            raise ValueError("filter_ratio > 0 requires content_tokens")
        t0 = torch.full((B,), start_step - 1, dtype=torch.long, device=device)
        log_z = dd.q_sample(sched, generator, dd.index_to_log_onehot(content_tokens, K), t0,
                            gumbel=None if draws is None else draws.start)
        plan_start = start_step

    ts, t_post = _timestep_plan(T, plan_start, skip_step)
    coins = None
    if draws is not None:
        want = (len(ts), B, L, K)
        if tuple(draws.gumbel.shape) != want:
            raise ValueError(f"draws.gumbel has shape {tuple(draws.gumbel.shape)}, expected {want}")
        if resample_q > 0.0:
            if draws.coin is None or draws.gumbel2 is None:
                raise ValueError("resample_q > 0 needs draws.coin and draws.gumbel2")
            coins = draws.coin.tolist()
    elif resample_q > 0.0:   # one host read for all the coins, not one a step
        coins = torch.rand((len(ts),), generator=generator, device=device).tolist()

    def noise(i: int, resample: bool) -> torch.Tensor:
        if draws is not None:
            return (draws.gumbel2 if resample else draws.gumbel)[i]
        return dd.gumbel_from_uniform(torch.rand((B, L, K), generator=generator, device=device))

    def p_sample(log_z, t, tp, gumbel):
        t_vec = torch.full((B,), t, dtype=torch.long, device=device)
        log_x_recon = model.predict_start(dd.log_onehot_to_index(log_z), cond_emb, t_vec)
        if filter_fn is not None:
            log_x_recon = filter_fn(log_x_recon)
        tp_vec = torch.full((B,), tp, dtype=torch.long, device=device)
        log_model_prob = dd.q_posterior(sched, log_x_recon, log_z, tp_vec)
        return dd.log_sample_categorical(None, log_model_prob, gumbel)

    for i, (t, tp) in enumerate(zip(ts, t_post)):
        log_z = p_sample(log_z, t, tp, noise(i, False))
        if coins is not None and coins[i] < resample_q:
            log_z = p_sample(log_z, t, tp, noise(i, True))
    tokens = dd.log_onehot_to_index(log_z)
    if return_logits:
        return tokens, torch.exp(log_z)
    return tokens


@torch.no_grad()
def sample_tokens_fused(
    model: DiscreteDiffusion,
    cond_emb: torch.Tensor,             # (B, S, Dc)
    *,
    generator: torch.Generator,
    truncation_r: float = 0.0,
    skip_step: int = 0,
    content_tokens: Optional[torch.Tensor] = None,
    filter_ratio: float = 0.0,
    noise: Optional[torch.Tensor] = None,  # (n_steps, B, L, K) Gumbel noise in place of draws
) -> torch.Tensor:
    """Index-carrying reverse sampler; returns (B, L) int32 tokens.

    ``filter_ratio`` > 0 starts from a q_sample corruption of
    ``content_tokens`` at t = filter_ratio*T - 1; 0 starts from all-MASK.
    The request's ``seed_base`` is drawn from ``generator``; step ``idx`` of
    the kernel is keyed on ``(seed_base, idx)``, as the JAX package keys its
    TPU kernel on ``seed_base + idx`` mixed with the block id.
    """
    device = cond_emb.device
    sched = model.schedule(device)
    K = model.num_classes
    T = model.diffusion_step
    L = model.content_seq_len
    B = cond_emb.shape[0]

    start_step = int(T * filter_ratio)
    if start_step == 0:
        tokens = torch.full((B, L), K - 1, dtype=torch.int32, device=device)  # all-MASK
        plan_start = T
    else:
        if content_tokens is None:
            raise ValueError("filter_ratio > 0 requires content_tokens")
        t0 = torch.full((B,), start_step - 1, dtype=torch.long, device=device)
        log_z = dd.q_sample(sched, generator, dd.index_to_log_onehot(content_tokens, K), t0)
        tokens = dd.log_onehot_to_index(log_z)
        plan_start = start_step

    ts, t_post = _timestep_plan(T, plan_start, skip_step)
    if noise is not None and tuple(noise.shape) != (len(ts), B, L, K):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {(len(ts), B, L, K)}")
    coeffs = fs.step_coeffs(sched, t_post).as_array().contiguous()  # (n_steps, 10)
    # on the device: the kernels read it there, no host sync
    seed_base = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                              device=generator.device).to(device, torch.int32)

    tables = model.ada_tables()
    kvs = model.cond_kvs(cond_emb)
    for idx, t in enumerate(ts):
        t_vec = torch.full((B,), t, dtype=torch.long, device=device)
        mods = [(tab1[t:t + 1], tab2[t:t + 1]) for tab1, tab2 in tables]
        logits = model.backbone_logits(tokens, cond_emb, t_vec, mods=mods, cond_kvs=kvs)
        tokens = fs.fused_p_sample(logits, tokens, coeffs[idx], seed_base, idx,
                                   truncation_r=truncation_r,
                                   gumbel=None if noise is None else noise[idx])
    return tokens


def sample_tokens_fused_sharded(
    model: DiscreteDiffusion,
    cond_emb: torch.Tensor,             # (B, S, Dc); B a multiple of the shard count
    *,
    seed: int,
    devices: Optional[Sequence] = None,
    group=None,
    truncation_r: float = 0.0,
    skip_step: int = 0,
) -> torch.Tensor:
    """Data-parallel ``sample_tokens_fused``: each shard runs the whole
    sampler on its slice of the batch, with a generator seeded
    ``fold_seed(seed, i)`` for shard i (the JAX package folds the device's
    index into its key). The shards are ``devices`` in this process (a device
    may repeat; the model is copied to each other device once), or the ranks
    of ``group``, each holding the model on its own card, with the tokens
    gathered at the end (``parallel.run_sharded``). The result equals running
    ``sample_tokens_fused`` per shard with the folded seed, bit for bit."""
    replicas: dict = {}

    def shard(cond: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return sample_tokens_fused(replica(model, cond.device, replicas), cond,
                                   generator=generator, truncation_r=truncation_r,
                                   skip_step=skip_step)

    return run_sharded(shard, cond_emb, seed=seed, devices=devices, group=group)
