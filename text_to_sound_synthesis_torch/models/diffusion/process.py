"""DiscreteDiffusion and the index-carrying reverse sampler (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/diffusion/process.py``: the
denoiser plus its schedule (``DiscreteDiffusion``), the timestep plan of the
full and the strided (``fast<k>``) sampler, and ``sample_tokens_fused``, whose
per-step work outside the transformer is the fused sampler kernel
(``ops/fused_sampler.py``).

The step loop is a Python loop (the JAX package's ``lax.scan``). As there,
the AdaLN tables and the cross-attention K/V are computed once before it, and
all steps' coefficients sit in one ``(n_steps, 10)`` device tensor, so the
loop makes no host round trip. The training loss waits for the training port.
"""

from __future__ import annotations

import inspect
from typing import Any, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ...ops import diffusion as dd
from ...ops import fused_sampler as fs
from ...utils.config import instantiate_from_config, register
from .backbone import Text2SpecTransformer

__all__ = ["DiscreteDiffusion", "sample_tokens_fused"]


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
        tcfg = dict((transformer_config or {}).get("params", {}))
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
        return dd.make_schedule(self.diffusion_step, self.num_classes, self.schedule_kind,
                                device=device)

    def ada_tables(self):
        """Hoistable AdaLN tables (see Text2SpecTransformer.ada_tables)."""
        return self.transformer.ada_tables()

    def cond_kvs(self, cond_emb):
        """Hoistable cross-attention K/V (see Text2SpecTransformer.cond_kvs)."""
        return self.transformer.cond_kvs(cond_emb)

    def backbone_logits(self, tokens, cond_emb, t, *, mods=None, cond_kvs=None):
        """Raw denoiser logits (B, L, K-1) — the sampler hook."""
        return self.transformer(tokens, cond_emb, t, mods=mods, cond_kvs=cond_kvs)


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
