"""Denoising transformer backbone: AdaLN(t) self+cross blocks (PyTorch port).

Port of the ``selfcross`` denoiser of
``text_to_sound_synthesis_tpu/models/diffusion/backbone.py`` (reference
``Text2ImageTransformer``, transformer_utils.py): 19 layers x (AdaLN ->
self-attn over 265 content tokens -> AdaLN -> cross-attn to 77 CLIP token
embeddings -> LN -> 4x GELU2 MLP), final LN + Linear to ``num_embed`` classes
(MASK is never predicted).

Parameter names are the reference's (``content_emb``, ``blocks.N.ln1.emb``,
``blocks.N.attn1.query``, ``blocks.N.mlp.0``, ``to_logits.0/1``). Activations
are (B, L, D); attention is plain matmuls with the softmax in float32.
LayerNorm eps is 1e-6, as in the JAX package. Dropout (``attn_pdrop``,
``resid_pdrop``; 0 in every config) sits where the JAX package and the
reference put it and acts only in training mode: ``build_model`` returns the
model in eval mode, and ``DiscreteDiffusion.train_loss`` sets the mode to its
``is_train`` for its forward, as the JAX package passes ``deterministic``.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
from torch import nn

from ...utils.config import register
from ...utils.dtype import check_compute_dtype
from .embeddings import ContentEmbedding

__all__ = ["Text2SpecTransformer", "SelfCrossBlock", "AdaLayerNorm", "MultiHeadAttention",
           "SinusoidalTimeEmb", "gelu2"]

LN_EPS = 1e-6


def gelu2(x):
    """x * sigmoid(1.702 x) (transformer_utils.py:111-115)."""
    return x * torch.sigmoid(1.702 * x)


class GELU2(nn.Module):
    def forward(self, x):
        return gelu2(x)


class _GELUTanh(nn.Module):
    """flax ``nn.gelu`` (tanh approximation), the JAX package's 'GELU'."""

    def forward(self, x):
        return nn.functional.gelu(x, approximate="tanh")


_ACT = {"GELU": _GELUTanh, "GELU2": GELU2}


class SinusoidalTimeEmb(nn.Module):
    """Sinusoidal timestep embedding, t / num_steps * 4000 (transformer_utils.py:117-132)."""

    def __init__(self, num_steps: int, dim: int, rescale_steps: float = 4000.0):
        super().__init__()
        self.num_steps, self.dim, self.rescale_steps = num_steps, dim, rescale_steps

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        x = t.float() / self.num_steps * self.rescale_steps
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                          * -(math.log(10000.0) / (half - 1)))
        ang = x[:, None] * freqs[None, :]
        return torch.cat([ang.sin(), ang.cos()], dim=-1)


class AdaLayerNorm(nn.Module):
    """LayerNorm (no affine) modulated by scale/shift from the timestep.
    ``emb_type`` containing 'abs' selects the sinusoidal embedding, otherwise
    a learned ``Embedding(diffusion_step, n_embd)`` table (the production
    configs)."""

    def __init__(self, n_embd: int, diffusion_step: int, emb_type: str = "adalayernorm"):
        super().__init__()
        self.diffusion_step = diffusion_step
        if "abs" in emb_type:
            self.emb = SinusoidalTimeEmb(diffusion_step, n_embd)
        else:
            self.emb = nn.Embedding(diffusion_step, n_embd)
        self.linear = nn.Linear(n_embd, 2 * n_embd)
        self.layernorm = nn.LayerNorm(n_embd, eps=LN_EPS, elementwise_affine=False)

    def modulation(self, t: torch.Tensor) -> torch.Tensor:
        """(B,) timesteps -> (B, 2*n_embd) scale|shift."""
        e = self.emb(t).to(self.linear.weight.dtype)
        return self.linear(nn.functional.silu(e))

    def table(self) -> torch.Tensor:
        """All-timestep modulation table (T, 2*n_embd), hoisted out of the sampler loop."""
        return self.modulation(torch.arange(self.diffusion_step, device=self.linear.weight.device))

    def forward(self, x, t, mod: Optional[torch.Tensor] = None):
        if mod is None:
            mod = self.modulation(t)
        scale, shift = mod[:, None, :].to(x.dtype).chunk(2, dim=-1)
        return self.layernorm(x) * (1 + scale) + shift


class MultiHeadAttention(nn.Module):
    """q from x; k, v from ``kv`` (self-attention when kv is x). Full softmax,
    no mask: the content sequence is bidirectional."""

    def __init__(self, n_embd: int, n_head: int, kv_dim: Optional[int] = None,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(kv_dim or n_embd, n_embd)
        self.value = nn.Linear(kv_dim or n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)
        self.attn_drop = nn.Dropout(attn_pdrop)
        self.resid_drop = nn.Dropout(resid_pdrop)

    def kv_proj(self, kv):
        """Keys/values (B, S, H, hd), projected once for a fixed condition."""
        B, S, _ = kv.shape
        return (self.key(kv).reshape(B, S, self.n_head, -1),
                self.value(kv).reshape(B, S, self.n_head, -1))

    def forward(self, x, kv, *, kv_cache=None):
        B, L, D = x.shape
        hd = D // self.n_head
        q = self.query(x).reshape(B, L, self.n_head, hd).transpose(1, 2)
        k, v = kv_cache if kv_cache is not None else self.kv_proj(kv)
        att = (q @ k.permute(0, 2, 3, 1)) / math.sqrt(hd)
        att = self.attn_drop(torch.softmax(att.float(), dim=-1).to(x.dtype))
        y = (att @ v.transpose(1, 2)).transpose(1, 2).reshape(B, L, D)
        return self.resid_drop(self.proj(y))


class SelfCrossBlock(nn.Module):
    """AdaLN->self-attn, AdaLN->cross-attn, LN->MLP (Block, transformer_utils.py:168-272)."""

    def __init__(self, n_embd: int, n_head: int, diffusion_step: int,
                 condition_dim: int = 512, mlp_hidden_times: int = 4,
                 activate: str = "GELU2", timestep_type: str = "adalayernorm",
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0):
        super().__init__()
        self.ln1 = AdaLayerNorm(n_embd, diffusion_step, timestep_type)
        self.ln1_1 = AdaLayerNorm(n_embd, diffusion_step, timestep_type)
        self.attn1 = MultiHeadAttention(n_embd, n_head, None, attn_pdrop, resid_pdrop)
        self.attn2 = MultiHeadAttention(n_embd, n_head, condition_dim, attn_pdrop, resid_pdrop)
        self.ln2 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.mlp = nn.Sequential(
            nn.Linear(n_embd, mlp_hidden_times * n_embd),
            _ACT[activate](),
            nn.Linear(mlp_hidden_times * n_embd, n_embd),
            nn.Dropout(resid_pdrop),
        )

    def ada_tables(self):
        """(T, 2D) modulation tables for both AdaLNs."""
        return self.ln1.table(), self.ln1_1.table()

    def cond_kv(self, cond):
        """Step-invariant cross-attention K/V projections of the condition."""
        return self.attn2.kv_proj(cond)

    def forward(self, x, cond, t, *, mods=None, cond_kv=None):
        m1, m2 = mods if mods is not None else (None, None)
        h = self.ln1(x, t, mod=m1)
        x = x + self.attn1(h, h)
        h = self.ln1_1(x, t, mod=m2)
        x = x + self.attn2(h, cond, kv_cache=cond_kv)
        return x + self.mlp(self.ln2(x))


@register(
    "text_to_sound_synthesis_tpu.models.diffusion.Text2SpecTransformer",
    "sound_synthesis.modeling.transformers.transformer_utils.Text2ImageTransformer",
)
class Text2SpecTransformer(nn.Module):
    """Full denoiser: token ids + CLIP cond + t -> logits (B, L, num_embed)."""

    def __init__(self, n_layer: int = 19, n_embd: int = 1024, n_head: int = 16,
                 content_seq_len: int = 265, condition_seq_len: int = 77,
                 condition_dim: int = 512, diffusion_step: int = 100,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0,
                 mlp_hidden_times: int = 4, block_activate: str = "GELU2",
                 attn_type: str = "selfcross", timestep_type: str = "adalayernorm",
                 mlp_type: str = "fc", content_spatial_size: Any = (5, 53),
                 content_emb_config: Optional[Mapping[str, Any]] = None,
                 checkpoint: bool = False):
        super().__init__()
        if attn_type != "selfcross":
            raise NotImplementedError("only the selfcross denoiser is ported")
        emb_params = dict((content_emb_config or {}).get("params", {}))
        emb_params.setdefault("spatial_size", tuple(content_spatial_size))
        self.content_emb = ContentEmbedding(**emb_params)
        self.blocks = nn.ModuleList(
            SelfCrossBlock(n_embd, n_head, diffusion_step, condition_dim,
                           mlp_hidden_times, block_activate, timestep_type,
                           attn_pdrop, resid_pdrop)
            for _ in range(n_layer))
        self.to_logits = nn.Sequential(
            nn.LayerNorm(n_embd, eps=LN_EPS),
            nn.Linear(n_embd, self.content_emb.num_classes - 1),
        )

    @property
    def num_classes(self) -> int:
        return self.content_emb.num_classes

    def ada_tables(self):
        """Per-block ((T, 2D), (T, 2D)) AdaLN modulation tables."""
        return [blk.ada_tables() for blk in self.blocks]

    def cond_kvs(self, cond_emb: torch.Tensor):
        """Per-block precomputed cross-attention (k, v) of a fixed condition."""
        cond = cond_emb.to(self.to_logits[1].weight.dtype)
        return [blk.cond_kv(cond) for blk in self.blocks]

    def forward(self, tokens: torch.Tensor, cond_emb: torch.Tensor, t: torch.Tensor,
                *, mods=None, cond_kvs=None) -> torch.Tensor:
        """tokens (B, L) int; cond_emb (B, S, condition_dim); t (B,) int.
        Returns logits (B, L, num_classes - 1), classes last. ``mods`` /
        ``cond_kvs``: optional per-block precomputed AdaLN modulations and
        cross-attention projections (see ada_tables / cond_kvs)."""
        check_compute_dtype(self, self.to_logits[1].weight)
        x = self.content_emb(tokens)
        cond = cond_emb.to(x.dtype)
        for i, blk in enumerate(self.blocks):
            x = blk(x, cond, t,
                    mods=mods[i] if mods is not None else None,
                    cond_kv=cond_kvs[i] if cond_kvs is not None else None)
        return self.to_logits(x)
