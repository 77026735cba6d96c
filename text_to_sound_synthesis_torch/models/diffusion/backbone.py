"""Denoising transformer backbones: AdaLN(t) blocks (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/diffusion/backbone.py``: the
``selfcross`` denoiser (reference ``Text2ImageTransformer``,
transformer_utils.py): 19 layers x (AdaLN -> self-attn over 265 content tokens
-> AdaLN -> cross-attn to 77 CLIP token embeddings -> LN -> 4x GELU2 MLP),
final LN + Linear to ``num_embed`` classes (MASK is never predicted); and the
class-conditional and unconditional denoisers (``Condition2ImageTransformer``,
``UnCondition2ImageTransformer``: ``selfcondition`` / ``self`` blocks),
standalone modules that no sampler builds, as in the JAX package.

Parameter names are the reference's (``content_emb``, ``blocks.N.ln1.emb``,
``blocks.N.attn1.query``, ``blocks.N.mlp.0``, ``to_logits.0/1``). Activations
are (B, L, D); attention is plain matmuls with the softmax in float32.
LayerNorm eps is 1e-6, as in the JAX package. Dropout (``attn_pdrop``,
``resid_pdrop``; 0 in every config) sits where the JAX package and the
reference put it and acts only in training mode: ``build_model`` returns the
model in eval mode, and ``DiscreteDiffusion.train_loss`` sets the mode to its
``is_train`` for its forward, as the JAX package passes ``deterministic``.

``Text2SpecTransformer(checkpoint=True)`` recomputes each block in the
backward pass, as JAX's ``nn.remat`` does (``backbone.py:390``): under
autograd each ``SelfCrossBlock`` runs inside
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which keeps only
the block's inputs and replays the dropout's random state in the recompute,
so the loss and gradients are the plain pass's. The recompute reads the
weights the forward read (in a compute dtype, the copies
``compute_weights`` lent it). Outside a gradient pass the blocks run
plainly. No config reaches the flag: ``DiscreteDiffusion`` drops it, as the
JAX package does.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint as _recompute

from ...utils.config import register
from ...utils.dtype import check_compute_dtype
from .embeddings import ContentEmbedding

__all__ = ["Text2SpecTransformer", "Condition2SpecTransformer", "UnCondition2SpecTransformer",
           "SelfCrossBlock", "SelfConditionBlock", "SelfBlock", "AdaLayerNorm",
           "MultiHeadAttention", "SinusoidalTimeEmb", "gelu2"]

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
        # ``diffusion_step`` rows of the table: the class count when the
        # modulation is keyed on a class id (``SelfConditionBlock.ln2``)
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


def _mlp(n_embd: int, mlp_hidden_times: int, activate: str, resid_pdrop: float):
    return nn.Sequential(
        nn.Linear(n_embd, mlp_hidden_times * n_embd),
        _ACT[activate](),
        nn.Linear(mlp_hidden_times * n_embd, n_embd),
        nn.Dropout(resid_pdrop),
    )


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
        self.mlp = _mlp(n_embd, mlp_hidden_times, activate, resid_pdrop)

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


class SelfConditionBlock(nn.Module):
    """'selfcondition' block: AdaLN(t) -> self-attn, then an AdaLN keyed on
    the class id (over ``class_number`` rows) -> MLP (transformer_utils.py:207-219,
    261-265)."""

    def __init__(self, n_embd: int, n_head: int, diffusion_step: int,
                 class_number: int = 1000, mlp_hidden_times: int = 4,
                 activate: str = "GELU2", timestep_type: str = "adalayernorm",
                 class_type: str = "adalayernorm", attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0):
        super().__init__()
        self.ln1 = AdaLayerNorm(n_embd, diffusion_step, timestep_type)
        self.attn = MultiHeadAttention(n_embd, n_head, None, attn_pdrop, resid_pdrop)
        self.ln2 = AdaLayerNorm(n_embd, class_number, class_type)
        self.mlp = _mlp(n_embd, mlp_hidden_times, activate, resid_pdrop)

    def forward(self, x, class_idx, t):
        h = self.ln1(x, t)
        x = x + self.attn(h, h)
        return x + self.mlp(self.ln2(x, class_idx))


class SelfBlock(nn.Module):
    """'self' block: AdaLN(t) -> self-attn -> LN -> MLP (unconditional)."""

    def __init__(self, n_embd: int, n_head: int, diffusion_step: int,
                 mlp_hidden_times: int = 4, activate: str = "GELU2",
                 timestep_type: str = "adalayernorm", attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0):
        super().__init__()
        self.ln1 = AdaLayerNorm(n_embd, diffusion_step, timestep_type)
        self.attn = MultiHeadAttention(n_embd, n_head, None, attn_pdrop, resid_pdrop)
        self.ln2 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.mlp = _mlp(n_embd, mlp_hidden_times, activate, resid_pdrop)

    def forward(self, x, t):
        h = self.ln1(x, t)
        x = x + self.attn(h, h)
        return x + self.mlp(self.ln2(x))


class _GridDenoiser(nn.Module):
    """Content embedding -> blocks -> LN + Linear to ``num_embed`` classes."""

    def __init__(self, blocks, n_embd: int, content_spatial_size,
                 content_emb_config: Optional[Mapping[str, Any]]):
        super().__init__()
        emb_params = dict((content_emb_config or {}).get("params", {}))
        emb_params.setdefault("spatial_size", tuple(content_spatial_size))
        self.content_emb = ContentEmbedding(**emb_params)
        self.blocks = nn.ModuleList(blocks)
        self.to_logits = nn.Sequential(
            nn.LayerNorm(n_embd, eps=LN_EPS),
            nn.Linear(n_embd, self.content_emb.num_classes - 1),
        )

    @property
    def num_classes(self) -> int:
        return self.content_emb.num_classes


@register(
    "text_to_sound_synthesis_tpu.models.diffusion.Condition2SpecTransformer",
    "sound_synthesis.modeling.transformers.transformer_utils.Condition2ImageTransformer",
)
class Condition2SpecTransformer(_GridDenoiser):
    """Class-conditional denoiser (Condition2ImageTransformer,
    transformer_utils.py:445-585): tokens + class id + t -> logits."""

    def __init__(self, class_number: int = 1000, n_layer: int = 24, n_embd: int = 1024,
                 n_head: int = 16, content_seq_len: int = 265, diffusion_step: int = 100,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0, mlp_hidden_times: int = 4,
                 block_activate: str = "GELU2", attn_type: str = "selfcondition",
                 class_type: str = "adalayernorm", timestep_type: str = "adalayernorm",
                 mlp_type: str = "fc", content_spatial_size: Any = (5, 53),
                 content_emb_config: Optional[Mapping[str, Any]] = None):
        super().__init__(
            (SelfConditionBlock(n_embd, n_head, diffusion_step, class_number, mlp_hidden_times,
                                block_activate, timestep_type, class_type, attn_pdrop,
                                resid_pdrop) for _ in range(n_layer)),
            n_embd, content_spatial_size, content_emb_config)

    def forward(self, tokens: torch.Tensor, class_idx: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        """tokens (B, L) int; class ids (B,) or (B, 1); t (B,) int ->
        logits (B, L, num_classes - 1)."""
        x = self.content_emb(tokens)
        class_idx = class_idx.reshape(-1)
        for blk in self.blocks:
            x = blk(x, class_idx, t)
        return self.to_logits(x)


@register(
    "text_to_sound_synthesis_tpu.models.diffusion.UnCondition2SpecTransformer",
    "sound_synthesis.modeling.transformers.transformer_utils.UnCondition2ImageTransformer",
)
class UnCondition2SpecTransformer(_GridDenoiser):
    """Unconditional denoiser (UnCondition2ImageTransformer,
    transformer_utils.py:588-725)."""

    def __init__(self, n_layer: int = 24, n_embd: int = 512, n_head: int = 16,
                 content_seq_len: int = 256, diffusion_step: int = 100,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0, mlp_hidden_times: int = 4,
                 block_activate: str = "GELU2", attn_type: str = "self",
                 timestep_type: str = "adalayernorm", mlp_type: str = "fc",
                 content_spatial_size: Any = (16, 16),
                 content_emb_config: Optional[Mapping[str, Any]] = None):
        super().__init__(
            (SelfBlock(n_embd, n_head, diffusion_step, mlp_hidden_times, block_activate,
                       timestep_type, attn_pdrop, resid_pdrop) for _ in range(n_layer)),
            n_embd, content_spatial_size, content_emb_config)

    def forward(self, tokens: torch.Tensor, cond: Any, t: torch.Tensor) -> torch.Tensor:
        """``cond`` accepted and ignored (unconditional)."""
        x = self.content_emb(tokens)
        for blk in self.blocks:
            x = blk(x, t)
        return self.to_logits(x)


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
        self.checkpoint = checkpoint

    @property
    def num_classes(self) -> int:
        return self.content_emb.num_classes

    def ada_tables(self):
        """Per-block ((T, 2D), (T, 2D)) AdaLN modulation tables."""
        return [blk.ada_tables() for blk in self.blocks]

    @staticmethod
    def _block_recomputed(blk: SelfCrossBlock, x, cond, t, **kw):
        """``blk`` under activation checkpointing, on the tensors it reads now
        (``compute_weights`` restores the f32 weights before the backward)."""
        tensors = {**dict(blk.named_parameters()), **dict(blk.named_buffers())}
        return _recompute(lambda *a: torch.func.functional_call(blk, tensors, a, kw),
                          x, cond, t, use_reentrant=False)

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
        run = (self._block_recomputed if self.checkpoint and torch.is_grad_enabled()
               else lambda blk, *a, **kw: blk(*a, **kw))
        for i, blk in enumerate(self.blocks):
            x = run(blk, x, cond, t,
                    mods=mods[i] if mods is not None else None,
                    cond_kv=cond_kvs[i] if cond_kvs is not None else None)
        return self.to_logits(x)
