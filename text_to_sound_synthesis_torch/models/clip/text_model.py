"""CLIP ViT-B/32 text tower — the frozen condition encoder (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/clip/text_model.py``: pre-LN
blocks with causal masking, QuickGELU MLPs, learned positional embeddings,
``ln_final``; and the ``CLIPTextEmbedding`` wrapper (clamp negative pad ids to
0, per-token output, optional L2 normalization, optional width doubling to
1024, optional EOT projection).

Parameter names and layouts are the reference's (``token_embedding``,
``positional_embedding``, ``transformer.resblocks.N.attn.in_proj_weight``,
``ln_final``, ``text_projection``), so a released CLIP or Diffsound
``condition_emb`` state dict loads with ``load_state_dict``. LayerNorm eps is
1e-6, as in the JAX package (flax's default).
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
from torch import nn

from ...utils.config import register
from ...utils.dtype import check_compute_dtype

__all__ = ["ClipTextEncoder", "CLIPTextEmbedding", "quick_gelu"]

LN_EPS = 1e-6


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


class _SelfAttention(nn.Module):
    """Multi-head self-attention with ``nn.MultiheadAttention``'s parameter
    names (packed ``in_proj``), computed with plain matmuls."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask):
        B, L, D = x.shape
        hd = D // self.heads
        qkv = nn.functional.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        att = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        att = torch.softmax(att.float() + mask, dim=-1).to(x.dtype)
        y = (att @ v).transpose(1, 2).reshape(B, L, D)
        return self.out_proj(y)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = _SelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("gelu", QuickGELU()),
            ("c_proj", nn.Linear(4 * width, width)),
        ]))

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(width, heads) for _ in range(layers))

    def forward(self, x, mask):
        for blk in self.resblocks:
            x = blk(x, mask)
        return x


class ClipTextEncoder(nn.Module):
    """tokens (B, L) -> per-token features after ln_final (B, L, width)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, embed_dim: int = 512,
                 with_projection: bool = False):
        super().__init__()
        self.context_length = context_length
        self.width = width
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, layers, heads)
        self.ln_final = nn.LayerNorm(width, eps=LN_EPS)
        if with_projection:
            self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(tokens)
        L = x.shape[1]
        x = x + self.positional_embedding[:L].to(x.dtype)
        causal = torch.full((L, L), float("-inf"), device=x.device).triu(1)
        return self.ln_final(self.transformer(x, causal))

    def project_eot(self, tokens: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
        """Take the EOT position (argmax token id) through text_projection."""
        eot = tokens.argmax(dim=-1)
        picked = features[torch.arange(features.shape[0], device=features.device), eot]
        return picked @ self.text_projection.to(picked.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.encode(tokens)


@register(
    "text_to_sound_synthesis_tpu.models.clip.CLIPTextEmbedding",
    "sound_synthesis.modeling.embeddings.clip_text_embedding.CLIPTextEmbedding",
)
class CLIPTextEmbedding(ClipTextEncoder):
    """Frozen condition embedding. Diffsound config (caps.yaml:69-78):
    normalize=True, pick_last_embedding=False, embed_dim=512 -> L2-normalized
    per-token (B, 77, 512) features. The tower's parameters sit at the top
    level, as in the reference wrapper."""

    def __init__(self, clip_name: str = "ViT-B/32", num_embed: int = 49408,
                 normalize: bool = True, pick_last_embedding: bool = False,
                 keep_seq_len_dim: bool = False, additional_last_embedding: bool = False,
                 embed_dim: int = 512, width: int = 512, layers: int = 12, heads: int = 8,
                 context_length: int = 77):
        # text_projection keeps the checkpoint's output dim (width) when
        # embed_dim == 1024: that setting only switches on the self-concat
        super().__init__(
            vocab_size=num_embed, context_length=context_length, width=width,
            layers=layers, heads=heads,
            embed_dim=width if embed_dim == 1024 else embed_dim,
            with_projection=pick_last_embedding or additional_last_embedding,
        )
        self.normalize = normalize
        self.pick_last_embedding = pick_last_embedding
        self.keep_seq_len_dim = keep_seq_len_dim
        self.additional_last_embedding = additional_last_embedding
        self.embed_dim = embed_dim

    def forward(self, tokens: torch.Tensor):
        check_compute_dtype(self, self.token_embedding.weight)
        tokens = tokens.clamp(min=0)  # negative pad ids -> 0
        feats = self.encode(tokens)
        if self.pick_last_embedding:
            out = self.project_eot(tokens, feats)
            if self.keep_seq_len_dim:
                out = out[:, None, :]
        else:
            out = feats
        if self.embed_dim == 1024:
            out = torch.cat([out, out], dim=-1)
        if self.normalize:
            out = out / out.norm(dim=-1, keepdim=True)
        if self.additional_last_embedding:
            last = self.project_eot(tokens, feats)
            if self.keep_seq_len_dim:
                last = last[:, None, :]
            return out, last
        return out
