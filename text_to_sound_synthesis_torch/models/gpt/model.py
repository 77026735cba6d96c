"""Autoregressive GPT baseline with a KV-cached sampler (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/gpt/model.py`` (reference
minGPT, ``Codebook/specvqgan/modules/transformer/mingpt.py``: ``GPT:126-187``,
``CausalSelfAttention:49-95``, ``GPTFeats:263-293``, ``GPTClass:295-305``,
``GPTFeatsClass:306-349``): learned positional embeddings over block_size
(266 = 1 cond + 5*53 content, zeros at init), pre-LN blocks with exact-GELU
MLPs, a bias-free head, conditioning prepended after a Conv1d / Linear /
Identity / LSTM / GRU feature embedder or a class-token table.

Parameter names are minGPT's (``tok_emb``, ``pos_emb``, ``blocks.N.ln1``,
``blocks.N.attn.{key,query,value,proj}``, ``blocks.N.mlp.0/2``, ``ln_f``,
``head``; the conditioned variants subclass ``GPT`` and add ``embedder`` or
``feat_embedder`` / ``cls_embedder``), so a reference state dict loads as it
is. Attention is plain matmuls with the softmax in f32. LayerNorm eps is
1e-6, and the dropout rates are accepted and not applied, as in the JAX
package (0 in every config).

Sampling (``ar_sample``) prefills the conditioning in one pass, then runs one
cached decode a token: each layer's cache is preallocated (B, block_size, H,
hd) and written in place at ``pos``, so its shapes stay static, as JAX's
``dynamic_update_slice`` keeps them.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, List, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ...ops.sampling import top_k_multinomial
from ...utils.config import register

__all__ = ["GPT", "GPTFeats", "GPTClass", "GPTFeatsClass", "RNNEmbedder", "LayerCache",
           "ar_sample"]

LN_EPS = 1e-6
Pos = Union[int, torch.Tensor]


class LayerCache(NamedTuple):
    k: torch.Tensor  # (B, maxT, H, hd)
    v: torch.Tensor


class CausalSelfAttention(nn.Module):
    def __init__(self, n_embd: int, n_head: int, n_unmasked: int = 0,
                 attn_pdrop: float = 0.0, resid_pdrop: float = 0.0):
        super().__init__()
        self.n_head, self.n_unmasked = n_head, n_unmasked
        self.key = nn.Linear(n_embd, n_embd)
        self.query = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)

    def _split(self, x):
        B, T, C = x.shape
        return x.reshape(B, T, self.n_head, C // self.n_head)

    def _attend(self, q, k, v, valid):
        """q (B, Tq, H, hd), k / v (B, Tk, H, hd), valid (Tq, Tk) -> (B, Tq, C)."""
        B, Tq, H, hd = q.shape
        att = q.transpose(1, 2) @ k.permute(0, 2, 3, 1) / math.sqrt(hd)
        att = att.masked_fill(~valid, -torch.inf)
        att = torch.softmax(att.float(), dim=-1).to(q.dtype)
        return (att @ v.transpose(1, 2)).transpose(1, 2).reshape(B, Tq, H * hd)

    def _mask(self, T: int, device) -> torch.Tensor:
        """The training mask: causal, plus minGPT's unmasked [:n, :n] prefix."""
        mask = torch.ones((T, T), dtype=torch.bool, device=device).tril()
        if self.n_unmasked > 0:
            mask[: self.n_unmasked, : self.n_unmasked] = True
        return mask

    def forward(self, x):
        q, k, v = self._split(self.query(x)), self._split(self.key(x)), self._split(self.value(x))
        return self.proj(self._attend(q, k, v, self._mask(x.shape[1], x.device)))

    def decode_step(self, x, cache: LayerCache, pos: Pos) -> Tuple[torch.Tensor, LayerCache]:
        """x (B, 1, C) at position ``pos``; its key and value are written into
        the cache in place; attends to positions <= pos."""
        q = self._split(self.query(x))
        cache.k[:, pos] = self._split(self.key(x))[:, 0]
        cache.v[:, pos] = self._split(self.value(x))[:, 0]
        valid = torch.arange(cache.k.shape[1], device=x.device)[None, :] <= pos
        return self.proj(self._attend(q, cache.k, cache.v, valid)), cache

    def prefill(self, x, cache: LayerCache) -> Tuple[torch.Tensor, LayerCache]:
        """Positions [0, T) in one pass with the training mask, their keys and
        values written into the cache. Sequential ``decode_step`` cannot
        reproduce the unmasked prefix (a prefix query attends to prefix keys
        not yet cached), so cached sampling prefills the conditioning."""
        T = x.shape[1]
        q, k, v = self._split(self.query(x)), self._split(self.key(x)), self._split(self.value(x))
        cache.k[:, :T] = k
        cache.v[:, :T] = v
        return self.proj(self._attend(q, k, v, self._mask(T, x.device))), cache


class GPTBlock(nn.Module):
    def __init__(self, n_embd: int, n_head: int, n_unmasked: int = 0,
                 resid_pdrop: float = 0.0, attn_pdrop: float = 0.0):
        super().__init__()
        self.ln1 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.attn = CausalSelfAttention(n_embd, n_head, n_unmasked, attn_pdrop, resid_pdrop)
        self.mlp = nn.Sequential(nn.Linear(n_embd, 4 * n_embd), nn.GELU(),
                                 nn.Linear(4 * n_embd, n_embd))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))

    def decode_step(self, x, cache: LayerCache, pos: Pos):
        a, cache = self.attn.decode_step(self.ln1(x), cache, pos)
        x = x + a
        return x + self.mlp(self.ln2(x)), cache

    def prefill(self, x, cache: LayerCache):
        a, cache = self.attn.prefill(self.ln1(x), cache)
        x = x + a
        return x + self.mlp(self.ln2(x)), cache


@register(
    "text_to_sound_synthesis_tpu.models.gpt.GPT",
    "specvqgan.modules.transformer.mingpt.GPT",
)
class GPT(nn.Module):
    ZERO_INIT = ("pos_emb",)

    def __init__(self, vocab_size: int = 256, block_size: int = 266, n_layer: int = 19,
                 n_head: int = 16, n_embd: int = 1024, embd_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, attn_pdrop: float = 0.0, n_unmasked: int = 0):
        super().__init__()
        self.vocab_size, self.block_size = vocab_size, block_size
        self.n_layer, self.n_head, self.n_embd = n_layer, n_head, n_embd
        self.tok_emb = nn.Embedding(vocab_size, n_embd)
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        self.blocks = nn.ModuleList(GPTBlock(n_embd, n_head, n_unmasked, resid_pdrop, attn_pdrop)
                                    for _ in range(n_layer))
        self.ln_f = nn.LayerNorm(n_embd, eps=LN_EPS)
        self.head = nn.Linear(n_embd, vocab_size, bias=False)

    def forward(self, idx: torch.Tensor, embeddings: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) token ids (+ optional prepended conditioning embeddings
        (B, Tc, D)) -> logits (B, Tc + T, vocab)."""
        x = self.tok_emb(idx)
        if embeddings is not None:
            x = torch.cat([embeddings.to(x.dtype), x], dim=1)
        x = x + self.pos_emb[:, : x.shape[1]].to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_f(x))

    # -- cached decoding -----------------------------------------------------

    def init_cache(self, batch: int, max_len: Optional[int] = None) -> List[LayerCache]:
        """One zeroed (B, max_len, H, hd) key and value buffer per layer, in
        the weights' dtype, on their device."""
        w = self.head.weight
        shape = (batch, max_len or self.block_size, self.n_head, self.n_embd // self.n_head)
        return [LayerCache(w.new_zeros(shape), w.new_zeros(shape)) for _ in range(self.n_layer)]

    def decode_embedded(self, x_emb: torch.Tensor, cache: List[LayerCache], pos: Pos):
        """One step from an input embedding (B, 1, D) at position ``pos`` ->
        (logits (B, vocab), cache)."""
        x = x_emb + self.pos_emb[:, pos][:, None].to(x_emb.dtype)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk.decode_step(x, c, pos)
            new_cache.append(c)
        return self.head(self.ln_f(x))[:, 0], new_cache

    def decode_token(self, token: torch.Tensor, cache: List[LayerCache], pos: Pos):
        """One step from token ids (B,) at position ``pos``."""
        return self.decode_embedded(self.tok_emb(token)[:, None], cache, pos)

    def decode_prefix(self, x_emb: torch.Tensor, cache: List[LayerCache]):
        """The conditioning prefix (B, Tc, D) in one pass with the training
        mask -> (logits at position Tc - 1, cache)."""
        x = x_emb + self.pos_emb[:, : x_emb.shape[1]].to(x_emb.dtype)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = blk.prefill(x, c)
            new_cache.append(c)
        return self.head(self.ln_f(x))[:, -1], new_cache

    def embed_tokens(self, idx: torch.Tensor) -> torch.Tensor:
        return self.tok_emb(idx)


class _LSTMEmbedder(nn.LSTM):
    def forward(self, x):
        return super().forward(x)[0]


class _GRUEmbedder(nn.GRU):
    def forward(self, x):
        return super().forward(x)[0]


def RNNEmbedder(input_size: int, hidden_size: int, num_layers: int = 1,
                kind: str = "lstm") -> nn.Module:
    """Recurrent feature embedder (the reference's ``torch.nn.LSTM`` / ``GRU``
    from ``feat_embedding_config``, mingpt.py:266-282): a ``batch_first``
    LSTM or GRU that maps (B, T, D) to its full hidden sequence (B, T, H),
    ``feats, _ = self.embedder(feats)``. Its state dict is torch's."""
    cls = {"lstm": _LSTMEmbedder, "gru": _GRUEmbedder}[kind]
    return cls(input_size, hidden_size, num_layers, batch_first=True)


class _Conv1dEmbedder(nn.Conv1d):
    def forward(self, x):
        """(B, T, D) -> (B, T, out_channels)."""
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def _build_feat_embedder(cfg: Optional[Mapping[str, Any]], n_embd: int) -> nn.Module:
    """The reference's ``instantiate_from_config(feat_embedding_config)`` over
    torch.nn.{Conv1d, Linear, Identity, LSTM, GRU}; every embedder maps
    (B, T, D) features, time first, to (B, T, n_embd) (the Conv1d through
    ``_Conv1dEmbedder``)."""
    ecfg = dict(cfg or {})
    target = str(ecfg.get("target", "torch.nn.Conv1d"))
    p = dict(ecfg.get("params") or {})
    if target.endswith(("LSTM", "GRU")):
        return RNNEmbedder(p["input_size"], p.get("hidden_size", n_embd), p.get("num_layers", 1),
                           "lstm" if target.endswith("LSTM") else "gru")
    if target.endswith("Conv1d"):
        return _Conv1dEmbedder(p["in_channels"], p.get("out_channels", n_embd),
                               p.get("kernel_size", 1), padding=p.get("padding", 0))
    if target.endswith("Identity"):
        # a true pass-through (features already n_embd wide)
        return nn.Identity()
    if target.endswith("Linear"):
        return nn.Linear(p["in_features"], p.get("out_features", n_embd))
    raise NotImplementedError(f"embedder {target!r}")


def _gpt_kwargs(gcfg: Optional[Mapping[str, Any]]) -> dict:
    """``GPT_config``'s entries that ``GPT`` takes (the JAX package's filter)."""
    names = inspect.signature(GPT).parameters
    return {k: v for k, v in dict(gcfg or {}).items() if k in names}


def _class_table(cfg: Optional[Mapping[str, Any]], n_embd: int) -> nn.Embedding:
    p = dict((cfg or {}).get("params") or {})
    return nn.Embedding(p.get("num_embeddings", p.get("n_classes", 1000)),
                        p.get("features", p.get("embedding_dim", n_embd)))


def _class_ids(cls_idx: torch.Tensor) -> torch.Tensor:
    """(B,) or (B, 1) class ids -> (B, 1) long."""
    cls_idx = cls_idx.long()
    return cls_idx[:, None] if cls_idx.dim() == 1 else cls_idx


@register(
    "text_to_sound_synthesis_tpu.models.gpt.GPTFeats",
    "specvqgan.modules.transformer.mingpt.GPTFeats",
)
class GPTFeats(GPT):
    """GPT conditioned on prepended features (CLIP text vectors), (B, D, T)
    channel-major, through ``feat_embedding_config``'s embedder."""

    def __init__(self, feat_embedding_config: Optional[Mapping[str, Any]] = None,
                 GPT_config: Optional[Mapping[str, Any]] = None):
        super().__init__(**_gpt_kwargs(GPT_config))
        self.embedder = _build_feat_embedder(feat_embedding_config, self.n_embd)

    def embed_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, D, T) -> (B, T, n_embd)."""
        return self.embedder(feats.transpose(1, 2))

    def forward(self, idx, feats):
        return super().forward(idx, embeddings=self.embed_feats(feats))


@register(
    "text_to_sound_synthesis_tpu.models.gpt.GPTClass",
    "specvqgan.modules.transformer.mingpt.GPTClass",
)
class GPTClass(GPT):
    """GPT conditioned on a prepended class-token embedding (mingpt.py:295-305)."""

    def __init__(self, token_embedding_config: Optional[Mapping[str, Any]] = None,
                 GPT_config: Optional[Mapping[str, Any]] = None):
        super().__init__(**_gpt_kwargs(GPT_config))
        self.embedder = _class_table(token_embedding_config, self.n_embd)

    def embed_feats(self, cls_idx: torch.Tensor) -> torch.Tensor:
        """(B,) or (B, 1) class ids -> (B, 1, n_embd)."""
        return self.embedder(_class_ids(cls_idx))

    def forward(self, idx, cls_idx):
        return super().forward(idx, embeddings=self.embed_feats(cls_idx))


@register(
    "text_to_sound_synthesis_tpu.models.gpt.GPTFeatsClass",
    "specvqgan.modules.transformer.mingpt.GPTFeatsClass",
)
class GPTFeatsClass(GPT):
    """GPT conditioned on prepended features and a class token
    (mingpt.py:306-349): the prefix is ``cat([embed(feats), embed(class)])``."""

    def __init__(self, feat_embedding_config: Optional[Mapping[str, Any]] = None,
                 token_embedding_config: Optional[Mapping[str, Any]] = None,
                 GPT_config: Optional[Mapping[str, Any]] = None):
        super().__init__(**_gpt_kwargs(GPT_config))
        self.feat_embedder = _build_feat_embedder(feat_embedding_config, self.n_embd)
        self.cls_embedder = _class_table(token_embedding_config, self.n_embd)

    def embed_feats(self, feats_token) -> torch.Tensor:
        """``{'feature': (B, D, T), 'target': (B,) or (B, 1) class ids}`` (the
        ``FeatsClassStage`` layout) or a (feats, ids) tuple -> (B, T + 1, n_embd)."""
        if isinstance(feats_token, (tuple, list)):
            feats, cls_idx = feats_token
        else:
            feats, cls_idx = feats_token["feature"], feats_token["target"]
        feat_emb = self.feat_embedder(feats.transpose(1, 2))
        cls_emb = self.cls_embedder(_class_ids(cls_idx))
        return torch.cat([feat_emb, cls_emb.to(feat_emb.dtype)], dim=1)

    def forward(self, idx, feats_token):
        return super().forward(idx, embeddings=self.embed_feats(feats_token))


@torch.no_grad()
def ar_sample(model: GPT, cond, *, steps: int, top_k: int = 100, temperature: float = 1.0,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """KV-cached autoregressive sampling -> (B, steps) token ids.

    ``cond``: (B, D, Tc) features for ``GPTFeats``, (B,) / (B, 1) ids for
    ``GPTClass``, ``{'feature', 'target'}`` for ``GPTFeatsClass``. The
    conditioning is prefilled in one pass (the training mask, minGPT's
    unmasked prefix included), then each token is one cached decode, drawn by
    ``ops.sampling.top_k_multinomial`` from ``generator`` (on the model's
    device). Replaces the reference's per-token full forwards
    (``generate_samples_caps.py:162-229``); its random stream is not JAX's."""
    cond_emb = model.embed_feats(cond)
    B, Tc = cond_emb.shape[:2]
    cache = model.init_cache(B)
    logits, cache = model.decode_prefix(cond_emb, cache)
    tokens = [top_k_multinomial(generator, logits, top_k, temperature)]
    for t in range(steps - 1):
        logits, cache = model.decode_token(tokens[-1], cache, Tc + t)
        tokens.append(top_k_multinomial(generator, logits, top_k, temperature))
    return torch.stack(tokens, dim=1)
