"""Diffsound's text encoder and denoiser, plain float32.

``clip_text``: CLIP ViT-B/32's text transformer (Radford et al. 2021): token
and position embeddings, 12 pre-LN blocks of causal 8-head attention and a
QuickGELU MLP, ``ln_final``, each token's feature L2-normalised (Diffsound
keeps all 77 per-token features). ``denoiser``: VQ-Diffusion's
``Text2ImageTransformer`` over the 5 x 53 token grid: token + row + column
embeddings, then per layer AdaLN(t) -> self-attention -> AdaLN(t) ->
cross-attention to the text features -> LN -> 4x GELU2 MLP, and
``head_logits``: LN -> Linear to the 256 codes (MASK is never predicted).

``Quant`` simulates the int8 serving engine's arithmetic in float32: weights
symmetric per output channel on a ``wbits`` grid, activations at the six
sites of a layer on an ``abits`` grid, per row (dynamic) or per tensor from
calibrated maxima (static).
"""

import math
from typing import Optional

import torch

from . import layer_norm

TEXT = "transformer.condition_emb."
DEN = "transformer.transformer."


def _softmax_attend(q, k, v, n_head: int, mask=None):
    B, L, D = q.shape
    hd = D // n_head

    def heads(a):
        return a.reshape(a.shape[0], a.shape[1], n_head, hd).transpose(1, 2)

    att = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        att = att + mask
    y = torch.softmax(att, dim=-1) @ heads(v)
    return y.transpose(1, 2).reshape(B, L, D)


def clip_text(w, ids, *, layers: int = 12, heads: int = 8):
    """(B, 77) BPE ids -> (B, 77, 512) L2-normalised features."""
    ids = ids.long().clamp(min=0)
    L = ids.shape[1]
    x = w[TEXT + "token_embedding.weight"][ids] + w[TEXT + "positional_embedding"][:L]
    causal = torch.full((L, L), float("-inf"), device=x.device).triu(1)
    for i in range(layers):
        p = f"{TEXT}transformer.resblocks.{i}."
        h = layer_norm(x, w[p + "ln_1.weight"], w[p + "ln_1.bias"])
        q, k, v = (h @ w[p + "attn.in_proj_weight"].T + w[p + "attn.in_proj_bias"]).chunk(3, -1)
        y = _softmax_attend(q, k, v, heads, causal)
        x = x + y @ w[p + "attn.out_proj.weight"].T + w[p + "attn.out_proj.bias"]
        h = layer_norm(x, w[p + "ln_2.weight"], w[p + "ln_2.bias"])
        h = h @ w[p + "mlp.c_fc.weight"].T + w[p + "mlp.c_fc.bias"]
        h = h * torch.sigmoid(1.702 * h)
        x = x + h @ w[p + "mlp.c_proj.weight"].T + w[p + "mlp.c_proj.bias"]
    x = layer_norm(x, w[TEXT + "ln_final.weight"], w[TEXT + "ln_final.bias"])
    return x / x.norm(dim=-1, keepdim=True)


class Quant:
    """The int8 engine's arithmetic, simulated: ``wbits``-bit weights per output
    channel, ``abits``-bit activations at the six sites of each layer (attn_in,
    attn_out, cross_in, cross_out, mlp_in, mlp_mid). ``amax`` (n_layer, 6)
    gives static per-tensor scales amax / 127 (on an A4 grid: amax / 7);
    without it each row takes its own. ``record`` collects the sites' maxima
    (calibration)."""

    def __init__(self, n_layer: int, *, wbits: int = 4, abits: int = 8,
                 amax: Optional[torch.Tensor] = None, record: bool = False):
        self.wmax = 2 ** (wbits - 1) - 1
        self.amax_q = 2 ** (abits - 1) - 1
        self.amax = amax
        self.seen = None
        if record:
            self.seen = torch.zeros(n_layer, 6)
        self._w = {}

    def weight(self, name: str, W):
        if name not in self._w:
            s = W.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / self.wmax
            self._w[name] = torch.round(W / s).clamp(-self.wmax, self.wmax) * s
        return self._w[name]

    def act(self, h, layer: int, site: int):
        m = h.abs().amax()
        if self.seen is not None:
            self.seen = self.seen.to(h.device)
            self.seen[layer, site] = torch.maximum(self.seen[layer, site], m)
        if self.amax is None:
            s = h.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / self.amax_q
        else:
            s = self.amax[layer, site].to(h.device).clamp_min(1e-6) / self.amax_q
        return torch.round(h / s).clamp(-self.amax_q, self.amax_q) * s


def _ada(w, p, t):
    e = w[p + "emb.weight"][t.long()]
    m = torch.nn.functional.silu(e) @ w[p + "linear.weight"].T + w[p + "linear.bias"]
    return m[:, None, :].chunk(2, dim=-1)            # scale, shift: (B, 1, D) each


def denoiser(w, tokens, t, cond, *, n_layer: int, n_head: int, H: int, W: int,
             quant: Optional[Quant] = None):
    """Hidden states before the head, (B, L, D): token ids (B, L) in the
    time-major order, (B,) timesteps, (B, S, 512) text features."""
    p0 = DEN + "content_emb."
    L = tokens.shape[1]
    pos = (w[p0 + "height_emb.weight"][:, None, :] + w[p0 + "width_emb.weight"][None, :, :])
    x = w[p0 + "emb.weight"][tokens.long().clamp(min=0)] + pos.reshape(H * W, -1)[:L]

    def act(h, i, site):
        return h if quant is None else quant.act(h, i, site)

    def dense(h, name):
        Wt = w[name + ".weight"]
        if quant is not None:
            Wt = quant.weight(name, Wt)
        return h @ Wt.T + w[name + ".bias"]

    for i in range(n_layer):
        p = f"{DEN}blocks.{i}."
        scale, shift = _ada(w, p + "ln1.", t)
        h = act(layer_norm(x) * (1 + scale) + shift, i, 0)
        q, k, v = (dense(h, p + f"attn1.{n}") for n in ("query", "key", "value"))
        x = x + dense(act(_softmax_attend(q, k, v, n_head), i, 1), p + "attn1.proj")
        scale, shift = _ada(w, p + "ln1_1.", t)
        h = act(layer_norm(x) * (1 + scale) + shift, i, 2)
        q = dense(h, p + "attn2.query")
        k = cond @ w[p + "attn2.key.weight"].T + w[p + "attn2.key.bias"]
        v = cond @ w[p + "attn2.value.weight"].T + w[p + "attn2.value.bias"]
        x = x + dense(act(_softmax_attend(q, k, v, n_head), i, 3), p + "attn2.proj")
        h = act(layer_norm(x, w[p + "ln2.weight"], w[p + "ln2.bias"]), i, 4)
        u = dense(h, p + "mlp.0")
        u = act(u * torch.sigmoid(1.702 * u), i, 5)
        x = x + dense(u, p + "mlp.2")
    return x


def head_logits(w, x):
    """Hidden states (B, L, D) -> logits (B, L, K - 1)."""
    h = layer_norm(x, w[DEN + "to_logits.0.weight"], w[DEN + "to_logits.0.bias"])
    return h @ w[DEN + "to_logits.1.weight"].T + w[DEN + "to_logits.1.bias"]
