"""Plain multi-head attention over the flat (B*L, D) layout (PyTorch port).

Port of ``mha_reference`` from ``text_to_sound_synthesis_tpu/ops/attention.py``:
the attention the int8 block twins use. The TPU kernel ``fused_mha`` (K7) is
not ported yet.
"""

from __future__ import annotations

import math

import torch

__all__ = ["mha_reference"]


def mha_reference(q, k, v, *, batch: int, n_head: int, kv_valid: int):
    """q (B*Lq, D), k/v (B*Lkv, D) -> (B*Lq, D) in q's dtype. Scores from the
    inputs' values in f32, keys at or beyond ``kv_valid`` masked, f32 softmax,
    probabilities rounded to q's dtype, then P V with an f32 sum."""
    M, D = q.shape
    hd = D // n_head
    Lq, Lkv = M // batch, k.shape[0] // batch
    qh = q.reshape(batch, Lq, n_head, hd).transpose(1, 2).float()
    kh = k.reshape(batch, Lkv, n_head, hd).transpose(1, 2).float()
    vh = v.reshape(batch, Lkv, n_head, hd).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    s = s.masked_fill(torch.arange(Lkv, device=q.device) >= kv_valid, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = (p.float() @ vh.float()).to(q.dtype)
    return o.transpose(1, 2).reshape(M, D)
