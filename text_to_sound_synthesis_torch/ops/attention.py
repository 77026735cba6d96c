"""Multi-head attention over the flat (B*L, D) layout (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/ops/attention.py``: ``mha_reference``,
the plain attention that the int8 twins use, and K7 ``fused_mha``, the
attention of the engine's per-dense path. ``fused_mha`` launches the
attention kernel of ``csrc/int8_block.cu`` on its own for a CUDA tensor (the
blocks K4, K5 and K8 launch the same kernel inside their own schedules and do
not count here) and runs ``mha_reference`` for a CPU one; it counts its calls
in ``.launches``. The TPU's ``interpret`` option is not carried over.
"""

from __future__ import annotations

import math

import torch

from . import int8_kernels as ik

__all__ = ["fused_mha", "mha_reference"]


def mha_reference(q, k, v, *, batch: int, n_head: int, kv_valid: int, fold_div: bool = False):
    """q (B*Lq, D), k/v (B*Lkv, D) -> (B*Lq, D) in q's dtype. Scores from the
    inputs' values in f32, keys at or beyond ``kv_valid`` masked, f32 softmax,
    probabilities rounded to q's dtype, then P V with an f32 sum.

    ``fold_div`` is the JAX engine's ``T2S_SOFTMAX_FOLD_DIV=1``
    (``int8_block.py::_mha_inline``): the unnormalised ``exp(s - max)`` is
    rounded to q's dtype, and the f32 P V output is divided by the f32 row
    sum before its own rounding."""
    M, D = q.shape
    hd = D // n_head
    Lq, Lkv = M // batch, k.shape[0] // batch
    qh = q.reshape(batch, Lq, n_head, hd).transpose(1, 2).float()
    kh = k.reshape(batch, Lkv, n_head, hd).transpose(1, 2).float()
    vh = v.reshape(batch, Lkv, n_head, hd).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    s = s.masked_fill(torch.arange(Lkv, device=q.device) >= kv_valid, float("-inf"))
    if fold_div:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        o = (e.to(q.dtype).float() @ vh.float()) / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = p.float() @ vh.float()
    return o.to(q.dtype).transpose(1, 2).reshape(M, D)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, batch: int, n_head: int,
              kv_valid: int) -> torch.Tensor:
    """K7: q (B*Lq, D), k/v (B*Lkv, D) bf16 -> (B*Lq, D) bf16, keys at or
    beyond ``kv_valid`` masked; what ``mha_reference`` computes. On the card:
    one block per (batch, head), head width 32 or 64, at most 272 keys."""
    if not ik.on_cuda(q, "fused_mha"):
        return mha_reference(q, k, v, batch=batch, n_head=n_head, kv_valid=kv_valid)
    lib = ik.load_kernel()
    ik.check_mha(q, k, v, batch, n_head, kv_valid, lib.t2s_int8_limits(3))
    out = ik.mha(lib, q, k, v, batch, n_head, kv_valid)
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
