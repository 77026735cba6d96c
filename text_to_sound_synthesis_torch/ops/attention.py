"""Multi-head attention over the flat (B*L, D) layout (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/ops/attention.py``: ``mha_reference``,
the plain attention that the int8 twins use, and K7 ``fused_mha``, the
attention of the engine's per-dense path. ``fused_mha`` launches the
Hopper attention kernel (``csrc/mha_sm90.cuh``, built into
``csrc/int8_block.cu``) on its own for a CUDA tensor (the blocks K4, K5 and
K8 launch the same kernel inside their own schedules and do not count here) and runs ``mha_reference`` for a CPU one; it counts its calls
in ``.launches``. The TPU's ``interpret`` option is not carried over.

Beside it, ``mha_pair``, the pair-packed MHA that the JAX engine's blocks run
by default at a head width of 64 (``int8_block.py::_mha_pair_premasked`` /
``_mha_pair``), the launch inside the blocks' ``attn="pair"``: the same
kernel's pair mode on a CUDA tensor (counted in ``.launches``), its plain twin
``mha_pair_reference`` on a CPU one.
"""

from __future__ import annotations

import math

import torch

from . import int8_kernels as ik

__all__ = ["fused_mha", "mha_reference", "mha_pair", "mha_pair_reference", "check_pair"]


def _heads(t, batch: int, n_head: int):
    """(B*L, D) -> (B, H, L, hd)."""
    return t.reshape(batch, -1, n_head, t.shape[1] // n_head).transpose(1, 2)


def _merge(o, dtype):
    """(B, H, L, hd) -> (B*L, D) in ``dtype``."""
    B, H, L, hd = o.shape
    return o.to(dtype).transpose(1, 2).reshape(B * L, H * hd)


def check_pair(n_head: int, width: int) -> None:
    """The pair-packed MHA takes two heads per 128 columns: an even number of
    heads of width 64 (JAX ``int8_block.py::_pair_ok``)."""
    if n_head % 2 or width != 64 * n_head:
        raise ValueError(f"the pair-packed MHA takes an even number of heads of width 64; got "
                         f"{n_head} heads of {width / n_head:g}")


def mha_pair_reference(q, k, v, *, batch: int, n_head: int, kv_valid: int, fold: bool = True):
    """The pair-packed MHA: q (B*Lq, D), k/v (B*Lkv, D) -> (B*Lq, D) in q's
    dtype. Scores from the inputs' values in f32 times 1/sqrt(hd), keys at or
    beyond ``kv_valid`` masked. Heads 2g (A) and 2g + 1 (B) share one row
    max, over both heads' scores; p = exp(s - max) in f32; sum_A over A's
    keys and sum_B = (the sum over both heads) - sum_A, as JAX takes them.
    ``fold``: p rounded to q's dtype unnormalised, P V summed in f32 and
    divided by the head's sum; else (T3 ``pair_nofold``) p divided by the
    head's sum before its rounding, no divide after. The TPU kernels fold
    their lane masks into the K/V dequant (x1.0, x0.0), which is exact, so
    each head here reads its own columns."""
    check_pair(n_head, q.shape[1])
    hd = q.shape[1] // n_head
    Lkv = k.shape[0] // batch
    qh, kh = _heads(q, batch, n_head).float(), _heads(k, batch, n_head).float()
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(torch.arange(Lkv, device=q.device) >= kv_valid, float("-inf"))
    B, H, Lq, _ = s.shape
    s = s.reshape(B, H // 2, 2, Lq, Lkv)
    m = s.amax(dim=(2, 4), keepdim=True)
    p = torch.exp(s - m)
    sum_a = p[:, :, 0].sum(dim=-1)                                   # (B, H/2, Lq)
    total = p.transpose(2, 3).reshape(B, H // 2, Lq, 2 * Lkv).sum(dim=-1)
    den = torch.stack([sum_a, total - sum_a], dim=2)[..., None]      # (B, H/2, 2, Lq, 1)
    vh = _heads(v, batch, n_head).float().reshape(B, H // 2, 2, Lkv, hd)
    if fold:
        o = (p.to(q.dtype).float() @ vh) / den
    else:
        o = (p / den).to(q.dtype).float() @ vh
    return _merge(o.reshape(B, H, Lq, hd), q.dtype)


def mha_pair(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, batch: int, n_head: int,
             kv_valid: int) -> torch.Tensor:
    """The pair-packed MHA: q (B*Lq, D), k/v (B*Lkv, D) bf16 -> (B*Lq, D)
    bf16, what ``mha_pair_reference`` computes (``fold``). On the card:
    ``csrc/mha_sm90.cuh``'s ``mha_pair_kernel``, one warpgroup per 64 queries
    of a (pair of heads, batch), an even number of heads of 64, at most 272
    keys."""
    if not ik.on_cuda(q, "mha_pair"):
        return mha_pair_reference(q, k, v, batch=batch, n_head=n_head, kv_valid=kv_valid)
    lib = ik.load_kernel()
    ik.check_mha(q, k, v, batch, n_head, kv_valid, lib.t2s_int8_limits(3))
    check_pair(n_head, q.shape[1])
    return launch_pair(lib, q, k, v, batch, n_head, kv_valid)


def launch_pair(lib, q, k, v, batch: int, n_head: int, kv_valid: int) -> torch.Tensor:
    """``mha_pair``'s launch on tensors the caller has checked (the blocks'
    ``attn="pair"`` too), counted in ``mha_pair.launches``."""
    out = ik.mha(lib, q, k, v, batch, n_head, kv_valid, mode="pair")
    mha_pair.launches += 1
    return out


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
    ``csrc/mha_sm90.cuh``, one warpgroup per 64 queries of a (batch, head),
    head width 32 or 64, at most 272 keys."""
    if not ik.on_cuda(q, "fused_mha"):
        return mha_reference(q, k, v, batch=batch, n_head=n_head, kv_valid=kv_valid)
    lib = ik.load_kernel()
    ik.check_mha(q, k, v, batch, n_head, kv_valid, lib.t2s_int8_limits(3))
    out = ik.mha(lib, q, k, v, batch, n_head, kv_valid)
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
mha_pair.launches = 0
