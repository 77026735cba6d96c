"""Int8 transformer sub-blocks of the serving engine (K3, K4, K5, K8, K9) and
their int8 attention (K10).

Port of ``text_to_sound_synthesis_tpu/ops/int8_block.py``: one function per
sub-block of a denoiser layer (``SelfCrossBlock``), each

  self_attn_block:   AdaLN -> quantize -> q/k/v int8 dots -> MHA -> quantize
                     -> proj int8 dot -> + residual
  cross_attn_block:  AdaLN -> quantize -> q int8 dot -> MHA against the
                     precomputed condition K/V -> quantize -> proj -> + residual
  attn_pair_block:   self_attn_block then cross_attn_block, with x kept in f32
                     between the two (W8 only)
  mlp_block:         LN -> quantize -> fc1 int8 dot -> GELU2 -> quantize ->
                     fc2 int8 dot -> + residual
  mlp_block_chunked, mlp_block_streamed: mlp_block with the hidden dimension
                     in ``n_chunks`` chunks, each quantized with its own row
                     scale (W8 only; the two differ only in ``n_chunks``)

Quantization is per-row dynamic (row abs-max), or static per-tensor when
``static_s`` gives the calibrated (in, out/mid) scales. ``w4=True`` takes
nibble-packed int4 weights (``quantize_weight_w4``).

The attention blocks take ``attn``, which MHA they run (the JAX engine picks
it with ``T2S_ATTN_INT8`` and ``T2S_SOFTMAX_FOLD_DIV``; the blocks never
read the environment):

  "bf16"       ``mha_reference``: bf16 P = bf16(exp(s - max) / sum), f32 P V;
  "bf16_fold"  ``mha_reference(fold_div=True)``: bf16 exp(s - max), the f32
               P V output divided by the row sum;
  "int8"       K10 ``mha_inline_int8``: q and k quantized per row over the
               whole width, V per column over the keys of each batch element,
               P per (head, query) row after the f32 softmax; int8 Q K^T and
               P V with exact integer sums;
  "pair"       ``mha_pair_reference``, the pair-packed MHA the JAX engine
               serves at a head width of 64 (``T2S_ATTN_MHA=pair``, its
               default there): one row max shared by heads 2g and 2g + 1, p
               rounded unnormalised, the divide after P V. An even number of
               heads of width 64, else ValueError.

The ``*_reference`` functions are the plain PyTorch versions and define what
the kernels compute (the JAX package's ``*_reference`` twins; W4 goes through
``unpack_weight_w4``, so W4 is bitwise the unpacked W8 path). The wrappers
launch the hand-written CUDA kernels of ``csrc/int8_block.cu`` (K10:
``csrc/mha_int8.cu``) for CUDA tensors and run the plain version only for
CPU tensors; each counts its kernel runs in ``.launches`` (K10 counts every
int8 MHA, inside a block or called alone, ``attention.mha_pair`` every pair
MHA; the quantize passes
``quantize_rows`` and ``quantize_wide`` (``quant.py``) each of their
launches: two per attention half, one per dynamic K3 or K9 call).

On the card an attention half (K4, K5, each half of K8) is five launches
(``_attn_half``): the quantize pass (AdaLN, the TPU kernel's ``_prologue``
and ``_quant``) -> the q (and k, v) dots in the Hopper GEMM's int8 A mode ->
the MHA -> the quantize pass -> the proj dot + residual. The MLP blocks
are fc1 on the LN panel -> [under a dynamic scale: the wide quantize pass,
each chunk of the middle with its own row scale] -> fc2 in the int8 A mode
(K9: the chunked epilogue) (``_mlp``). The same schedules
run on CPU tensors from the plain pieces, and equal the twins bit for bit.
The TPU schedule options (``rows_per_program``, ``block_m``,
``pipeline_halves``, row padding) are not carried over: the Hopper kernels
choose their own tiling and take any sequence length up to their limit (the
TPU's padded one too, its pad keys masked by ``q_valid``).
``mha_mode="pair"`` is ``attn="pair"`` here.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from . import int8_kernels as ik
from .attention import check_pair, launch_pair, mha_pair_reference, mha_reference
from .int8_kernels import load_kernel
from .quant import (QuantizedWeight, _deq, _dense_int8, _gelu2, _mods, _prologue, _quant,
                    _quantize_rows, _quantize_static, int_dot, quantize_rows,
                    quantize_rows_reference, quantize_wide, quantize_wide_reference,
                    unpack_weight_w4)

__all__ = ["self_attn_block", "cross_attn_block", "attn_pair_block", "mlp_block",
           "mlp_block_chunked", "mlp_block_streamed", "mha_inline_int8", "quantize_rows",
           "quantize_rows_reference", "quantize_wide", "quantize_wide_reference",
           "self_attn_block_reference", "cross_attn_block_reference",
           "attn_pair_block_reference", "mlp_block_reference", "mlp_chunked_reference",
           "mha_inline_int8_reference", "load_kernel", "ATTN"]

StaticS = Optional[Tuple[float, ...]]
ATTN = ("bf16", "bf16_fold", "int8", "pair")


def _check_attn_mode(attn: str, n_head: int, width: int) -> str:
    if attn not in ATTN:
        raise ValueError(f"attn must be one of {ATTN}, got {attn!r}")
    if attn == "pair":
        check_pair(n_head, width)
    return attn


def mha_inline_int8_reference(q, k, v, *, batch: int, n_head: int, kv_valid: int):
    """Plain twin of K10 (JAX ``int8_block.py::_mha_inline_int8``, applied to
    each batch element): q (B*Lq, D), k/v (B*Lkv, D) -> (B*Lq, D) f32.

    q and k are quantized per row over the whole width D (one row scale
    serves every head); V per column over the Lkv keys of its batch element,
    masked keys included, s_v = max(amax, 1e-8) / 127. Scores are the exact
    int32 Q K^T times (s_q * s_k), times 1/sqrt(hd); keys at or beyond
    ``kv_valid`` at -inf, f32 softmax; P quantized per (head, query) row;
    the exact int32 P V times (s_p * s_v)."""
    M, D = q.shape
    hd = D // n_head
    Lq, Lkv = M // batch, k.shape[0] // batch
    qq, sq = _quantize_rows(q.float())
    kq, sk = _quantize_rows(k.float())
    vf = v.float().reshape(batch, Lkv, D)
    sv = vf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 127.0        # (B, 1, D)
    vq = torch.round(vf / sv).clamp(-127, 127)

    def heads(t, L):   # (B*L, D) -> (B, H, L, hd), exact in float64
        return t.reshape(batch, L, n_head, hd).transpose(1, 2).double()

    acc = (heads(qq, Lq) @ heads(kq, Lkv).transpose(-1, -2)).float()
    s = acc * (sq.reshape(batch, 1, Lq, 1) * sk.reshape(batch, 1, 1, Lkv))
    s = (s * (1.0 / math.sqrt(hd))).masked_fill(
        torch.arange(Lkv, device=q.device) >= kv_valid, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pq, sp = _quantize_rows(p / p.sum(dim=-1, keepdim=True))               # (B, H, Lq, 1)
    acc = (pq.double() @ heads(vq, Lkv)).float()
    o = acc * (sp * sv.reshape(batch, n_head, 1, hd))
    return o.transpose(1, 2).reshape(M, D)


def _plain_weights(ws: Sequence[QuantizedWeight], w4: bool):
    return [unpack_weight_w4(w) if w4 else w for w in ws]


def _split(static_s: StaticS, n: int = 2):
    return tuple(static_s) if static_s is not None else (None,) * n


def _ref_dense(x, w: QuantizedWeight, norm="none", mod=None, s_static=None):
    h = x.float() if norm == "none" else _prologue(x.float(), *_mods(mod), norm)
    q, s = _quant(h, s_static)
    return _deq(int_dot(q, w.w_q), s, w)


def _ref_mha(q, k, v, batch, n_head, kv_valid, attn):
    """The blocks' attention on bf16 q/k/v: its output rounded to bf16, as f32."""
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    kw = dict(batch=batch, n_head=n_head, kv_valid=kv_valid)
    if _check_attn_mode(attn, n_head, q.shape[1]) == "int8":
        return mha_inline_int8_reference(q, k, v, **kw).bfloat16().float()
    if attn == "pair":
        return mha_pair_reference(q, k, v, **kw).float()
    return mha_reference(q, k, v, fold_div=attn == "bf16_fold", **kw).float()


def _ref_proj(y, w: QuantizedWeight, s_static):
    """quantize(bf16(attention output)) -> proj dot -> dequant + bias (f32)."""
    qy, sy = _quant(y.bfloat16().float(), s_static)
    return _deq(int_dot(qy, w.w_q), sy, w)


def _self_attn_twin(x, mod, wq, wk, wv, wproj, mha, static_s: StaticS, w4: bool):
    """K4's twin around ``mha``: bf16 q, k, v -> the attention output as f32."""
    wq, wk, wv, wproj = _plain_weights((wq, wk, wv, wproj), w4)
    s_in, s_out = _split(static_s)
    xf = x.float()
    q_, s = _quant(_prologue(xf, *_mods(mod), "adaln"), s_in)

    def dense(w):
        return _deq(int_dot(q_, w.w_q), s, w).bfloat16()

    y = mha(dense(wq), dense(wk), dense(wv))
    return (_ref_proj(y, wproj, s_out) + xf).to(x.dtype)


def self_attn_block_reference(x, mod, wq, wk, wv, wproj, *, batch: int, n_head: int,
                              q_valid: int, static_s: StaticS = None, w4: bool = False,
                              attn: str = "bf16"):
    """Plain twin of K4. x (B*L, D) bf16, mod (2, D) f32 -> (B*L, D) bf16."""
    return _self_attn_twin(x, mod, wq, wk, wv, wproj,
                           lambda q, k, v: _ref_mha(q, k, v, batch, n_head, q_valid, attn),
                           static_s, w4)


def cross_attn_block_reference(x, mod, ck, cv, wq, wproj, *, batch: int, n_head: int,
                               kv_valid: int, static_s: StaticS = None, w4: bool = False,
                               attn: str = "bf16"):
    """Plain twin of K5. ck/cv (B*S, D) bf16: the condition's K/V."""
    wq, wproj = _plain_weights((wq, wproj), w4)
    s_in, s_out = _split(static_s)
    xf = x.float()
    q = _ref_dense(x, wq, "adaln", mod, s_static=s_in).bfloat16()
    y = _ref_mha(q, ck, cv, batch, n_head, kv_valid, attn)
    return (_ref_proj(y, wproj, s_out) + xf).to(x.dtype)


def attn_pair_block_reference(x, mods, ck, cv, wq, wk, wv, wproj, wcrossq, wcrossproj, *,
                              batch: int, n_head: int, q_valid: int, kv_valid: int,
                              static_s: StaticS = None, attn: str = "bf16"):
    """Plain twin of K8. mods (4, D) f32 = self AdaLN rows; cross AdaLN rows.
    ``static_s``: (self in, self out, cross in, cross out).

    It computes what the TPU kernel computes: x stays f32 between the two
    halves (the self half's x + proj feeds the cross AdaLN unrounded) and
    only the output is rounded to bf16. The JAX oracle of the same name
    composes the two block references instead, with a bf16 rounding of x
    between them, so the two differ by that one rounding."""
    s_in, s_out, s2_in, s2_out = _split(static_s, 4)
    xf = x.float()
    q_, s = _quant(_prologue(xf, *_mods(mods[0:2]), "adaln"), s_in)

    def dense(w):
        return _deq(int_dot(q_, w.w_q), s, w).bfloat16()

    y = _ref_mha(dense(wq), dense(wk), dense(wv), batch, n_head, q_valid, attn)
    xf = _ref_proj(y, wproj, s_out) + xf
    q2 = _ref_dense(xf, wcrossq, "adaln", mods[2:4], s_static=s2_in).bfloat16()
    y2 = _ref_mha(q2, ck, cv, batch, n_head, kv_valid, attn)
    return (_ref_proj(y2, wcrossproj, s2_out) + xf).to(x.dtype)


def mlp_block_reference(x, mod, w1, w2, static_s: StaticS = None, w4: bool = False):
    """Plain twin of K3. mod (2, D) f32 = LayerNorm gamma; beta."""
    w1, w2 = _plain_weights((w1, w2), w4)
    s_in, s_mid = _split(static_s)
    xf = x.float()
    u = _gelu2(_ref_dense(x, w1, "ln", mod, s_static=s_in))
    qu, su = _quant(u, s_mid)
    return (_deq(int_dot(qu, w2.w_q), su, w2) + xf).to(x.dtype)


def mlp_chunked_reference(x, mod, w1, w2, *, n_chunks: int = 4, static_s: StaticS = None):
    """Plain twin of K9: K3 with the hidden dimension in ``n_chunks`` chunks.
    Each chunk's GELU2 output is quantized with its own row scale (dynamic);
    the residual is the f32 accumulator's start, each chunk's fc2 dot adds
    acc * (s_c * scale), and the bias comes last."""
    s_in, s_mid = _split(static_s)
    Dh = w1.w_q.shape[0]
    if Dh % n_chunks:
        raise ValueError(f"hidden width {Dh} is not a multiple of n_chunks {n_chunks}")
    ck = Dh // n_chunks
    xf = x.float()
    q, s = _quant(_prologue(xf, *_mods(mod), "ln"), s_in)
    y = xf
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        u = _gelu2(int_dot(q, w1.w_q[sl]) * (s * w1.scale[sl]) + w1.bias[sl])
        qu, su = _quant(u, s_mid)
        y = y + int_dot(qu, w2.w_q[:, sl]) * (su * w2.scale)
    return (y + w2.bias).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

def _check_width(x, lib):
    M, D = x.shape
    ik.check("x", x, (M, D), torch.bfloat16, x.device)
    if D % 128 or D > lib.t2s_int8_limits(0):
        raise ValueError(f"model width {D} must be a multiple of 128 and at most "
                         f"{lib.t2s_int8_limits(0)}")


def _check_attn(x, mod_rows, batch: int, n_head: int, lib, mod, length: int, valid: int, what):
    _check_width(x, lib)
    M, D = x.shape
    ik.check("mod", mod, (mod_rows, D), torch.float32, x.device)
    if M % batch or D % n_head or D // n_head not in (32, 64):
        raise ValueError(f"x {tuple(x.shape)}, batch {batch}, {n_head} heads: the kernels take "
                         "rows = batch * L and a head width of 32 or 64")
    if not 0 < valid <= length or length > lib.t2s_int8_limits(3):
        raise ValueError(f"{what} {valid} and length {length} out of the kernel's range")


def _check_cond(x, ck, cv, batch: int):
    S = ck.shape[0] // batch
    for name, t in (("ck", ck), ("cv", cv)):
        ik.check(name, t, (batch * S, x.shape[1]), torch.bfloat16, x.device)
    return S


def _check_weights(names, ws, n: int, k: int, w4: bool, device):
    for name, w in zip(names, ws):
        ik.check_weight(name, w, n, k, w4, device)


def _attend(lib, batch: int, n_head: int, kv_valid: int, attn: str):
    """The blocks' MHA launch(es), as a function of checked bf16 q, k, v ->
    (B*Lq, D) bf16: the bf16 MHA of ``int8_block.cu`` in the ``attn`` mode
    (the pair mode counted as ``attention.mha_pair``'s), or K10 through its
    wrapper ``mha_inline_int8``."""
    if attn == "int8":
        return lambda q, k, v: mha_inline_int8(q, k, v, batch=batch, n_head=n_head,
                                               kv_valid=kv_valid)
    if attn == "pair":
        return lambda q, k, v: launch_pair(lib, q, k, v, batch, n_head, kv_valid)
    return lambda q, k, v: ik.mha(lib, q, k, v, batch, n_head, kv_valid, mode=attn)


def _attn_half(x, mod, ws_in, wproj, s_in, s_out, out_dtype, w4: bool, mha, kv=None):
    """One attention half, five steps: [quantize pass, AdaLN] -> [q/k/v dots
    (``ws_in`` three weights), or q's with ``kv`` the condition's K/V] ->
    ``mha`` -> [quantize pass] -> [proj dot + residual x] -> ``out_dtype``.
    On CUDA tensors five launches (``mha`` one, or K10's two); on CPU tensors
    the plain pieces, equal to the twins bit for bit."""
    qx, ax = quantize_rows(x, mod, static_s=s_in)
    outs = _dense_int8(qx, ax, ws_in, s_in, w4)
    q, k, v = outs if kv is None else (outs[0], *kv)
    qy, ay = quantize_rows(mha(q, k, v), static_s=s_out)
    return _dense_int8(qy, ay, (wproj,), s_out, w4, residual=x, out_dtype=out_dtype)[0]


def mha_inline_int8(q, k, v, *, batch: int, n_head: int, kv_valid: int):
    """K10: q (B*Lq, D), k/v (B*Lkv, D) bf16 -> (B*Lq, D) bf16, the int8
    attention ``mha_inline_int8_reference`` computes, rounded once to bf16.
    On the card: a quantize pass, then the int8 MHA on wgmma, one warpgroup
    per 64 queries of a (batch, head), head width 32 or 64, at most 272 keys."""
    if not ik.on_cuda(q, "mha_inline_int8"):
        return mha_inline_int8_reference(q, k, v, batch=batch, n_head=n_head,
                                         kv_valid=kv_valid).to(q.dtype)
    lib = ik.load_mha_int8()
    ik.check_mha(q, k, v, batch, n_head, kv_valid, lib.t2s_mha_int8_max_keys())
    out = ik.mha_int8(lib, q, k, v, batch, n_head, kv_valid)
    mha_inline_int8.launches += 1
    return out


def self_attn_block(x, mod, wq, wk, wv, wproj, *, batch: int, n_head: int, q_valid: int,
                    static_s: StaticS = None, w4: bool = False, attn: str = "bf16"):
    """K4: x (B*L, D) bf16 -> x + proj(MHA(adaln(x))) (B*L, D) bf16; keys at or
    beyond ``q_valid`` are masked; ``attn`` picks the MHA (module docstring).
    Five launches on a CUDA tensor (``_attn_half``), six with ``attn="int8"``."""
    _check_attn_mode(attn, n_head, x.shape[1])
    if not ik.on_cuda(x, "self_attn_block"):
        return self_attn_block_reference(x, mod, wq, wk, wv, wproj, batch=batch, n_head=n_head,
                                         q_valid=q_valid, static_s=static_s, w4=w4, attn=attn)
    lib = load_kernel()
    _check_attn(x, 2, batch, n_head, lib, mod, x.shape[0] // batch, q_valid, "q_valid")
    D = x.shape[1]
    _check_weights(("wq", "wk", "wv", "wproj"), (wq, wk, wv, wproj), D, D, w4, x.device)
    s_in, s_out = _split(static_s)
    out = _attn_half(x, mod, (wq, wk, wv), wproj, s_in, s_out, x.dtype, w4,
                     _attend(lib, batch, n_head, q_valid, attn))
    self_attn_block.launches += 1
    return out


def cross_attn_block(x, mod, ck, cv, wq, wproj, *, batch: int, n_head: int, kv_valid: int,
                     static_s: StaticS = None, w4: bool = False, attn: str = "bf16"):
    """K5: x (B*L, D) bf16; ck/cv (B*S, D) bf16 condition K/V, keys at or beyond
    ``kv_valid`` masked -> (B*L, D) bf16. Five launches on a CUDA tensor, six
    with ``attn="int8"``."""
    _check_attn_mode(attn, n_head, x.shape[1])
    if not ik.on_cuda(x, "cross_attn_block"):
        return cross_attn_block_reference(x, mod, ck, cv, wq, wproj, batch=batch,
                                          n_head=n_head, kv_valid=kv_valid,
                                          static_s=static_s, w4=w4, attn=attn)
    lib = load_kernel()
    S = _check_cond(x, ck, cv, batch)
    _check_attn(x, 2, batch, n_head, lib, mod, S, kv_valid, "kv_valid")
    D = x.shape[1]
    _check_weights(("wq", "wproj"), (wq, wproj), D, D, w4, x.device)
    s_in, s_out = _split(static_s)
    out = _attn_half(x, mod, (wq,), wproj, s_in, s_out, x.dtype, w4,
                     _attend(lib, batch, n_head, kv_valid, attn), kv=(ck, cv))
    cross_attn_block.launches += 1
    return out


def attn_pair_block(x, mods, ck, cv, wq, wk, wv, wproj, wcrossq, wcrossproj, *, batch: int,
                    n_head: int, q_valid: int, kv_valid: int, static_s: StaticS = None,
                    attn: str = "bf16"):
    """K8: K4 then K5 on x (B*L, D) bf16 with mods (4, D) f32, x kept in f32
    between the two halves -> (B*L, D) bf16; both halves run the ``attn``
    MHA. W8 weights. Ten launches on a CUDA tensor (twelve with
    ``attn="int8"``): the self proj writes x + proj in f32, the cross
    quantize pass reads it, and the cross proj adds it and rounds once."""
    _check_attn_mode(attn, n_head, x.shape[1])
    if not ik.on_cuda(x, "attn_pair_block"):
        return attn_pair_block_reference(x, mods, ck, cv, wq, wk, wv, wproj, wcrossq,
                                         wcrossproj, batch=batch, n_head=n_head, q_valid=q_valid,
                                         kv_valid=kv_valid, static_s=static_s, attn=attn)
    lib = load_kernel()
    L = x.shape[0] // batch
    _check_attn(x, 4, batch, n_head, lib, mods, L, q_valid, "q_valid")
    S = _check_cond(x, ck, cv, batch)
    _check_attn(x, 4, batch, n_head, lib, mods, S, kv_valid, "kv_valid")
    D = x.shape[1]
    _check_weights(("wq", "wk", "wv", "wproj", "wcrossq", "wcrossproj"),
                   (wq, wk, wv, wproj, wcrossq, wcrossproj), D, D, False, x.device)
    s_in, s_out, s2_in, s2_out = _split(static_s, 4)
    x1 = _attn_half(x, mods[0:2], (wq, wk, wv), wproj, s_in, s_out, torch.float32, False,
                    _attend(lib, batch, n_head, q_valid, attn))
    out = _attn_half(x1, mods[2:4], (wcrossq,), wcrossproj, s2_in, s2_out, x.dtype, False,
                     _attend(lib, batch, n_head, kv_valid, attn), kv=(ck, cv))
    attn_pair_block.launches += 1
    return out


def _check_mlp(x, mod, w1, w2, w4, lib):
    _check_width(x, lib)
    D = x.shape[1]
    ik.check("mod", mod, (2, D), torch.float32, x.device)
    Dh = w1.w_q.shape[0]
    ik.check_weight("w1", w1, Dh, D, w4, x.device)
    ik.check_weight("w2", w2, D, Dh, w4, x.device)
    if Dh % 128:
        raise ValueError(f"hidden width {Dh} must be a multiple of 128")
    return Dh


def mlp_block(x, mod, w1, w2, *, static_s: StaticS = None, w4: bool = False):
    """K3: x (M, D) bf16 -> x + fc2(gelu2(fc1(ln(x)))) (M, D) bf16. On a CUDA
    tensor two launches under a static scale (the middle through HBM as int8
    with ``s_mid``), three without (the middle as f32 with its row maxima,
    then the wide quantize pass) (``_mlp``)."""
    if not ik.on_cuda(x, "mlp_block"):
        return mlp_block_reference(x, mod, w1, w2, static_s=static_s, w4=w4)
    lib = load_kernel()
    _check_mlp(x, mod, w1, w2, w4, lib)
    out = _mlp(x, mod, w1, w2, static_s, w4)
    mlp_block.launches += 1
    return out


def _fc1(x, mod, w1, s_in, s_mid, nch: int, w4: bool):
    """K3's fc1, LN -> quantize -> dot -> GELU2: int8 quantized with the
    static ``s_mid`` and no maxima, or f32 with its row max |u| per (row,
    chunk of ``nch``) (M, nch). One launch of the Hopper GEMM's LN panel on
    the card; plain on the CPU."""
    if not ik.on_cuda(x, "the fc1 launch"):
        (w,) = _plain_weights((w1,), w4)
        h = _prologue(x.float(), *_mods(mod), "ln")
        q, s = _quant(h, s_in)
        u = _gelu2(_deq(int_dot(q, w.w_q), s, w))
        if s_mid is not None:
            return _quantize_static(u, s_mid)[0], None
        return u, u.abs().reshape(u.shape[0], nch, -1).amax(-1)
    M, Dh = x.shape[0], w1.w_q.shape[0]
    lib = load_kernel()
    if s_mid is not None:
        uq = torch.empty((M, Dh), dtype=torch.int8, device=x.device)
        ik.dense(lib, x, (w1,), (uq,), norm="ln", mod=mod, s=s_in, epi=ik.EPI_GELU_INT8,
                 s_out=s_mid, w4=w4)
        return uq, None
    u = torch.empty((M, Dh), dtype=torch.float32, device=x.device)
    amax = torch.empty((M, nch), dtype=torch.float32, device=x.device)
    ik.dense(lib, x, (w1,), (u,), norm="ln", mod=mod, s=s_in, gelu=True, amax_out=amax, nch=nch,
             w4=w4)
    return u, amax


def _mlp(x, mod, w1, w2, static_s, w4: bool, n_chunks: Optional[int] = None):
    """The MLP blocks' schedule: fc1 (``_fc1``) -> under a dynamic scale the
    wide quantize pass, each of ``n_chunks`` chunks (K9; one for K3) with its
    own row scale -> fc2 in the int8 A mode + residual (K9: the chunked
    epilogue, y from x, += acc_c * (s_c * scale) per chunk, then + bias).
    Three launches on CUDA tensors (two under a static scale); the plain
    pieces on CPU tensors, equal to ``mlp_block_reference`` /
    ``mlp_chunked_reference`` bit for bit."""
    s_in, s_mid = _split(static_s)
    u, amax = _fc1(x, mod, w1, s_in, s_mid, n_chunks or 1, w4)
    if s_mid is None:
        u, amax = quantize_wide(u, amax=amax)
    return _dense_int8(u, amax, (w2,), s_mid, w4, residual=x, n_chunks=n_chunks)[0]


def _mlp_chunked(name: str, x, mod, w1, w2, n_chunks: int, static_s):
    lib = load_kernel()
    Dh = _check_mlp(x, mod, w1, w2, False, lib)
    if n_chunks < 1 or Dh % n_chunks or (Dh // n_chunks) % 128:
        raise ValueError(f"{name}: hidden width {Dh} in {n_chunks} chunks; the kernel takes "
                         "chunks that are a multiple of 128 wide")
    return _mlp(x, mod, w1, w2, static_s, False, n_chunks)


def mlp_block_chunked(x, mod, w1, w2, *, n_chunks: int = 4, static_s: StaticS = None):
    """K9: x (M, D) bf16 -> x + fc2(gelu2(fc1(ln(x)))) with the hidden
    dimension in ``n_chunks`` chunks (``mlp_chunked_reference``). W8 weights.
    Three launches on a CUDA tensor, two under a static scale (``_mlp``)."""
    if not ik.on_cuda(x, "mlp_block_chunked"):
        return mlp_chunked_reference(x, mod, w1, w2, n_chunks=n_chunks, static_s=static_s)
    out = _mlp_chunked("mlp_block_chunked", x, mod, w1, w2, n_chunks, static_s)
    mlp_block_chunked.launches += 1
    return out


def mlp_block_streamed(x, mod, w1, w2, *, n_chunks: int = 16, static_s: StaticS = None):
    """K9, the TPU's streamed-weights schedule: the same numerics as
    ``mlp_block_chunked`` at the same ``n_chunks``, and the same CUDA kernel
    (its default is 16 chunks)."""
    if not ik.on_cuda(x, "mlp_block_streamed"):
        return mlp_chunked_reference(x, mod, w1, w2, n_chunks=n_chunks, static_s=static_s)
    out = _mlp_chunked("mlp_block_streamed", x, mod, w1, w2, n_chunks, static_s)
    mlp_block_streamed.launches += 1
    return out


self_attn_block.launches = 0
cross_attn_block.launches = 0
attn_pair_block.launches = 0
mlp_block.launches = 0
mlp_block_chunked.launches = 0
mlp_block_streamed.launches = 0
mha_inline_int8.launches = 0
