"""Int8 transformer sub-blocks of the serving engine (K3, K4, K5, K8, K9).

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

The ``*_reference`` functions are the plain PyTorch versions and define what
the kernels compute (the JAX package's ``*_reference`` twins; W4 goes through
``unpack_weight_w4``, so W4 is bitwise the unpacked W8 path). The wrappers
launch the hand-written CUDA kernels of ``csrc/int8_block.cu`` for CUDA
tensors and run the plain version only for CPU tensors; each counts its
kernel runs in ``.launches``. The TPU schedule options (``rows_per_program``,
``mha_mode``, ``block_m``, ``pipeline_halves``, row padding) are not carried
over: the Hopper kernels choose their own tiling and take the unpadded
sequence.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import int8_kernels as ik
from .attention import mha_reference
from .int8_kernels import load_kernel
from .quant import (QuantizedWeight, _deq, _gelu2, _prologue, _quant, int_dot,
                    unpack_weight_w4)

__all__ = ["self_attn_block", "cross_attn_block", "attn_pair_block", "mlp_block",
           "mlp_block_chunked", "mlp_block_streamed",
           "self_attn_block_reference", "cross_attn_block_reference",
           "attn_pair_block_reference", "mlp_block_reference", "mlp_chunked_reference",
           "load_kernel"]

StaticS = Optional[Tuple[float, ...]]


def _plain_weights(ws: Sequence[QuantizedWeight], w4: bool):
    return [unpack_weight_w4(w) if w4 else w for w in ws]


def _split(static_s: StaticS, n: int = 2):
    return tuple(static_s) if static_s is not None else (None,) * n


def _mods(mod):
    mod = mod.float()
    return mod[0:1], mod[1:2]


def _ref_dense(x, w: QuantizedWeight, norm="none", mod=None, s_static=None):
    h = x.float() if norm == "none" else _prologue(x.float(), *_mods(mod), norm)
    q, s = _quant(h, s_static)
    return _deq(int_dot(q, w.w_q), s, w)


def _ref_mha(q, k, v, batch, n_head, kv_valid):
    return mha_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), batch=batch,
                         n_head=n_head, kv_valid=kv_valid).float()


def _ref_proj(y, w: QuantizedWeight, s_static):
    """quantize(bf16(attention output)) -> proj dot -> dequant + bias (f32)."""
    qy, sy = _quant(y.bfloat16().float(), s_static)
    return _deq(int_dot(qy, w.w_q), sy, w)


def self_attn_block_reference(x, mod, wq, wk, wv, wproj, *, batch: int, n_head: int,
                              q_valid: int, static_s: StaticS = None, w4: bool = False):
    """Plain twin of K4. x (B*L, D) bf16, mod (2, D) f32 -> (B*L, D) bf16."""
    wq, wk, wv, wproj = _plain_weights((wq, wk, wv, wproj), w4)
    s_in, s_out = _split(static_s)
    xf = x.float()
    q_, s = _quant(_prologue(xf, *_mods(mod), "adaln"), s_in)

    def dense(w):
        return _deq(int_dot(q_, w.w_q), s, w).bfloat16()

    y = _ref_mha(dense(wq), dense(wk), dense(wv), batch, n_head, q_valid)
    return (_ref_proj(y, wproj, s_out) + xf).to(x.dtype)


def cross_attn_block_reference(x, mod, ck, cv, wq, wproj, *, batch: int, n_head: int,
                               kv_valid: int, static_s: StaticS = None, w4: bool = False):
    """Plain twin of K5. ck/cv (B*S, D) bf16: the condition's K/V."""
    wq, wproj = _plain_weights((wq, wproj), w4)
    s_in, s_out = _split(static_s)
    xf = x.float()
    q = _ref_dense(x, wq, "adaln", mod, s_static=s_in).bfloat16()
    y = _ref_mha(q, ck, cv, batch, n_head, kv_valid)
    return (_ref_proj(y, wproj, s_out) + xf).to(x.dtype)


def attn_pair_block_reference(x, mods, ck, cv, wq, wk, wv, wproj, wcrossq, wcrossproj, *,
                              batch: int, n_head: int, q_valid: int, kv_valid: int,
                              static_s: StaticS = None):
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

    y = _ref_mha(dense(wq), dense(wk), dense(wv), batch, n_head, q_valid)
    xf = _ref_proj(y, wproj, s_out) + xf
    q2 = _ref_dense(xf, wcrossq, "adaln", mods[2:4], s_static=s2_in).bfloat16()
    y2 = _ref_mha(q2, ck, cv, batch, n_head, kv_valid)
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


def _attn_half(lib, x, mod, wq, wproj, s_in, s_out, residual_out, w4, *, kv=None, qkv=None,
               batch, n_head, kv_valid):
    """[AdaLN + quantize + q (and k, v) dots] -> MHA -> [quantize + proj +
    residual] into ``residual_out`` (bf16 or f32), three launches."""
    if qkv is not None:
        q, k, v = (torch.empty(x.shape, dtype=torch.bfloat16, device=x.device) for _ in range(3))
        ik.dense(lib, x, qkv, (q, k, v), norm="adaln", mod=mod, s=s_in, w4=w4)
    else:
        q = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
        ik.dense(lib, x, (wq,), (q,), norm="adaln", mod=mod, s=s_in, w4=w4)
        k, v = kv
    y = ik.mha(lib, q, k, v, batch, n_head, kv_valid)
    ik.dense(lib, y, (wproj,), (residual_out,), s=s_out, residual=x, w4=w4)
    return residual_out


def self_attn_block(x, mod, wq, wk, wv, wproj, *, batch: int, n_head: int, q_valid: int,
                    static_s: StaticS = None, w4: bool = False):
    """K4: x (B*L, D) bf16 -> x + proj(MHA(adaln(x))) (B*L, D) bf16; keys at or
    beyond ``q_valid`` are masked. Three launches on a CUDA tensor."""
    if not ik.on_cuda(x, "self_attn_block"):
        return self_attn_block_reference(x, mod, wq, wk, wv, wproj, batch=batch, n_head=n_head,
                                         q_valid=q_valid, static_s=static_s, w4=w4)
    lib = load_kernel()
    _check_attn(x, 2, batch, n_head, lib, mod, x.shape[0] // batch, q_valid, "q_valid")
    D = x.shape[1]
    _check_weights(("wq", "wk", "wv", "wproj"), (wq, wk, wv, wproj), D, D, w4, x.device)
    s_in, s_out = _split(static_s)
    out = _attn_half(lib, x, mod, None, wproj, s_in, s_out, torch.empty_like(x), w4,
                     qkv=(wq, wk, wv), batch=batch, n_head=n_head, kv_valid=q_valid)
    self_attn_block.launches += 1
    return out


def cross_attn_block(x, mod, ck, cv, wq, wproj, *, batch: int, n_head: int, kv_valid: int,
                     static_s: StaticS = None, w4: bool = False):
    """K5: x (B*L, D) bf16; ck/cv (B*S, D) bf16 condition K/V, keys at or beyond
    ``kv_valid`` masked -> (B*L, D) bf16. Three launches on a CUDA tensor."""
    if not ik.on_cuda(x, "cross_attn_block"):
        return cross_attn_block_reference(x, mod, ck, cv, wq, wproj, batch=batch,
                                          n_head=n_head, kv_valid=kv_valid,
                                          static_s=static_s, w4=w4)
    lib = load_kernel()
    S = _check_cond(x, ck, cv, batch)
    _check_attn(x, 2, batch, n_head, lib, mod, S, kv_valid, "kv_valid")
    D = x.shape[1]
    _check_weights(("wq", "wproj"), (wq, wproj), D, D, w4, x.device)
    s_in, s_out = _split(static_s)
    out = _attn_half(lib, x, mod, wq, wproj, s_in, s_out, torch.empty_like(x), w4, kv=(ck, cv),
                     batch=batch, n_head=n_head, kv_valid=kv_valid)
    cross_attn_block.launches += 1
    return out


def attn_pair_block(x, mods, ck, cv, wq, wk, wv, wproj, wcrossq, wcrossproj, *, batch: int,
                    n_head: int, q_valid: int, kv_valid: int, static_s: StaticS = None):
    """K8: K4 then K5 on x (B*L, D) bf16 with mods (4, D) f32, x kept in f32
    between the two halves -> (B*L, D) bf16. W8 weights. Six launches on a
    CUDA tensor: the self proj writes x + proj in f32, the cross AdaLN panel
    reads it, and the cross proj adds it and rounds once."""
    if not ik.on_cuda(x, "attn_pair_block"):
        return attn_pair_block_reference(x, mods, ck, cv, wq, wk, wv, wproj, wcrossq,
                                         wcrossproj, batch=batch, n_head=n_head, q_valid=q_valid,
                                         kv_valid=kv_valid, static_s=static_s)
    lib = load_kernel()
    L = x.shape[0] // batch
    _check_attn(x, 4, batch, n_head, lib, mods, L, q_valid, "q_valid")
    S = _check_cond(x, ck, cv, batch)
    _check_attn(x, 4, batch, n_head, lib, mods, S, kv_valid, "kv_valid")
    D = x.shape[1]
    _check_weights(("wq", "wk", "wv", "wproj", "wcrossq", "wcrossproj"),
                   (wq, wk, wv, wproj, wcrossq, wcrossproj), D, D, False, x.device)
    s_in, s_out, s2_in, s2_out = _split(static_s, 4)
    x1 = _attn_half(lib, x, mods[0:2], None, wproj, s_in, s_out,
                    torch.empty(x.shape, dtype=torch.float32, device=x.device), False,
                    qkv=(wq, wk, wv), batch=batch, n_head=n_head, kv_valid=q_valid)
    out = _attn_half(lib, x1, mods[2:4], wcrossq, wcrossproj, s2_in, s2_out,
                     torch.empty_like(x), False, kv=(ck, cv), batch=batch, n_head=n_head,
                     kv_valid=kv_valid)
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
    """K3: x (M, D) bf16 -> x + fc2(gelu2(fc1(ln(x)))) (M, D) bf16. Two
    launches on a CUDA tensor; the (M, 4D) middle passes through HBM, as
    int8 with a static ``s_mid`` and as f32 (plus its row maxima) without."""
    if not ik.on_cuda(x, "mlp_block"):
        return mlp_block_reference(x, mod, w1, w2, static_s=static_s, w4=w4)
    lib = load_kernel()
    Dh = _check_mlp(x, mod, w1, w2, w4, lib)
    out = _mlp(lib, x, mod, w1, w2, Dh, static_s, w4)
    mlp_block.launches += 1
    return out


def _mlp(lib, x, mod, w1, w2, Dh: int, static_s, w4: bool, n_chunks: Optional[int] = None):
    """fc1 launch, then fc2 launch. ``n_chunks`` (K9) gives each chunk of the
    middle its own dynamic row scale and flushes fc2's sums per chunk into
    an f32 accumulator that starts at the residual."""
    M = x.shape[0]
    s_in, s_mid = _split(static_s)
    out = torch.empty_like(x)
    epi = ik.EPI_STORE if n_chunks is None else ik.EPI_CHUNKED
    n_chunks = n_chunks or 1
    if s_mid is None:
        u = torch.empty((M, Dh), dtype=torch.float32, device=x.device)
        amax = torch.empty((M, n_chunks), dtype=torch.float32, device=x.device)
        ik.dense(lib, x, (w1,), (u,), norm="ln", mod=mod, s=s_in, gelu=True, amax_out=amax,
                 nch=n_chunks, w4=w4)
        ik.dense(lib, u, (w2,), (out,), amode=ik.STREAM, epi=epi, amax_in=amax, residual=x,
                 nch=n_chunks, w4=w4)
    else:
        uq = torch.empty((M, Dh), dtype=torch.int8, device=x.device)
        ik.dense(lib, x, (w1,), (uq,), norm="ln", mod=mod, s=s_in, epi=ik.EPI_GELU_INT8,
                 s_out=s_mid, w4=w4)
        ik.dense(lib, uq, (w2,), (out,), amode=ik.INT8, epi=epi, s=s_mid, residual=x,
                 nch=n_chunks, w4=w4)
    return out


def _mlp_chunked(name: str, x, mod, w1, w2, n_chunks: int, static_s):
    lib = load_kernel()
    Dh = _check_mlp(x, mod, w1, w2, False, lib)
    if n_chunks < 1 or Dh % n_chunks or (Dh // n_chunks) % 128:
        raise ValueError(f"{name}: hidden width {Dh} in {n_chunks} chunks; the kernel takes "
                         "chunks that are a multiple of 128 wide")
    return _mlp(lib, x, mod, w1, w2, Dh, static_s, False, n_chunks)


def mlp_block_chunked(x, mod, w1, w2, *, n_chunks: int = 4, static_s: StaticS = None):
    """K9: x (M, D) bf16 -> x + fc2(gelu2(fc1(ln(x)))) with the hidden
    dimension in ``n_chunks`` chunks (``mlp_chunked_reference``). W8 weights.
    Two launches on a CUDA tensor."""
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
