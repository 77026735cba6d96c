"""Int8 transformer sub-blocks of the serving engine (K3, K4, K5).

Port of ``text_to_sound_synthesis_tpu/ops/int8_block.py``: one function per
sub-block of a denoiser layer (``SelfCrossBlock``), each

  self_attn_block:  AdaLN -> quantize -> q/k/v int8 dots -> MHA -> quantize
                    -> proj int8 dot -> + residual
  cross_attn_block: AdaLN -> quantize -> q int8 dot -> MHA against the
                    precomputed condition K/V -> quantize -> proj -> + residual
  mlp_block:        LN -> quantize -> fc1 int8 dot -> GELU2 -> quantize ->
                    fc2 int8 dot -> + residual

Quantization is per-row dynamic (row abs-max), or static per-tensor when
``static_s`` gives the calibrated (in, out/mid) scales. ``w4=True`` takes
nibble-packed int4 weights (``quantize_weight_w4``).

The ``*_reference`` functions are the plain PyTorch versions and define what
the kernels compute (the JAX package's ``*_reference`` twins; W4 goes through
``unpack_weight_w4``, so W4 is bitwise the unpacked W8 path). The wrappers
``self_attn_block`` / ``cross_attn_block`` / ``mlp_block`` launch the
hand-written CUDA kernels of ``csrc/int8_block.cu`` for CUDA tensors and run
the plain version only for CPU tensors; each counts its kernel runs in
``.launches``. The TPU schedule options (``rows_per_program``, ``mha_mode``,
``block_m``, row padding) are not carried over: the Hopper kernels choose
their own tiling and take the unpadded sequence.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.cuda_build import load_library
from .attention import mha_reference
from .quant import (QuantizedWeight, _deq, _gelu2, _prologue, _quant, int_dot,
                    unpack_weight_w4)

__all__ = ["self_attn_block", "cross_attn_block", "mlp_block",
           "self_attn_block_reference", "cross_attn_block_reference", "mlp_block_reference",
           "load_kernel"]

StaticS = Optional[Tuple[float, float]]


def _plain_weights(ws: Sequence[QuantizedWeight], w4: bool):
    return [unpack_weight_w4(w) if w4 else w for w in ws]


def _split(static_s: StaticS):
    return static_s if static_s is not None else (None, None)


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
    qy, sy = _quant(y.bfloat16().float(), s_out)
    return (_deq(int_dot(qy, wproj.w_q), sy, wproj) + xf).to(x.dtype)


def cross_attn_block_reference(x, mod, ck, cv, wq, wproj, *, batch: int, n_head: int,
                               kv_valid: int, static_s: StaticS = None, w4: bool = False):
    """Plain twin of K5. ck/cv (B*S, D) bf16: the condition's K/V."""
    wq, wproj = _plain_weights((wq, wproj), w4)
    s_in, s_out = _split(static_s)
    xf = x.float()
    q = _ref_dense(x, wq, "adaln", mod, s_static=s_in).bfloat16()
    y = _ref_mha(q, ck, cv, batch, n_head, kv_valid)
    qy, sy = _quant(y.bfloat16().float(), s_out)
    return (_deq(int_dot(qy, wproj.w_q), sy, wproj) + xf).to(x.dtype)


def mlp_block_reference(x, mod, w1, w2, static_s: StaticS = None, w4: bool = False):
    """Plain twin of K3. mod (2, D) f32 = LayerNorm gamma; beta."""
    w1, w2 = _plain_weights((w1, w2), w4)
    s_in, s_mid = _split(static_s)
    xf = x.float()
    u = _gelu2(_ref_dense(x, w1, "ln", mod, s_static=s_in))
    qu, su = _quant(u, s_mid)
    return (_deq(int_dot(qu, w2.w_q), su, w2) + xf).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_PANEL, _STREAM, _INT8 = 0, 1, 2
_NORM = {"none": 0, "adaln": 1, "ln": 2}
_EPI_BF16, _EPI_RESIDUAL, _EPI_GELU, _EPI_GELU_INT8 = 0, 1, 2, 3


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/int8_block.cu``."""
    lib = load_library("int8_block", ["int8_block.cu"])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.t2s_int8_dense.argtypes = [I, I, I, I, P, P, P, F, F, I, I] + [P] * 12 + [P, P, F, I, I, I, P]
    lib.t2s_int8_dense.restype = I
    lib.t2s_int8_mha.argtypes = [P, P, P, P, I, I, I, I, I, I, P]
    lib.t2s_int8_mha.restype = I
    lib.t2s_int8_limits.argtypes = [I]
    lib.t2s_int8_limits.restype = I
    return lib


def _check(name, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_weight(name, w: QuantizedWeight, n: int, k: int, w4: bool, device):
    _check(f"{name}.w_q", w.w_q, (n, k // 2 if w4 else k), torch.int8, device)
    _check(f"{name}.scale", w.scale, (n,), torch.float32, device)
    _check(f"{name}.bias", w.bias, (n,), torch.float32, device)


def _static_args(s: Optional[float]):
    """(s_static, inv_static, is_static) for the kernel: the dequant scale and
    the quantize reciprocal, both rounded to f32 as the plain twin rounds them."""
    if s is None:
        return 0.0, 0.0, 0
    return float(np.float32(s)), float(np.float32(1.0 / s)), 1


def _dense(lib, amode, norm, epi, a, mod, amax_in, s, ws, outs, residual, amax_out, w4,
           s_out=None):
    M, K = a.shape
    N = ws[0].w_q.shape[0]
    s_static, inv, is_static = _static_args(s)
    wargs = []
    for i in range(3):
        if i < len(ws):
            wargs += [ws[i].w_q.data_ptr(), ws[i].scale.data_ptr(), ws[i].bias.data_ptr(),
                      outs[i].data_ptr()]
        else:
            wargs += [None] * 4
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.t2s_int8_dense(amode, _NORM[norm], int(w4), epi, a.data_ptr(), ptr(mod),
                                 ptr(amax_in), s_static, inv, is_static, len(ws), *wargs,
                                 ptr(residual), ptr(amax_out), _static_args(s_out)[1], M, K, N,
                                 stream)
    if err != 0:
        raise RuntimeError(f"int8 dense kernel launch failed: cudaError {err}")


def _mha(lib, q, k, v, batch: int, n_head: int, kv_valid: int):
    M, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.t2s_int8_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch,
                               M // batch, k.shape[0] // batch, n_head, D // n_head, kv_valid,
                               stream)
    if err != 0:
        raise RuntimeError(f"int8 attention kernel launch failed: cudaError {err}")
    return out


def _check_common(x, mod, batch: int, n_head: int, lib):
    M, D = x.shape
    dev = x.device
    _check("x", x, (M, D), torch.bfloat16, dev)
    _check("mod", mod, (2, D), torch.float32, dev)
    if M % batch or D % n_head or D // n_head not in (32, 64):
        raise ValueError(f"x {tuple(x.shape)}, batch {batch}, {n_head} heads: the kernels take "
                         "rows = batch * L and a head width of 32 or 64")
    if D % 128 or D > lib.t2s_int8_limits(0):
        raise ValueError(f"model width {D} must be a multiple of 128 and at most "
                         f"{lib.t2s_int8_limits(0)}")


def _on_cuda(x: torch.Tensor, fn: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (plain version); raises else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on cpu or cuda, got {x.device}")
    return True


def self_attn_block(x, mod, wq, wk, wv, wproj, *, batch: int, n_head: int, q_valid: int,
                    static_s: StaticS = None, w4: bool = False):
    """K4: x (B*L, D) bf16 -> x + proj(MHA(adaln(x))) (B*L, D) bf16; keys at or
    beyond ``q_valid`` are masked. Three launches on a CUDA tensor."""
    if not _on_cuda(x, "self_attn_block"):
        return self_attn_block_reference(x, mod, wq, wk, wv, wproj, batch=batch, n_head=n_head,
                                         q_valid=q_valid, static_s=static_s, w4=w4)
    lib = load_kernel()
    _check_common(x, mod, batch, n_head, lib)
    M, D = x.shape
    L = M // batch
    if not 0 < q_valid <= L or L > lib.t2s_int8_limits(3):
        raise ValueError(f"q_valid {q_valid} and sequence {L} out of the kernel's range")
    for name, w in zip(("wq", "wk", "wv", "wproj"), (wq, wk, wv, wproj)):
        _check_weight(name, w, D, D, w4, x.device)
    s_in, s_out = _split(static_s)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    _dense(lib, _PANEL, "adaln", _EPI_BF16, x, mod, None, s_in, (wq, wk, wv), (q, k, v),
           None, None, w4)
    y = _mha(lib, q, k, v, batch, n_head, q_valid)
    out = torch.empty_like(x)
    _dense(lib, _PANEL, "none", _EPI_RESIDUAL, y, None, None, s_out, (wproj,), (out,), x,
           None, w4)
    self_attn_block.launches += 1
    return out


def cross_attn_block(x, mod, ck, cv, wq, wproj, *, batch: int, n_head: int, kv_valid: int,
                     static_s: StaticS = None, w4: bool = False):
    """K5: x (B*L, D) bf16; ck/cv (B*S, D) bf16 condition K/V, keys at or beyond
    ``kv_valid`` masked -> (B*L, D) bf16. Three launches on a CUDA tensor."""
    if not _on_cuda(x, "cross_attn_block"):
        return cross_attn_block_reference(x, mod, ck, cv, wq, wproj, batch=batch,
                                          n_head=n_head, kv_valid=kv_valid,
                                          static_s=static_s, w4=w4)
    lib = load_kernel()
    _check_common(x, mod, batch, n_head, lib)
    M, D = x.shape
    S = ck.shape[0] // batch
    _check("ck", ck, (batch * S, D), torch.bfloat16, x.device)
    _check("cv", cv, (batch * S, D), torch.bfloat16, x.device)
    if not 0 < kv_valid <= S or S > lib.t2s_int8_limits(3):
        raise ValueError(f"kv_valid {kv_valid} and condition length {S} out of range")
    for name, w in zip(("wq", "wproj"), (wq, wproj)):
        _check_weight(name, w, D, D, w4, x.device)
    s_in, s_out = _split(static_s)
    q = torch.empty_like(x)
    _dense(lib, _PANEL, "adaln", _EPI_BF16, x, mod, None, s_in, (wq,), (q,), None, None, w4)
    y = _mha(lib, q, ck, cv, batch, n_head, kv_valid)
    out = torch.empty_like(x)
    _dense(lib, _PANEL, "none", _EPI_RESIDUAL, y, None, None, s_out, (wproj,), (out,), x,
           None, w4)
    cross_attn_block.launches += 1
    return out


def mlp_block(x, mod, w1, w2, *, static_s: StaticS = None, w4: bool = False):
    """K3: x (M, D) bf16 -> x + fc2(gelu2(fc1(ln(x)))) (M, D) bf16. Two
    launches on a CUDA tensor; the (M, 4D) middle passes through HBM, as
    int8 with a static ``s_mid`` and as f32 (plus its row maxima) without."""
    if not _on_cuda(x, "mlp_block"):
        return mlp_block_reference(x, mod, w1, w2, static_s=static_s, w4=w4)
    lib = load_kernel()
    M, D = x.shape
    _check("x", x, (M, D), torch.bfloat16, x.device)
    _check("mod", mod, (2, D), torch.float32, x.device)
    if D % 128 or D > lib.t2s_int8_limits(0):
        raise ValueError(f"model width {D} must be a multiple of 128 and at most "
                         f"{lib.t2s_int8_limits(0)}")
    Dh = w1.w_q.shape[0]
    _check_weight("w1", w1, Dh, D, w4, x.device)
    _check_weight("w2", w2, D, Dh, w4, x.device)
    if Dh % 128:
        raise ValueError(f"hidden width {Dh} must be a multiple of 128")
    s_in, s_mid = _split(static_s)
    out = torch.empty_like(x)
    if s_mid is None:
        u = torch.empty((M, Dh), dtype=torch.float32, device=x.device)
        amax = torch.empty((M,), dtype=torch.float32, device=x.device)
        _dense(lib, _PANEL, "ln", _EPI_GELU, x, mod, None, s_in, (w1,), (u,), None, amax, w4)
        _dense(lib, _STREAM, "none", _EPI_RESIDUAL, u, None, amax, None, (w2,), (out,), x,
               None, w4)
    else:
        uq = torch.empty((M, Dh), dtype=torch.int8, device=x.device)
        _dense(lib, _PANEL, "ln", _EPI_GELU_INT8, x, mod, None, s_in, (w1,), (uq,), None, None,
               w4, s_out=s_mid)
        _dense(lib, _INT8, "none", _EPI_RESIDUAL, uq, None, None, s_mid, (w2,), (out,), x,
               None, w4)
    mlp_block.launches += 1
    return out


self_attn_block.launches = 0
cross_attn_block.launches = 0
mlp_block.launches = 0
