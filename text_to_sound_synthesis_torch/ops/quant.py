"""Int8 / int4 weight quantization and the plain quantized dense (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/ops/quant.py``: ``QuantizedWeight``,
``quantize_weight`` (W8, per output channel amax/127), ``quantize_weight_w4``
(W4, amax/7, nibble-packed), ``unpack_weight_w4``, the shared prologue and
quantize helpers, the plain quantized dense ``quant_dense_reference`` (and
``quant_dense_multi_reference``, the same over several weights), and K6:
``fused_quant_dense`` / ``fused_quant_dense_multi``, wrappers that launch the
CUDA dense of ``csrc/int8_block.cu`` for a CUDA tensor and run the plain
twin for a CPU one, each counting its calls in ``.launches``. The TPU
schedule options (``block_m``, ``interpret``) are not carried over.

Layout: ``w_q`` is stored as the torch ``Linear`` weight is, (N, K) = (out,
in), where the JAX package stores (K, N); the values are bit-identical to the
JAX package's (its ``w_q`` is this one transposed). W4 packs along K exactly
as the JAX package does: byte ``[n, k]`` holds ``w[n, k]`` in its low nibble
and ``w[n, k + K/2]`` in its high nibble (4-bit two's complement). This
K-contiguous layout is the one the Hopper kernels read.

The integer dot runs in float64 (stock PyTorch has no int32 matmul on CUDA):
it is exact while |sum| < 2^53, and the worst case here is 127*127*4096.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import int8_kernels as ik

__all__ = ["QuantizedWeight", "quantize_weight", "quantize_weight_w4", "unpack_weight_w4",
           "quant_dense_reference", "quant_dense_multi_reference", "quant_dense_xla",
           "fused_quant_dense", "fused_quant_dense_multi", "int_dot", "LN_EPS"]

LN_EPS = 1e-6


class QuantizedWeight(NamedTuple):
    """Per-output-channel symmetric quantized weight."""

    w_q: torch.Tensor      # (N, K) int8, or (N, K/2) int8 nibble-packed (W4)
    scale: torch.Tensor    # (N,) f32 dequant multiplier
    bias: torch.Tensor     # (N,) f32


def _bias(bias, n: int, like: torch.Tensor) -> torch.Tensor:
    if bias is None:
        return torch.zeros(n, dtype=torch.float32, device=like.device)
    return bias.reshape(-1).float()


def quantize_weight(w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> QuantizedWeight:
    """(N, K) float weight -> symmetric per-output-channel int8 + f32 scale."""
    w = w.float()
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 127.0
    w_q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantizedWeight(w_q, scale, _bias(bias, w.shape[0], w))


def quantize_weight_w4(w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> QuantizedWeight:
    """(N, K) float weight -> symmetric per-output-channel int4, nibble-packed
    into (N, K/2) int8 (low nibble w[:, :K/2], high nibble w[:, K/2:])."""
    w = w.float()
    K = w.shape[1]
    if K % 2:
        raise ValueError(f"W4 packing needs an even input width, got {K}")
    scale = w.abs().amax(dim=1).clamp_min(1e-8) / 7.0
    w4 = torch.round(w / scale[:, None]).clamp(-7, 7).to(torch.int32)
    lo, hi = w4[:, :K // 2], w4[:, K // 2:]
    packed = ((hi << 4) | (lo & 0xF)).to(torch.int8)
    return QuantizedWeight(packed, scale, _bias(bias, w.shape[0], w))


def unpack_weight_w4(w: QuantizedWeight) -> QuantizedWeight:
    """Packed W4 -> plain (N, K) int8 weight with the same values (the plain
    twin of the kernels' in-register unpack): each nibble sign-extended."""
    p = w.w_q.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return QuantizedWeight(torch.cat([lo, hi], dim=1).to(torch.int8), w.scale, w.bias)


def _gelu2(x):
    """x * sigmoid(1.702 x), the reference's GELU2."""
    return x * torch.sigmoid(1.702 * x)


def _prologue(x, mod_scale, mod_shift, norm: str):
    """LayerNorm variants in f32 (eps 1e-6). mod_* broadcast over rows."""
    if norm == "none":
        return x
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    h = (x - mean) * torch.rsqrt(var + LN_EPS)
    if norm == "adaln":          # LN(no affine) * (1 + scale) + shift
        return h * (1.0 + mod_scale) + mod_shift
    if norm == "ln":             # affine LN: gamma * h + beta
        return h * mod_scale + mod_shift
    raise ValueError(norm)


def _quantize_rows(h) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: (int8 values, f32 (rows, 1) dequant scale)."""
    s = h.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(h / s).clamp(-127, 127).to(torch.int8), s


def _quantize_static(h, s: float) -> Tuple[torch.Tensor, float]:
    """Static per-tensor int8 with a calibrated scale ``s``. As in the JAX
    package, the reciprocal is taken in double and rounded to f32 once, and
    the dequant scale is ``s`` rounded to f32."""
    inv = float(np.float32(1.0 / s))
    return torch.round(h * inv).clamp(-127, 127).to(torch.int8), float(np.float32(s))


def _quant(h, s_static: Optional[float]):
    return _quantize_rows(h) if s_static is None else _quantize_static(h, s_static)


def int_dot(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> exact (M, N) sums as f32 (the int32
    accumulator's value cast to f32, as the JAX package does)."""
    return (q.double() @ w_q.double().T).float()


def _deq(acc, s: Union[float, torch.Tensor], w: QuantizedWeight):
    """acc * (s_row * scale_col) + bias, in that order."""
    return acc * (s * w.scale) + w.bias


def quant_dense_reference(
    x: torch.Tensor,
    w: QuantizedWeight,
    *,
    norm: str = "none",
    mod: Optional[torch.Tensor] = None,     # (2, K) f32: scale row, shift row
    act: str = "none",
    residual: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.bfloat16,
    s_static: Optional[float] = None,
) -> torch.Tensor:
    """Plain twin of the fused quantized dense: prologue -> quantize -> exact
    integer dot -> dequant + bias -> [GELU2] -> [+ residual] -> ``out_dtype``."""
    if norm == "ln" and mod is None:
        raise ValueError("norm='ln' requires mod = (gamma, beta) rows")
    if mod is None:
        mod = torch.zeros((2, x.shape[-1]), dtype=torch.float32, device=x.device)
    mod = mod.float()
    h = _prologue(x.float(), mod[0:1], mod[1:2], norm)
    q, s = _quant(h, s_static)
    y = _deq(int_dot(q, w.w_q), s, w)
    if act == "gelu2":
        y = _gelu2(y)
    elif act != "none":
        raise ValueError(act)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


# The JAX package's XLA variant differs from its reference only in running the
# dot as an int8 x int8 -> int32 XLA dot; stock PyTorch has none, so the two
# are one function here.
quant_dense_xla = quant_dense_reference


def quant_dense_multi_reference(x: torch.Tensor, ws: Sequence[QuantizedWeight],
                                **kw) -> Tuple[torch.Tensor, ...]:
    """Plain twin of ``fused_quant_dense_multi``: ``quant_dense_reference``
    for each weight (the JAX engine's ``_dense_ref_multi``)."""
    return tuple(quant_dense_reference(x, w, **kw) for w in ws)


# ---------------------------------------------------------------------------
# K6: the per-dense kernel
# ---------------------------------------------------------------------------

def _check_dense_args(ws, norm: str, mod, act: str, residual) -> None:
    """What the JAX kernels refuse, on either device."""
    if norm not in ("none", "ln", "adaln"):
        raise ValueError(norm)
    if norm == "ln" and mod is None:
        raise ValueError("norm='ln' requires mod = (gamma, beta) rows")
    if act not in ("none", "gelu2"):
        raise ValueError(act)
    if residual is not None and any(w.w_q.shape[0] != ws[0].w_q.shape[0] for w in ws):
        raise ValueError("residual requires equal output widths")


def _dense_cuda(x, ws, *, norm, mod, act, residual, out_dtype, s_static):
    """K6 on the card: one GEMM launch that shares its quantized input among
    up to three weights. K <= 1024 (a multiple of 128) builds normalised,
    quantized row panels in shared memory; a wider input (norm 'none' only,
    the per-dense fc2 at K = 4096) streams its rows and quantizes them on the
    fly, after a one-warp-per-row pass for the row max |x| under a dynamic
    scale."""
    lib = ik.load_kernel()
    M, K = x.shape
    dev = x.device
    ik.check("x", x, (M, K), torch.bfloat16, dev)
    if not 1 <= len(ws) <= 3:
        raise ValueError(f"the kernel takes one to three weights, got {len(ws)}")
    N = ws[0].w_q.shape[0]
    if any(w.w_q.shape[0] != N for w in ws):
        raise ValueError("the kernel takes weights of one output width")
    for i, w in enumerate(ws):
        ik.check_weight(f"ws[{i}]", w, N, K, False, dev)
    if N % 128:
        raise ValueError(f"output width {N} must be a multiple of 128")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    panel_k = lib.t2s_int8_limits(0)
    panel = K % 128 == 0 and K <= panel_k
    if not panel and (norm != "none" or K % 64):
        raise ValueError(f"input width {K}: a normalised input must be a multiple of 128 and at "
                         f"most {panel_k} wide, any input a multiple of 64")
    if norm != "none":
        if mod is None:    # AdaLN without a modulation, as the plain twin takes it
            mod = torch.zeros((2, K), dtype=torch.float32, device=dev)
        ik.check("mod", mod, (2, K), torch.float32, dev)
    if residual is not None:
        ik.check("residual", residual, (M, N), (torch.bfloat16, torch.float32), dev)
    outs = tuple(torch.empty((M, N), dtype=out_dtype, device=dev) for _ in ws)
    kw = dict(s=s_static, residual=residual, gelu=act == "gelu2")
    if panel:
        ik.dense(lib, x, ws, outs, norm=norm, mod=mod if norm != "none" else None, **kw)
    else:
        amax = None if s_static is not None else ik.row_amax(lib, x)
        ik.dense(lib, x, ws, outs, amode=ik.STREAM, amax_in=amax, **kw)
    return outs


def fused_quant_dense(x: torch.Tensor, w: QuantizedWeight, *, norm: str = "none",
                      mod: Optional[torch.Tensor] = None, act: str = "none",
                      residual: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.bfloat16,
                      s_static: Optional[float] = None) -> torch.Tensor:
    """K6, one weight: x (M, K) -> [LN/AdaLN] -> quantize (per row, or static
    ``s_static``) -> int8 dot -> dequant + bias -> [GELU2] -> [+ residual] ->
    (M, N) ``out_dtype``. The CUDA kernel for a CUDA tensor (W8 weights, x
    bf16), ``quant_dense_reference`` for a CPU one."""
    _check_dense_args((w,), norm, mod, act, residual)
    kw = dict(norm=norm, mod=mod, act=act, residual=residual, out_dtype=out_dtype,
              s_static=s_static)
    if not ik.on_cuda(x, "fused_quant_dense"):
        return quant_dense_reference(x, w, **kw)
    (out,) = _dense_cuda(x, (w,), **kw)
    fused_quant_dense.launches += 1
    return out


def fused_quant_dense_multi(x: torch.Tensor, ws: Sequence[QuantizedWeight], *,
                            norm: str = "none", mod: Optional[torch.Tensor] = None,
                            act: str = "none", residual: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.bfloat16,
                            s_static: Optional[float] = None) -> Tuple[torch.Tensor, ...]:
    """K6, several weights sharing one prologue and quantize (the engine's
    q/k/v): a tuple of (M, N_i) outputs. On a CUDA tensor the weights must
    have one output width, and at most three."""
    ws = tuple(ws)
    _check_dense_args(ws, norm, mod, act, residual)
    kw = dict(norm=norm, mod=mod, act=act, residual=residual, out_dtype=out_dtype,
              s_static=s_static)
    if not ik.on_cuda(x, "fused_quant_dense_multi"):
        return quant_dense_multi_reference(x, ws, **kw)
    outs = _dense_cuda(x, ws, **kw)
    fused_quant_dense_multi.launches += 1
    return outs


fused_quant_dense.launches = 0
fused_quant_dense_multi.launches = 0
