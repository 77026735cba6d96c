"""Int8 / int4 weight quantization and the plain quantized dense (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/ops/quant.py``: ``QuantizedWeight``,
``quantize_weight`` (W8, per output channel amax/127), ``quantize_weight_w4``
(W4, amax/7, nibble-packed), ``unpack_weight_w4``, the shared prologue and
quantize helpers, the plain quantized dense ``quant_dense_reference`` (and
``quant_dense_multi_reference``, the same over several weights), and K6:
``fused_quant_dense`` / ``fused_quant_dense_multi``, wrappers that launch the
CUDA kernels of ``csrc/int8_block.cu`` for a CUDA tensor and run the plain
twin for a CPU one, each counting its calls in ``.launches``. The TPU
schedule options (``block_m``, ``interpret``) are not carried over.

On the card every int8 dot of the engine reads an int8 A that a quantize
pass wrote, and this module holds those pieces (``int8_block`` composes
them too): the row pass ``quantize_rows`` ([LN or AdaLN] -> quantize, rows
up to ``ROW_PASS_K`` wide) and the wide pass ``quantize_wide`` (no norm, any
width, the row's own max, given per-chunk maxima or a static scale), each
with its plain twin and its own ``.launches``, and ``_dense_int8``, the dot
launch in the Hopper GEMM's int8 A mode. K6 is a pass and one such dot
(``_dense_schedule``); on CPU tensors the same schedule runs from the plain
pieces and equals ``quant_dense_reference`` bit for bit.

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
           "fused_quant_dense", "fused_quant_dense_multi", "quantize_rows",
           "quantize_rows_reference", "quantize_wide", "quantize_wide_reference", "int_dot",
           "LN_EPS", "ROW_PASS_K"]

LN_EPS = 1e-6
# the row pass's widest row (``t2s_int8_limits(0)``: its rows live in registers)
ROW_PASS_K = 1024


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
# The quantize passes and the int8 A mode's dot, the pieces of every schedule
# ---------------------------------------------------------------------------

_NORMS = ("adaln", "ln")


def _mods(mod):
    mod = mod.float()
    return mod[0:1], mod[1:2]


def quantize_rows_reference(x, mod=None, *, static_s: Optional[float] = None,
                            norm: str = "adaln"):
    """Plain twin of the row pass: x (M, K) bf16 or f32 [-> ``norm`` ("adaln"
    or "ln") with ``mod`` (2, K)] -> (q (M, K) int8, the f32 (M,) row max |h|,
    or None under the static scale ``static_s``): the JAX kernels'
    ``_prologue(x, mod, norm)`` (or none) and ``_quant``."""
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    xf = x.float()
    h = xf if mod is None else _prologue(xf, *_mods(mod), norm)
    q, _ = _quant(h, static_s)
    return q, (h.abs().amax(dim=-1) if static_s is None else None)


def quantize_rows(x, mod=None, *, static_s: Optional[float] = None, norm: str = "adaln"):
    """The row pass (``quantize_rows_reference``): one launch on a CUDA
    tensor, K a multiple of 128 up to ``ROW_PASS_K``; bf16 rows with any
    norm, f32 rows with AdaLN (K8's cross half). Its int8 rows and row maxima
    are what the GEMM's panel held."""
    if norm not in _NORMS:
        raise ValueError(f"norm must be one of {_NORMS}, got {norm!r}")
    if not ik.on_cuda(x, "quantize_rows"):
        return quantize_rows_reference(x, mod, static_s=static_s, norm=norm)
    lib = ik.load_kernel()
    M, K = x.shape
    ik.check("x", x, (M, K), (torch.bfloat16, torch.float32), x.device)
    if K % 128 or K > lib.t2s_int8_limits(0):
        raise ValueError(f"width {K} must be a multiple of 128 and at most "
                         f"{lib.t2s_int8_limits(0)}")
    if mod is not None:
        ik.check("mod", mod, (2, K), torch.float32, x.device)
    if x.dtype == torch.float32 and (mod is None or norm != "adaln"):
        raise TypeError("the row pass takes f32 rows with AdaLN only, bf16 rows otherwise")
    out = ik.quant_rows(lib, x, mod, static_s, norm)
    quantize_rows.launches += 1
    return out


def quantize_wide_reference(x, *, static_s: Optional[float] = None,
                            amax: Optional[torch.Tensor] = None):
    """Plain twin of the wide pass: x (M, K) bf16 or f32, no norm -> (q (M, K)
    int8, the row maxima): ``_quantize_static`` under ``static_s`` (maxima
    None); with ``amax`` (M, nch) given, chunk c of the K / nch columns
    quantized as ``_quantize_rows`` would with max |h| = amax[:, c] (maxima:
    ``amax``); else ``_quantize_rows`` over the row (maxima (M,))."""
    xf = x.float()
    if static_s is not None:
        return _quantize_static(xf, static_s)[0], None
    if amax is None:
        return _quantize_rows(xf)[0], xf.abs().amax(dim=-1)
    M, K = xf.shape
    s = amax.clamp_min(1e-8) / 127.0                               # (M, nch)
    q = torch.round(xf.reshape(M, s.shape[1], -1) / s[..., None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(M, K), amax


def quantize_wide(x, *, static_s: Optional[float] = None, amax: Optional[torch.Tensor] = None):
    """The wide pass (``quantize_wide_reference``): one launch on a CUDA
    tensor, x (M, K) bf16 or f32, K a multiple of 4; ``amax`` (M, nch) f32,
    chunks of a multiple of 4 columns."""
    if not ik.on_cuda(x, "quantize_wide"):
        return quantize_wide_reference(x, static_s=static_s, amax=amax)
    lib = ik.load_kernel()
    M, K = x.shape
    ik.check("x", x, (M, K), (torch.bfloat16, torch.float32), x.device)
    if K % 4:
        raise ValueError(f"width {K} must be a multiple of 4")
    if amax is not None and static_s is None:
        nch = amax.shape[-1]
        ik.check("amax", amax, (M, nch), torch.float32, x.device)
        if K % nch or (K // nch) % 4:
            raise ValueError(f"width {K} in {nch} chunks: each a multiple of 4 wide")
    out = ik.quant_wide(lib, x, static_s, None if static_s is not None else amax)
    quantize_wide.launches += 1
    return out


def _row_scale(amax, s_static):
    """The dots' row scales: the static scale rounded to f32, or max(amax,
    1e-8) / 127 per row (and chunk) as ``_quantize_rows`` takes it, (M, nch)."""
    if amax is None:
        return float(np.float32(s_static))
    return amax.reshape(amax.shape[0], -1).clamp_min(1e-8) / 127.0


def _dense_int8_reference(qa, s, ws, w4: bool, residual=None, out_dtype=torch.bfloat16,
                          gelu: bool = False, n_chunks: Optional[int] = None):
    """Plain twin of ``_dense_int8`` given the row scales ``s`` (a float, or
    (M, 1) / (M, n_chunks) f32)."""
    outs = []
    for w in (unpack_weight_w4(w) if w4 else w for w in ws):
        if n_chunks is None:
            y = _deq(int_dot(qa, w.w_q), s, w)
            y = _gelu2(y) if gelu else y
            y = y if residual is None else y + residual.float()
        else:
            y, ck = residual.float(), qa.shape[1] // n_chunks
            for c in range(n_chunks):
                sl = slice(c * ck, (c + 1) * ck)
                sc = s if isinstance(s, float) else s[:, c:c + 1]
                y = y + int_dot(qa[:, sl], w.w_q[:, sl]) * (sc * w.scale)
            y = y + w.bias
        outs.append(y.to(out_dtype))
    return outs


def _dense_int8(qa, amax, ws, s_static, w4: bool, residual=None, out_dtype=torch.bfloat16,
                gelu: bool = False, n_chunks: Optional[int] = None):
    """The dots from a quantize pass's output, one per weight, s_row the
    static scale or max(amax, 1e-8) / 127 (``_quantize_rows``'s): acc *
    (s_row * scale) + bias [-> GELU2] [+ residual] -> ``out_dtype``; or, with
    ``n_chunks`` (K9's fc2; ``amax`` (M, n_chunks)), from the residual, +=
    acc_c * (s_c * scale) per chunk of K in order, then + bias. One launch of
    the Hopper GEMM's int8 A mode on the card (the weights share A); plain
    (``_dense_int8_reference``) on the CPU."""
    if not ik.on_cuda(qa, "the int8 dense"):
        return _dense_int8_reference(qa, _row_scale(amax, s_static), ws, w4, residual, out_dtype,
                                     gelu, n_chunks)
    # one allocation for all the weights' outputs: each costs host time
    outs = torch.empty((len(ws), qa.shape[0], ws[0].w_q.shape[0]), dtype=out_dtype,
                       device=qa.device).unbind(0)
    ik.dense(ik.load_kernel(), qa, ws, outs, amode=ik.INT8, s=s_static, amax_in=amax,
             residual=residual, w4=w4, gelu=gelu, nch=n_chunks or 1,
             epi=ik.EPI_STORE if n_chunks is None else ik.EPI_CHUNKED)
    return outs


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


def _dense_schedule(x, ws, *, norm, mod, act, residual, out_dtype, s_static):
    """K6 as two steps: the quantize pass (the row pass with the norm at K a
    multiple of 128 up to ``ROW_PASS_K``, else the wide pass, which takes no
    norm) -> one int8-A-mode dot launch that the weights share, [GELU2] [+
    residual] -> ``out_dtype``. Two launches on CUDA tensors; the plain
    pieces on CPU tensors, equal to ``quant_dense_multi_reference`` bit for
    bit."""
    K = x.shape[1]
    if norm == "none" and (K % 128 or K > ROW_PASS_K):
        qa, amax = quantize_wide(x, static_s=s_static)
    else:
        if norm != "none" and mod is None:   # AdaLN without a modulation, as the twin takes it
            mod = torch.zeros((2, K), dtype=torch.float32, device=x.device)
        qa, amax = quantize_rows(x, None if norm == "none" else mod, static_s=s_static,
                                 norm="adaln" if norm == "none" else norm)
    return tuple(_dense_int8(qa, amax, ws, s_static, False, residual=residual,
                             out_dtype=out_dtype, gelu=act == "gelu2"))


def _dense_cuda(x, ws, *, norm, mod, act, residual, out_dtype, s_static):
    """K6 on the card: ``_dense_schedule`` on checked tensors (x bf16, one to
    three W8 weights of one output width, a multiple of 128; K a multiple of
    128 up to ``ROW_PASS_K`` under a norm, any multiple of 64 without)."""
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
    row_k = lib.t2s_int8_limits(0)
    if (norm != "none" and (K % 128 or K > row_k)) or K % 64:
        raise ValueError(f"input width {K}: a normalised input must be a multiple of 128 and at "
                         f"most {row_k} wide, any input a multiple of 64")
    if norm != "none" and mod is not None:
        ik.check("mod", mod, (2, K), torch.float32, dev)
    if residual is not None:
        ik.check("residual", residual, (M, N), (torch.bfloat16, torch.float32), dev)
    return _dense_schedule(x, ws, norm=norm, mod=mod, act=act, residual=residual,
                           out_dtype=out_dtype, s_static=s_static)


def fused_quant_dense(x: torch.Tensor, w: QuantizedWeight, *, norm: str = "none",
                      mod: Optional[torch.Tensor] = None, act: str = "none",
                      residual: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.bfloat16,
                      s_static: Optional[float] = None) -> torch.Tensor:
    """K6, one weight: x (M, K) -> [LN/AdaLN] -> quantize (per row, or static
    ``s_static``) -> int8 dot -> dequant + bias -> [GELU2] -> [+ residual] ->
    (M, N) ``out_dtype``. The CUDA kernel for a CUDA tensor (W8 weights, x
    bf16): a quantize pass and one int8-A-mode dot (``_dense_schedule``);
    ``quant_dense_reference`` for a CPU one."""
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
quantize_rows.launches = 0
quantize_wide.launches = 0
