"""T2, the MLP ablation probe's kernels (PyTorch port).

Port of ``tools/bench_mlp_ablate.py::make_variant``: K3 (LN -> quantize ->
fc1 -> GELU2 -> quantize -> fc2 -> + x) with one stage taken out or changed,
picked by name. Each is a compile-time configuration of K3's launches (fc1
on the LN panel, [the wide quantize pass], fc2 in the int8 A mode): the
probe's own in ``csrc/int8_probe.cu``, those it shares with K3 in
``csrc/int8_block.cu``; ``mlp_variant`` launches them for a CUDA tensor and
runs the plain twin ``mlp_variant_reference`` for a CPU one, counting its launches in
``.launches``. W8 weights, dynamic scales, as the JAX tool runs them. Each
twin copies its JAX kernel's numerics step by step:

  dots_only     qx = int8(x) (truncated, saturated, as XLA converts); the
                int32 fc1 sums wrapped to int8; fc2; its int32 sums to bf16.
                No scale, bias, GELU or residual.
  no_prologue   h = x (no LayerNorm)
  ln_onepass    LayerNorm with the variance as E[x^2] - E[x]^2
  no_gelu       GELU2 left out
  no_quant_mid  qu = int8(clip(u, +-127)) (truncated), su = the input's row scale
  no_deq_mid    qu = clip(acc1 >> 7, +-127), su = the input's row scale; no
                bias, no GELU
  mid_bf16      the middle in bf16 steps: dequant, GELU2 (sigmoid of
                bf16(1.702 u)), the row max floored at 1e-6, su and u / su
  mid_bf16b     as mid_bf16 up to u; su = max(amax, 1e-6) / 127 and u / su in f32
  mid_bf16c     as mid_bf16b, the sigmoid as 1 / (1 + exp(-1.702 u)), each op bf16
  fast_sigmoid  the sigmoid as 0.5 + 0.5 z / (1 + |z|), z = 1.702 u

The JAX tool's other names compute K3's or K9's own function (schedule
choices of the TPU) or K3's on other weight bytes (``make_w4``: ``pack_w16``
below, then K3's W4 path); the port's tool runs those on K3 and K9
(``tools/bench_mlp_ablate.py``).
"""

from __future__ import annotations

import torch

from . import int8_kernels as ik
from .int8_block import _check_mlp
from .quant import (QuantizedWeight, _deq, _dense_int8, _gelu2, _prologue, _quantize_rows, int_dot,
                    quantize_wide)

__all__ = ["FUNCTIONS", "mlp_variant", "mlp_variant_reference", "pack_w16", "cast_int8",
           "wrap_int8"]

FUNCTIONS = ("dots_only", "no_prologue", "ln_onepass", "no_gelu", "no_quant_mid", "no_deq_mid",
             "mid_bf16", "mid_bf16b", "mid_bf16c", "fast_sigmoid")
_BF = torch.bfloat16


def _check_variant(variant: str) -> None:
    if variant not in FUNCTIONS:
        raise ValueError(f"variant must be one of {FUNCTIONS}, got {variant!r}")


def cast_int8(t: torch.Tensor) -> torch.Tensor:
    """float -> int8 as XLA converts: truncated toward zero, saturated to
    [-128, 127], NaN to 0."""
    t = t.float()
    return torch.where(torch.isnan(t), 0.0, t.trunc().clamp(-128, 127)).to(torch.int8)


def wrap_int8(acc: torch.Tensor) -> torch.Tensor:
    """integers -> int8 as XLA converts int32: the low byte, two's complement."""
    return (((acc.to(torch.int64) & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


def _sums(q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of q (M, K) int8 . w_q (N, K) int8, as int64."""
    return (q.double() @ w_q.double().T).to(torch.int64)


def pack_w16(w: QuantizedWeight) -> QuantizedWeight:
    """``make_w4``'s packing of a W8 weight (N, K): round(w / 16) clipped to
    +-7, nibble-packed as the engine's W4 (byte [n, k] holds column k low and
    k + K/2 high), the W8 scale and bias kept."""
    w4 = torch.round(w.w_q.float() / 16.0).clamp(-7, 7).to(torch.int32)
    K = w4.shape[1]
    lo, hi = w4[:, :K // 2], w4[:, K // 2:]
    return QuantizedWeight(((hi << 4) | (lo & 0xF)).to(torch.int8), w.scale, w.bias)


def _gelu2_bf16(u: torch.Tensor, sig_c: bool) -> torch.Tensor:
    """GELU2 of a bf16 u, every op rounded to bf16 (1.702 is 1.703125 there)."""
    if sig_c:
        one = torch.tensor(1.0, dtype=_BF)
        return u * (one / (one + torch.exp(torch.tensor(-1.702, dtype=_BF) * u)))
    return u * torch.sigmoid(torch.tensor(1.702, dtype=_BF) * u)


def mlp_variant_reference(x, mod, w1: QuantizedWeight, w2: QuantizedWeight, *,
                          variant: str) -> torch.Tensor:
    """The plain twin of T2's ``variant`` (module docstring): x (M, D) bf16,
    mod (2, D) f32 = LayerNorm gamma; beta, W8 weights -> (M, D) bf16."""
    _check_variant(variant)
    xf = x.float()
    if variant == "dots_only":
        qu = wrap_int8(_sums(cast_int8(xf), w1.w_q))
        return _sums(qu, w2.w_q).float().to(x.dtype)
    mod = mod.float()
    if variant == "no_prologue":
        h = xf
    elif variant == "ln_onepass":
        mean = xf.sum(-1, keepdim=True) / xf.shape[-1]
        var = (xf * xf).sum(-1, keepdim=True) / xf.shape[-1] - mean * mean
        h = (xf - mean) * torch.rsqrt(var + 1e-6) * mod[0:1] + mod[1:2]
    else:
        h = _prologue(xf, mod[0:1], mod[1:2], "ln")
    qx, s = _quantize_rows(h)
    acc1 = int_dot(qx, w1.w_q)
    if variant.startswith("mid_bf16"):
        u = acc1.to(_BF) * (s.to(_BF) * w1.scale.to(_BF)) + w1.bias.to(_BF)
        u = _gelu2_bf16(u, variant == "mid_bf16c")
        amax = u.abs().amax(dim=-1, keepdim=True)
        if variant == "mid_bf16":
            su = torch.maximum(amax, torch.tensor(1e-6, dtype=_BF)) / 127.0
            qu = torch.round(u / su).clamp(-127, 127).to(torch.int8)
        else:
            su = amax.float().clamp_min(1e-6) / 127.0
            qu = torch.round(u.float() / su).clamp(-127, 127).to(torch.int8)
        su = su.float()
    elif variant == "no_deq_mid":
        qu, su = (_sums(qx, w1.w_q) >> 7).clamp(-127, 127).to(torch.int8), s
    else:
        u = _deq(acc1, s, w1)
        if variant == "fast_sigmoid":
            z = 1.702 * u
            u = u * (0.5 + 0.5 * z / (1.0 + z.abs()))
        elif variant != "no_gelu":
            u = _gelu2(u)
        if variant == "no_quant_mid":
            qu, su = cast_int8(u.clamp(-127, 127)), s
        else:
            qu, su = _quantize_rows(u)
    return (_deq(int_dot(qu, w2.w_q), su, w2) + xf).to(x.dtype)


# variant -> (fc1's panel input, fc1's epilogue, fc1's flags, fc1 writes f32)
_FC1 = {"dots_only": ("cast", ik.EPI_WRAP8, 0, False),
        "no_prologue": ("none", ik.EPI_STORE, 0, True),
        "ln_onepass": ("ln_onepass", ik.EPI_STORE, 0, True),
        "no_gelu": ("ln", ik.EPI_STORE, 0, True),
        "no_quant_mid": ("ln", ik.EPI_CLIP8, 0, False),
        "no_deq_mid": ("ln", ik.EPI_SHIFT8, 0, False),
        "mid_bf16": ("ln", ik.EPI_STORE, ik.EF_MID_BF16, False),
        "mid_bf16b": ("ln", ik.EPI_STORE, ik.EF_MID_BF16, False),
        "mid_bf16c": ("ln", ik.EPI_STORE, ik.EF_MID_BF16 | ik.EF_SIG_C, False),
        "fast_sigmoid": ("ln", ik.EPI_STORE, ik.EF_FAST_SIG, True)}
# the floor of the middle's row max: 1e-6, in bf16 for mid_bf16
_FLOOR = {"mid_bf16": float(torch.tensor(1e-6, dtype=_BF)), "mid_bf16b": 1e-6, "mid_bf16c": 1e-6}


def _launch(lib, plib, x, mod, w1, w2, variant: str):
    """fc1, then fc2 (two launches of ``t2s_int8_dense``), with the wide
    quantize pass between them where the middle is f32 or bf16 (three): of
    the probe library (``plib``) where the configuration is the probe's, else
    of the engine's (``lib``)."""
    M = x.shape[0]
    Dh = w1.w_q.shape[0]
    dev = x.device
    norm, epi, flags, mid32 = _FC1[variant]
    out = torch.empty_like(x)
    if epi != ik.EPI_STORE:   # an int8 middle
        u = torch.empty((M, Dh), dtype=torch.int8, device=dev)
        keep = None if variant == "dots_only" else torch.empty((M,), dtype=torch.float32, device=dev)
        ik.dense(plib, x, (w1,), (u,), norm=norm, mod=None if norm == "cast" else mod, epi=epi,
                 gelu=variant == "no_quant_mid", amax_out=keep)
        if variant == "dots_only":   # int32 sums -> bf16, no scale: the raw epilogue
            ik.dense(plib, u, (w2,), (out,), amode=ik.INT8, epi=ik.EPI_RAW, s=1.0,
                     probe=ik.EF_RAW_BF16)
        else:                        # dequant with the input's row scale + x
            ik.dense(lib, u, (w2,), (out,), amode=ik.INT8, amax_in=keep, residual=x)
        return out
    u = torch.empty((M, Dh), dtype=torch.float32 if mid32 else torch.bfloat16, device=dev)
    amax = torch.empty((M, 1), dtype=torch.float32, device=dev)
    ik.dense(plib, x, (w1,), (u,), norm=norm, mod=None if norm == "none" else mod,
             gelu=variant != "no_gelu", amax_out=amax, probe=flags,
             amax_floor=_FLOOR.get(variant, 0.0))
    if variant == "mid_bf16":   # the probe's bf16 quantize and row scale
        qu, _ = ik.quant_wide(plib, u, None, amax, qbf=True)
        ik.dense(plib, qu, (w2,), (out,), amode=ik.INT8, amax_in=amax, residual=x,
                 probe=ik.EF_Q_BF16)
        return out
    qu, _ = quantize_wide(u, amax=amax)   # the others: K3's dynamic fc2
    return _dense_int8(qu, amax, (w2,), None, False, residual=x)[0]


def mlp_variant(x, mod, w1: QuantizedWeight, w2: QuantizedWeight, *, variant: str) -> torch.Tensor:
    """T2: ``variant`` of K3 (module docstring), x (M, D) bf16 -> (M, D) bf16.
    Two or three launches on a CUDA tensor (W8 weights, the width and hidden
    width as K3 takes them); the plain twin on a CPU one."""
    _check_variant(variant)
    if not ik.on_cuda(x, "mlp_variant"):
        return mlp_variant_reference(x, mod, w1, w2, variant=variant)
    lib = ik.load_kernel()
    _check_mlp(x, mod, w1, w2, False, lib)
    out = _launch(lib, ik.load_probe_kernel(), x, mod, w1, w2, variant)
    mlp_variant.launches += 1
    return out


mlp_variant.launches = 0
