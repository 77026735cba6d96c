"""T3, the self-attention ablation probe's kernels (PyTorch port).

Port of ``tools/bench_attn_ablate.py`` (``make_variant``, ``make_variant2``,
``make_rows2``): K4 (AdaLN -> quantize -> q/k/v dots -> MHA -> quantize ->
proj -> + x) with one stage taken out or changed, picked by name. Each is a
compile-time configuration of K4's launches: the probe's own in
``csrc/int8_probe.cu``, those it shares with K4 in ``csrc/int8_block.cu``;
``attn_variant`` launches them for a CUDA tensor and runs the plain twin
``attn_variant_reference`` for a CPU one, counting its launches in
``.launches``. W8 weights, as the JAX tool runs them:

  qkvp_dots_only  y = bf16(q + k + v) from the f32 dequants (no MHA), then
                  the proj: K4's dots as they run, four launches (the AdaLN
                  quantize pass, the q/k/v dots writing f32, a wide quantize
                  pass summing the three planes, the proj + residual)
  no_softmax      p = bf16(s * 0.001), no key mask, every key
  no_av           each head's output is its softmax p of the first hd keys
  no_scores       every score of a row is the row's q[0], then the masked softmax
  pair            the pair-packed MHA (``pair_both``, ``rows*_pair``,
                  ``rows*_pairdeq``): K4 with ``attn="pair"``
  pair_nofold     its shared max, p divided by its head's sum before the
                  bf16 rounding

The MHAs other than ``pair`` are modes of the attention kernel that only
this probe launches (``PROBES``; their twin ``mha_probe_reference``); the
JAX tool's other names compute K4's own function (TPU schedules) and the
port's tool runs K4 for them (``tools/bench_attn_ablate.py``).
"""

from __future__ import annotations

import math

import torch

from . import int8_block as ib
from . import int8_kernels as ik
from .attention import _heads, _merge, check_pair, mha_pair_reference
from .quant import QuantizedWeight, _deq, _dense_int8, _prologue, _quant, int_dot, quantize_rows

__all__ = ["FUNCTIONS", "PROBES", "attn_variant", "attn_variant_reference", "mha_probe_reference"]

FUNCTIONS = ("qkvp_dots_only", "no_softmax", "no_av", "no_scores", "pair", "pair_nofold")
# the attention kernel's modes that only this probe launches (``int8_kernels.MHA_MODES``)
PROBES = ("pair_nofold", "no_softmax", "no_av", "no_scores")


def _check_variant(variant: str) -> None:
    if variant not in FUNCTIONS:
        raise ValueError(f"variant must be one of {FUNCTIONS}, got {variant!r}")


def mha_probe_reference(q, k, v, *, batch: int, n_head: int, kv_valid: int, probe: str):
    """The T3 probe's MHAs (``tools/bench_attn_ablate.py::make_variant``,
    ``make_variant2``), q's dtype in and out, scores as ``mha_reference``'s:
      "pair_nofold": ``mha_pair_reference(fold=False)``;
      "no_softmax": p = (s * 0.001) rounded, over every key, none masked;
      "no_av": the head's output is its rounded softmax p of the first hd
               keys (needs at least hd keys), no P V;
      "no_scores": every score of a row is the row's q[0] (its first column,
               unscaled), then the masked softmax and P V.
    JAX's ``no_scores`` broadcasts q[:, :1] onto the stacked scores of a head
    group, which only has the shape it needs at one head per group (it raises
    otherwise); this is what it computes there, at any head count."""
    if probe not in PROBES:
        raise ValueError(f"probe must be one of {PROBES}, got {probe!r}")
    if probe == "pair_nofold":
        return mha_pair_reference(q, k, v, batch=batch, n_head=n_head, kv_valid=kv_valid,
                                  fold=False)
    M, D = q.shape
    hd = D // n_head
    Lkv = k.shape[0] // batch
    vh = _heads(v, batch, n_head).float()
    if probe == "no_scores":
        s = q[:, :1].float().reshape(batch, 1, -1, 1).expand(batch, n_head, M // batch, Lkv)
    else:
        qh, kh = _heads(q, batch, n_head).float(), _heads(k, batch, n_head).float()
        s = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    if probe == "no_softmax":
        return _merge((s * 0.001).to(q.dtype).float() @ vh, q.dtype)
    s = s.masked_fill(torch.arange(Lkv, device=q.device) >= kv_valid, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    if probe == "no_av":
        if Lkv < hd:
            raise ValueError(f"no_av takes at least as many keys as the head width ({hd}), "
                             f"got {Lkv}")
        return _merge(p[..., :hd], q.dtype)
    return _merge(p.float() @ vh, q.dtype)


def attn_variant_reference(x, mod, wq, wk, wv, wproj, *, batch: int, n_head: int, q_valid: int,
                           variant: str, static_s=None) -> torch.Tensor:
    """The plain twin of T3's ``variant`` (module docstring): x (B*L, D)
    bf16, mod (2, D) f32, W8 weights -> (B*L, D) bf16; keys at or beyond
    ``q_valid`` masked. ``static_s``: (s_in, s_out) static scales."""
    _check_variant(variant)
    kw = dict(batch=batch, n_head=n_head)
    if variant == "pair":
        return ib.self_attn_block_reference(x, mod, wq, wk, wv, wproj, q_valid=q_valid,
                                            static_s=static_s, attn="pair", **kw)
    if variant in PROBES:
        mha = lambda q, k, v: mha_probe_reference(q, k, v, kv_valid=q_valid, probe=variant,
                                                  **kw).float()
        return ib._self_attn_twin(x, mod, wq, wk, wv, wproj, mha, static_s, False)
    s_in, s_out = ib._split(static_s)
    xf = x.float()
    q_, s = _quant(_prologue(xf, *ib._mods(mod), "adaln"), s_in)
    q, k, v = (_deq(int_dot(q_, w.w_q), s, w) for w in (wq, wk, wv))
    return (ib._ref_proj((q + k + v).bfloat16(), wproj, s_out) + xf).to(x.dtype)


def _check_probe_mha(variant: str, n_head: int, width: int, keys: int) -> None:
    """What the attention kernel's T3 modes take: heads of width 64 (pairs
    of them for the pair modes), and for ``no_av`` at least 64 keys."""
    hd = width // n_head
    if hd != 64:
        raise ValueError(f"the kernel runs T3's MHAs at a head width of 64, got {hd}")
    if variant in ("pair", "pair_nofold"):
        check_pair(n_head, width)
    if variant == "no_av" and keys < hd:
        raise ValueError(f"no_av takes at least {hd} keys, got {keys}")


def attn_variant(x, mod, wq: QuantizedWeight, wk: QuantizedWeight, wv: QuantizedWeight,
                 wproj: QuantizedWeight, *, batch: int, n_head: int, q_valid: int, variant: str,
                 static_s=None) -> torch.Tensor:
    """T3: ``variant`` of K4 (module docstring) -> (B*L, D) bf16. On a CUDA
    tensor K4's launches with the variant's configuration (W8 weights, a
    head width of 64, at most 272 keys; ``no_av`` at least 64), four for
    ``qkvp_dots_only`` and K4's five else; the plain twin on a CPU one."""
    _check_variant(variant)
    kw = dict(batch=batch, n_head=n_head, q_valid=q_valid, static_s=static_s)
    if not ik.on_cuda(x, "attn_variant"):
        return attn_variant_reference(x, mod, wq, wk, wv, wproj, variant=variant, **kw)
    lib = ik.load_kernel()
    L = x.shape[0] // batch
    ib._check_attn(x, 2, batch, n_head, lib, mod, L, q_valid, "q_valid")
    D = x.shape[1]
    ib._check_weights(("wq", "wk", "wv", "wproj"), (wq, wk, wv, wproj), D, D, False, x.device)
    s_in, s_out = ib._split(static_s)
    probe = ik.load_probe_kernel()
    if variant == "qkvp_dots_only":
        qx, ax = quantize_rows(x, mod, static_s=s_in)
        qkv = torch.empty((3,) + tuple(x.shape), dtype=torch.float32, device=x.device)
        ik.dense(lib, qx, (wq, wk, wv), tuple(qkv), amode=ik.INT8, s=s_in, amax_in=ax)
        qy, ay = ik.quant_wide(probe, qkv, s_out)   # bf16((q + k) + v), quantized
        out = _dense_int8(qy, ay, (wproj,), s_out, False, residual=x)[0]
    else:
        _check_probe_mha(variant, n_head, D, L)
        mha_lib = probe if variant in PROBES else lib   # "pair" is the engine's own MHA
        mha = lambda q, k, v: ik.mha(mha_lib, q, k, v, batch, n_head, q_valid, mode=variant)
        out = ib._attn_half(x, mod, (wq, wk, wv), wproj, s_in, s_out, x.dtype, False, mha)
    attn_variant.launches += 1
    return out


attn_variant.launches = 0
