"""Static activation-scale calibration for the int8 serving engine (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/diffusion/calibrate.py``. Run the
sampler the dynamic engine serves (all-MASK start, the full timestep plan,
the serving top-r truncation) on representative conditioning, record max |h|
at each of the six quantize sites of every layer over every step, row and
batch element, and turn them into static per-tensor scales amax * margin /
127. The engine then quantizes with those scales and no abs-max pass.

As in the JAX package this is a plain forward of the dynamic engine (no
kernel): a one-off engine build outside the request. Its math mirrors the JAX
calibration pass, including its attention (scores rounded to bf16 before the
f32 softmax) and its bf16 logits; the sampler noise comes from ``generator``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ...ops import fused_sampler as fs
from ...ops.quant import _gelu2, _prologue, _quantize_rows, int_dot
from .int8_runtime import Int8Denoiser, precompute_cond_kvs, unpack_denoiser

__all__ = ["calibrate_act_scales", "N_SITES"]

# per-layer quantize sites, in order:
#   attn_in, attn_out, cross_in, cross_out, mlp_in, mlp_mid
N_SITES = 6


def _dense(q, s, w):
    return int_dot(q, w.w_q) * (s * w.scale) + w.bias


def _attend(q, k, v, n_head: int):
    """bf16 MHA with the f32 softmax of the JAX calibration pass: (B, L, D)
    queries, (B, S, D) keys/values; the scores are rounded to bf16 (a bf16
    matmul), divided by sqrt(hd) in bf16, and softmaxed in f32."""
    B, L, D = q.shape
    hd = D // n_head

    def heads(a):
        return a.reshape(a.shape[0], a.shape[1], n_head, hd).transpose(1, 2)

    att = (heads(q).float() @ heads(k).float().transpose(-1, -2)).bfloat16()
    att = att / torch.tensor(math.sqrt(hd), dtype=torch.bfloat16, device=q.device)
    att = torch.softmax(att.float(), dim=-1).bfloat16()
    o = (att.float() @ heads(v).float()).bfloat16()
    return o.transpose(1, 2).reshape(B, L, D)


@torch.no_grad()
def _backbone_amax(qp: Int8Denoiser, tokens: torch.Tensor, t: int, cond_kvs):
    """Dynamic-int8 backbone forward that also returns the per-site max |h|.
    ``cond_kvs``: per-layer (B*S, D) K/V from ``precompute_cond_kvs``.
    Returns (logits (B, L, K-1) bf16, amax (n_layer, N_SITES) f32)."""
    B, L = tokens.shape
    D = qp.tok_emb.shape[-1]
    H = qp.n_head
    x = (qp.tok_emb[tokens.clamp(min=0).long()] + qp.pos_emb[None, :L]).reshape(B * L, D).float()

    def bf16(y):
        return y.bfloat16().float()

    amax = []
    for lyr, (ck, cv) in zip(qp.layers, cond_kvs):
        mod1 = lyr.ada1[t].reshape(2, D)
        mod2 = lyr.ada2[t].reshape(2, D)
        site = []

        h = _prologue(x, mod1[0:1], mod1[1:2], "adaln")
        site.append(h.abs().max())
        q_, s = _quantize_rows(h)
        qh, kh, vh = (_dense(q_, s, w.qw).bfloat16().reshape(B, L, D)
                      for w in (lyr.q, lyr.k, lyr.v))
        y = bf16(_attend(qh, kh, vh, H).reshape(B * L, D))
        site.append(y.abs().max())
        qy, sy = _quantize_rows(y)
        x = bf16(_dense(qy, sy, lyr.proj.qw) + x)

        h2 = _prologue(x, mod2[0:1], mod2[1:2], "adaln")
        site.append(h2.abs().max())
        q2_, s2 = _quantize_rows(h2)
        q2 = _dense(q2_, s2, lyr.crossq.qw).bfloat16().reshape(B, L, D)
        y2 = bf16(_attend(q2, ck.reshape(B, -1, D), cv.reshape(B, -1, D), H).reshape(B * L, D))
        site.append(y2.abs().max())
        qy2, sy2 = _quantize_rows(y2)
        x = bf16(_dense(qy2, sy2, lyr.crossproj.qw) + x)

        h3 = _prologue(x, lyr.ln2_mod[0:1], lyr.ln2_mod[1:2], "ln")
        site.append(h3.abs().max())
        q3, s3 = _quantize_rows(h3)
        u = _gelu2(_dense(q3, s3, lyr.fc1.qw))
        site.append(u.abs().max())
        qu, su = _quantize_rows(u)
        x = bf16(_dense(qu, su, lyr.fc2.qw) + x)
        amax.append(torch.stack(site))

    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + 1e-6)
    xn = xn * qp.norm_out[0] + qp.norm_out[1]
    logits = xn.bfloat16() @ qp.head_w + qp.head_b.bfloat16()
    return logits.reshape(B, L, -1), torch.stack(amax)


@torch.no_grad()
def calibrate_act_scales(
    qp: Int8Denoiser,
    sched,
    cond_emb: torch.Tensor,           # (B, S, Dc) calibration conditioning
    *,
    generator: torch.Generator,
    truncation_r: float = 0.0,
    skip_step: int = 0,
    margin: float = 1.0,
) -> Tuple[Tuple[float, ...], ...]:
    """Run the dynamic sampler on ``cond_emb``, recording per-site amax; return
    per-layer 6-tuples of static scales (amax * margin / 127) for
    ``Int8Denoiser.act_scales``. A W4 engine is calibrated on its unpacked
    twin (the same values)."""
    from .process import _timestep_plan

    qp = unpack_denoiser(qp)
    K, T, L = qp.tok_emb.shape[0], qp.num_timesteps, qp.seq_len
    B = cond_emb.shape[0]
    ts, t_post = _timestep_plan(T, T, skip_step)
    coeffs = fs.step_coeffs(sched, t_post).as_array()
    kvs = precompute_cond_kvs(qp, cond_emb)
    tokens = torch.full((B, L), K - 1, dtype=torch.int32, device=cond_emb.device)
    amax = torch.zeros((len(qp.layers), N_SITES), dtype=torch.float32, device=cond_emb.device)
    for i, t in enumerate(ts):
        logits, site_amax = _backbone_amax(qp, tokens, t, kvs)
        amax = torch.maximum(amax, site_amax)
        tokens = fs.p_sample_from_indices(logits, tokens, coeffs[i], generator=generator,
                                          truncation_r=truncation_r)
    scales = amax.clamp_min(1e-6) * (margin / 127.0)
    return tuple(tuple(float(s) for s in row) for row in scales.cpu())
