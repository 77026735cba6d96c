"""Int8 (W8A8 / W4A8) serving engine for the Diffsound denoiser (PyTorch port).

Port of ``text_to_sound_synthesis_tpu/models/diffusion/int8_runtime.py``: the
quantized-inference engine of the flagship ``Text2SpecTransformer``. Each
sampler step ends in the fused LN + head + sampler kernel
(``ops/fused_sampler.py::fused_head_sample``, K2). The layers run on one of
two kernel paths, chosen by ``impl`` as in the JAX engine:

- ``"pallas"`` (the default), the block kernels of ``ops/int8_block.py``:
  K4 self-attention -> K5 cross-attention -> K3 MLP per layer. The JAX
  engine's kernel-selecting switches are read at each backbone call, as the
  JAX engine reads them: ``T2S_ATTN_PAIR=1`` runs K4 and K5 as one K8
  (``attn_pair_block``); ``T2S_MLP_IMPL=chunked`` or ``streamed`` runs the
  MLP as K9 (``mlp_block_chunked`` / ``mlp_block_streamed``) with
  ``T2S_MLP_CHUNKS`` chunks (default 4 or 16); any other value is K3. A W4
  engine always runs K4, K5 and K3, as in JAX. The blocks' MHA (``attn``)
  follows the JAX engine's ``_mha``: ``T2S_ATTN_INT8=1`` runs K10, the int8
  MHA, inside K8, and inside K4 and K5 when ``T2S_ATTN_MHA`` is ``"base"``;
  else ``T2S_SOFTMAX_FOLD_DIV=1`` runs the bf16 MHA with its softmax divide
  folded into the output, at the same places; else the bf16 MHA.
  ``T2S_ATTN_MHA`` defaults, as in JAX, to ``"pair"`` when two heads fill
  128 lanes (an even head count of width 64), else ``"base"``. In pair mode
  K4 and K5 run the pair-packed MHA (``attn="pair"``: one row max shared by
  two heads, the divide after P V), whatever the other two switches say, as
  JAX's pair kernels do; K8 keeps ``_mha``'s choice.
- ``"pallas_dense"``, the per-dense path: six K6 denses
  (``ops/quant.py::fused_quant_dense_multi``) and two K7 attentions
  (``ops/attention.py::fused_mha``) per layer. A W4 engine is unpacked
  first, once per generation in ``sample_tokens_int8``.

Weights are symmetric per output channel, int8 or nibble-packed int4
(``weight_bits=4``); activations per-row dynamic, or static per-tensor once
``act_scales`` holds calibrated scales (``calibrate.py``).

Differences from the JAX engine, on purpose:
- the kernels take the unpadded sequence (no ``L_pad``), and the TPU
  schedule choices have no counterpart: ``_pad_plan``'s ``block_m``,
  ``rows_per_program``, and the schedule-only switches
  ``T2S_MLP_BM``, ``T2S_ATTN_ROWS``, ``T2S_MLP_PIPE``, ``T2S_SPLIT_CALLS``,
  ``T2S_HEAD_GROUP``, ``T2S_VMEM_LIMIT_MB`` and ``T2S_PAR_SEMANTICS``. Unpadded,
  K10's V scale is the column max over the keys of each batch element; the
  TPU engine's self-attention programs also hold the pad rows up to
  ``L_pad`` there;
- the switches are read at each backbone call (the JAX package reads
  ``T2S_ATTN_INT8`` and ``T2S_SOFTMAX_FOLD_DIV`` once, at import);
- the condition's K/V are kept flat, (B*S, D) per layer, as the kernels read
  them;
- JAX's non-kernel ``impl`` values (``"xla"``, ``"reference"``) have no
  counterpart: every kernel wrapper runs its plain twin for CPU tensors;
- logits are f32 on every path, as the fused tail computes them (the JAX
  engine's non-kernel path rounds them to bf16).
``sample_tokens_int8_sharded`` waits for the multi-GPU work.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ...ops import attention as attn
from ...ops import fused_sampler as fs
from ...ops import int8_block as ib
from ...ops import quant
from ...ops.quant import QuantizedWeight, quantize_weight, quantize_weight_w4, unpack_weight_w4

__all__ = ["Int8Dense", "Int8Layer", "Int8Denoiser", "quantize_denoiser", "unpack_denoiser",
           "precompute_cond_kvs", "int8_backbone_logits", "sample_tokens_int8"]

DENSE_FIELDS = ("q", "k", "v", "proj", "crossq", "crossproj", "fc1", "fc2")
ActScales = Optional[Tuple[Tuple[float, ...], ...]]


def _own(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A buffer of its own: detached from any parameter it came from."""
    return t.detach().to(dtype).contiguous().clone()


class Int8Dense(nn.Module):
    """Buffers of one quantized dense: ``w_q`` (N, K) int8 or (N, K/2) packed
    W4, ``scale`` and ``bias`` (N,) f32."""

    def __init__(self, w: QuantizedWeight):
        super().__init__()
        self.register_buffer("w_q", _own(w.w_q, torch.int8))
        self.register_buffer("scale", _own(w.scale, torch.float32))
        self.register_buffer("bias", _own(w.bias, torch.float32))

    @property
    def qw(self) -> QuantizedWeight:
        return QuantizedWeight(self.w_q, self.scale, self.bias)


class Int8Layer(nn.Module):
    """One SelfCrossBlock's engine: eight quantized denses and the f32/bf16
    tensors the blocks read around them."""

    def __init__(self, *, q, k, v, proj, crossq, crossproj, fc1, fc2,
                 ln2_mod, ada1, ada2, ck_w, ck_b, cv_w, cv_b):
        super().__init__()
        for name, w in zip(DENSE_FIELDS, (q, k, v, proj, crossq, crossproj, fc1, fc2)):
            setattr(self, name, Int8Dense(w))
        self.register_buffer("ln2_mod", _own(ln2_mod, torch.float32))   # (2, D) gamma; beta
        self.register_buffer("ada1", _own(ada1, torch.float32))         # (T, 2D) ln1 table
        self.register_buffer("ada2", _own(ada2, torch.float32))         # (T, 2D) ln1_1 table
        self.register_buffer("ck_w", _own(ck_w, torch.bfloat16))      # (Dc, D) cross key
        self.register_buffer("ck_b", _own(ck_b, torch.float32))         # (D,)
        self.register_buffer("cv_w", _own(cv_w, torch.bfloat16))      # (Dc, D) cross value
        self.register_buffer("cv_b", _own(cv_b, torch.float32))         # (D,)


class Int8Denoiser(nn.Module):
    """The engine: per-layer ``Int8Layer``s plus the embedding and the head.
    ``n_head``, ``seq_len``, ``num_timesteps``, ``act_scales`` (per-layer
    6-tuples of floats: attn_in, attn_out, cross_in, cross_out, mlp_in,
    mlp_mid; None = dynamic) and ``weight_bits`` (8 or 4) are plain
    attributes."""

    def __init__(self, layers: Sequence[Int8Layer], *, tok_emb, pos_emb, norm_out, head_w,
                 head_b, n_head: int, seq_len: int, num_timesteps: int,
                 act_scales: ActScales = None, weight_bits: int = 8):
        super().__init__()
        if weight_bits not in (8, 4):
            raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
        self.layers = nn.ModuleList(layers)
        self.register_buffer("tok_emb", _own(tok_emb, torch.bfloat16))    # (K, D)
        self.register_buffer("pos_emb", _own(pos_emb, torch.bfloat16))    # (L, D)
        self.register_buffer("norm_out", _own(norm_out, torch.float32))     # (2, D)
        self.register_buffer("head_w", _own(head_w, torch.bfloat16))      # (D, K-1)
        self.register_buffer("head_b", _own(head_b, torch.float32))         # (K-1,)
        self.n_head, self.seq_len, self.num_timesteps = n_head, seq_len, num_timesteps
        self.act_scales = act_scales
        self.weight_bits = weight_bits

    def _fields(self) -> dict:
        return dict(tok_emb=self.tok_emb, pos_emb=self.pos_emb, norm_out=self.norm_out,
                    head_w=self.head_w, head_b=self.head_b, n_head=self.n_head,
                    seq_len=self.seq_len, num_timesteps=self.num_timesteps,
                    act_scales=self.act_scales, weight_bits=self.weight_bits)


def _ada_table(ln: nn.Module, num_steps: int) -> torch.Tensor:
    """All-timestep AdaLN modulation linear(silu(emb(t))) in f32, (T, 2D)."""
    emb = ln.emb(torch.arange(num_steps, device=ln.linear.weight.device)).float()
    return nn.functional.silu(emb) @ ln.linear.weight.float().T + ln.linear.bias.float()


def quantize_denoiser(model: nn.Module, *, n_head: int, seq_len: int, num_timesteps: int,
                      weight_bits: int = 8) -> Int8Denoiser:
    """The port's ``DiscreteDiffusion`` (or its ``Text2SpecTransformer``) ->
    the int8 engine, on the model's device. ``weight_bits=4`` stores the eight
    dense weights of each layer nibble-packed (W4A8)."""
    if weight_bits not in (8, 4):
        raise ValueError(f"weight_bits must be 8 or 4, got {weight_bits}")
    tr = model.transformer if hasattr(model, "diffusion_step") else model
    quant = quantize_weight if weight_bits == 8 else quantize_weight_w4

    def qw(lin: nn.Linear) -> QuantizedWeight:
        return quant(lin.weight.float(), lin.bias.float())

    with torch.no_grad():
        layers = []
        for b in tr.blocks:
            layers.append(Int8Layer(
                q=qw(b.attn1.query), k=qw(b.attn1.key), v=qw(b.attn1.value),
                proj=qw(b.attn1.proj), crossq=qw(b.attn2.query), crossproj=qw(b.attn2.proj),
                fc1=qw(b.mlp[0]), fc2=qw(b.mlp[2]),
                ln2_mod=torch.stack([b.ln2.weight, b.ln2.bias]).float(),
                ada1=_ada_table(b.ln1, num_timesteps), ada2=_ada_table(b.ln1_1, num_timesteps),
                ck_w=b.attn2.key.weight.T, ck_b=b.attn2.key.bias,
                cv_w=b.attn2.value.weight.T, cv_b=b.attn2.value.bias))
        emb = tr.content_emb
        D = emb.emb.weight.shape[-1]
        pos = (emb.height_emb.weight.float()[:, None, :]
               + emb.width_emb.weight.float()[None, :, :]).reshape(-1, D)
        head = tr.to_logits
        return Int8Denoiser(
            layers, tok_emb=emb.emb.weight, pos_emb=pos[:seq_len],
            norm_out=torch.stack([head[0].weight, head[0].bias]).float(),
            head_w=head[1].weight.T, head_b=head[1].bias, n_head=n_head, seq_len=seq_len,
            num_timesteps=num_timesteps, weight_bits=weight_bits)


def unpack_denoiser(qp: Int8Denoiser) -> Int8Denoiser:
    """W4 engine -> int8 engine with the same values (the plain twin of the
    kernels' in-register unpack); an int8 engine is returned as it is."""
    if qp.weight_bits == 8:
        return qp
    layers = []
    for lyr in qp.layers:
        dense = {f: unpack_weight_w4(getattr(lyr, f).qw) for f in DENSE_FIELDS}
        rest = {n: getattr(lyr, n) for n in ("ln2_mod", "ada1", "ada2", "ck_w", "ck_b",
                                             "cv_w", "cv_b")}
        layers.append(Int8Layer(**dense, **rest))
    return Int8Denoiser(layers, **{**qp._fields(), "weight_bits": 8})


def precompute_cond_kvs(qp: Int8Denoiser, cond_emb: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(B, S, Dc) condition -> per-layer cross-attention K/V, flat (B*S, D)
    bf16 (a plain bf16 matmul: bf16 output, bf16 bias add)."""
    cond = cond_emb.bfloat16()
    B, S, _ = cond.shape
    out = []
    for lyr in qp.layers:
        k = cond @ lyr.ck_w + lyr.ck_b.bfloat16()
        v = cond @ lyr.cv_w + lyr.cv_b.bfloat16()
        out.append((k.reshape(B * S, -1).contiguous(), v.reshape(B * S, -1).contiguous()))
    return out


def _embed(qp: Int8Denoiser, tokens: torch.Tensor) -> torch.Tensor:
    B, L = tokens.shape
    x = qp.tok_emb[tokens.clamp(min=0).long()] + qp.pos_emb[None, :L]   # bf16 sum
    return x.reshape(B * L, -1)


def _layer_mods(qp: Int8Denoiser, t: int):
    D = qp.tok_emb.shape[-1]
    return [(lyr.ada1[t].reshape(2, D), lyr.ada2[t].reshape(2, D)) for lyr in qp.layers]


def _pair(s):
    """A layer's static scales of one block ((in, out), or the four of the
    attention pair), or None for dynamic quantization."""
    return None if s[0] is None else tuple(float(v) for v in s)


IMPLS = ("pallas", "pallas_dense")


def _check_impl(impl: Optional[str]) -> str:
    impl = "pallas" if impl is None else impl
    if impl in ("xla", "reference"):
        raise ValueError(f"impl={impl!r} is a non-kernel path of the JAX engine; the port has "
                         "no counterpart (on a CPU tensor every kernel wrapper runs its plain "
                         f"twin). Use one of {IMPLS}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


class Switches(NamedTuple):
    pair: bool          # K8 in place of K4 + K5
    mlp_impl: str       # "chunked", "streamed" (K9) or anything else (K3)
    n_chunks: int
    attn: str           # the MHA of K4 and K5 (int8_block.ATTN)
    pair_attn: str      # the MHA of K8


def _block_switches(w4: bool, n_head: int, head_dim: int) -> Switches:
    """The JAX engine's kernel-selecting switches, read now; a W4 engine runs
    the base blocks. The MHA follows JAX's ``_mha``: K8 always reaches it,
    K4 and K5 only in ``T2S_ATTN_MHA`` mode "base"; in mode "pair" they run
    the pair-packed MHA."""
    mlp_impl = os.environ.get("T2S_MLP_IMPL", "base")
    if w4:
        mlp_impl = "base"
    n_chunks = int(os.environ.get("T2S_MLP_CHUNKS", "16" if mlp_impl == "streamed" else "4"))
    pair = os.environ.get("T2S_ATTN_PAIR", "0") == "1" and not w4
    mode = os.environ.get("T2S_ATTN_MHA",
                          "pair" if n_head % 2 == 0 and 2 * head_dim == 128 else "base")
    if mode not in ("base", "pair"):
        raise ValueError(f"T2S_ATTN_MHA must be 'base' or 'pair', got {mode!r}")
    mha = ("int8" if os.environ.get("T2S_ATTN_INT8", "0") == "1"
           else "bf16_fold" if os.environ.get("T2S_SOFTMAX_FOLD_DIV", "0") == "1" else "bf16")
    return Switches(pair, mlp_impl, n_chunks, mha if mode == "base" else "pair", mha)


def _blocks(qp: Int8Denoiser, x, cond_kvs, mods, act_s, B: int, L: int, S: int):
    """impl="pallas": per layer K4 -> K5 (or K8) -> K3 (or K9)."""
    H = qp.n_head
    w4 = qp.weight_bits == 4
    sw = _block_switches(w4, H, x.shape[1] // H)
    for lyr, (ck, cv), (mod1, mod2), ls in zip(qp.layers, cond_kvs, mods, act_s):
        if sw.pair:
            x = ib.attn_pair_block(x, torch.cat([mod1, mod2]), ck, cv, lyr.q.qw, lyr.k.qw,
                                   lyr.v.qw, lyr.proj.qw, lyr.crossq.qw, lyr.crossproj.qw,
                                   batch=B, n_head=H, q_valid=L, kv_valid=S,
                                   static_s=_pair(ls[0:4]), attn=sw.pair_attn)
        else:
            x = ib.self_attn_block(x, mod1, lyr.q.qw, lyr.k.qw, lyr.v.qw, lyr.proj.qw, batch=B,
                                   n_head=H, q_valid=L, static_s=_pair(ls[0:2]), w4=w4,
                                   attn=sw.attn)
            x = ib.cross_attn_block(x, mod2, ck, cv, lyr.crossq.qw, lyr.crossproj.qw, batch=B,
                                    n_head=H, kv_valid=S, static_s=_pair(ls[2:4]), w4=w4,
                                    attn=sw.attn)
        mlp_args = (x, lyr.ln2_mod, lyr.fc1.qw, lyr.fc2.qw)
        if sw.mlp_impl == "chunked":
            x = ib.mlp_block_chunked(*mlp_args, n_chunks=sw.n_chunks, static_s=_pair(ls[4:6]))
        elif sw.mlp_impl == "streamed":
            x = ib.mlp_block_streamed(*mlp_args, n_chunks=sw.n_chunks, static_s=_pair(ls[4:6]))
        else:
            x = ib.mlp_block(*mlp_args, static_s=_pair(ls[4:6]), w4=w4)
    return x


def _per_dense(qp: Int8Denoiser, x, cond_kvs, mods, act_s, B: int, L: int, S: int):
    """impl="pallas_dense": per layer six K6 denses and two K7 attentions
    (JAX ``int8_runtime.py:455-477``)."""
    H = qp.n_head
    dense = quant.fused_quant_dense_multi
    for lyr, (ck, cv), (mod1, mod2), ls in zip(qp.layers, cond_kvs, mods, act_s):
        q, k, v = dense(x, (lyr.q.qw, lyr.k.qw, lyr.v.qw), norm="adaln", mod=mod1,
                        s_static=ls[0])
        y = attn.fused_mha(q, k, v, batch=B, n_head=H, kv_valid=L)
        (x,) = dense(y, (lyr.proj.qw,), residual=x, s_static=ls[1])
        (q2,) = dense(x, (lyr.crossq.qw,), norm="adaln", mod=mod2, s_static=ls[2])
        y = attn.fused_mha(q2, ck, cv, batch=B, n_head=H, kv_valid=S)
        (x,) = dense(y, (lyr.crossproj.qw,), residual=x, s_static=ls[3])
        (h,) = dense(x, (lyr.fc1.qw,), norm="ln", mod=lyr.ln2_mod, act="gelu2", s_static=ls[4])
        (x,) = dense(h, (lyr.fc2.qw,), residual=x, s_static=ls[5])
    return x


def _int8_backbone_hidden(qp: Int8Denoiser, tokens: torch.Tensor, t: Optional[int], cond_kvs,
                          *, impl: str = "pallas", mods=None) -> torch.Tensor:
    """Pre-head activations (B*L, D) bf16: the embedding, then the layers on
    the ``impl`` path (module docstring). ``mods``: per-layer ((2, D), (2, D))
    AdaLN modulations for this step (default: gathered from the tables at
    ``t``)."""
    impl = _check_impl(impl)
    if impl == "pallas_dense":
        qp = unpack_denoiser(qp)   # only the block kernels take packed W4
    B, L = tokens.shape
    S = cond_kvs[0][0].shape[0] // B
    mods = _layer_mods(qp, t) if mods is None else mods
    act_s = qp.act_scales if qp.act_scales is not None else ((None,) * 6,) * len(qp.layers)
    run = _blocks if impl == "pallas" else _per_dense
    return run(qp, _embed(qp, tokens), cond_kvs, mods, act_s, B, L, S)


def int8_backbone_logits(qp: Int8Denoiser, tokens: torch.Tensor, t: int, cond_kvs, *,
                         impl: str = "pallas", mods=None) -> torch.Tensor:
    """Raw denoiser logits (B, L, K-1) f32 (final LN -> bf16 -> head, f32 sum)."""
    B, L = tokens.shape
    x = _int8_backbone_hidden(qp, tokens, t, cond_kvs, impl=impl, mods=mods)
    return fs.head_logits(x, qp.norm_out, qp.head_w, qp.head_b).reshape(B, L, -1)


@torch.no_grad()
def sample_tokens_int8(
    qp: Int8Denoiser,
    sched,
    cond_emb: torch.Tensor,               # (B, S, Dc)
    *,
    generator: torch.Generator,
    truncation_r: float = 0.0,
    skip_step: int = 0,
    noise: Optional[torch.Tensor] = None,   # (n_steps, B, L, K) Gumbel noise in place of draws
    impl: Optional[str] = None,             # "pallas" (default) or "pallas_dense"
) -> torch.Tensor:
    """Reverse sampler on the int8 engine; returns (B, L) int32 tokens.

    Per step: the embedding, the layers on the ``impl`` path (module
    docstring), then K2 (final LN, head and the sampler step; step ``idx``
    keyed on ``(seed_base, idx)``). The condition K/V, the AdaLN modulations
    of the whole plan, the step coefficients, the head weight in K2's row
    pitch and, for a W4 engine on the per-dense path, the unpacked weights
    are made once before the loop."""
    from .process import _timestep_plan

    impl = _check_impl(impl)
    if impl == "pallas_dense":
        qp = unpack_denoiser(qp)   # once per generation, not once per step
    device = cond_emb.device
    K, T, L = qp.tok_emb.shape[0], qp.num_timesteps, qp.seq_len
    B, D = cond_emb.shape[0], qp.tok_emb.shape[-1]
    ts, t_post = _timestep_plan(T, T, skip_step)
    if noise is not None and tuple(noise.shape) != (len(ts), B, L, K):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {(len(ts), B, L, K)}")
    coeffs = fs.step_coeffs(sched, t_post).as_array().contiguous()      # (n_steps, 10)
    # on the device: the kernels read it there, no host sync
    seed_base = torch.randint(0, 2**31 - 1, (1,), generator=generator,
                              device=generator.device).to(device, torch.int32)
    kvs = precompute_cond_kvs(qp, cond_emb)
    head_w = fs.head_weight_rows(qp.head_w)   # K2's row pitch, padded once if need be
    tsel = torch.as_tensor(ts, device=device)
    mods_seq = [(lyr.ada1[tsel].reshape(-1, 2, D), lyr.ada2[tsel].reshape(-1, 2, D))
                for lyr in qp.layers]
    tokens = torch.full((B * L,), K - 1, dtype=torch.int32, device=device)   # all-MASK
    for idx in range(len(ts)):
        x = _int8_backbone_hidden(qp, tokens.reshape(B, L), None, kvs, impl=impl,
                                  mods=[(a[idx], b[idx]) for a, b in mods_seq])
        g = None if noise is None else noise[idx].reshape(B * L, K)
        tokens = fs.fused_head_sample(x, tokens, qp.norm_out, head_w, qp.head_b,
                                      coeffs[idx], seed_base, idx,
                                      truncation_r=truncation_r, gumbel=g)
    return tokens.reshape(B, L)
