"""The W8A8 engine's other kernel schedules against the JAX package: the
per-dense path (K6 ``fused_quant_dense[_multi]``, K7 ``fused_mha``) and the
merged-attention and chunked-MLP blocks (K8 ``attn_pair_block``, K9
``mlp_block_chunked`` / ``mlp_block_streamed``), each twin and the engine's
backbone on both paths.

Same numpy inputs and the same int8 weights (the JAX quantizer's output,
transposed to the port's (N, K) layout) go through the JAX ``*_reference``
oracles, once each through the JAX Pallas kernels in interpret mode, and
through the port's wrappers, which run their plain twins on a CPU tensor.
The CUDA kernels are checked against the same twins on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Geometry of tests/test_torch_int8_blocks.py: batch 2, 32 tokens, width 128,
4 heads, condition 16, MLP 512.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.models.diffusion import DiscreteDiffusion as JDiffusion
from text_to_sound_synthesis_tpu.models.diffusion import int8_runtime as jrt
from text_to_sound_synthesis_tpu.ops import attention as JA
from text_to_sound_synthesis_tpu.ops import int8_block as JB
from text_to_sound_synthesis_tpu.ops import quant as JQ
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.diffusion import int8_runtime as trt
from text_to_sound_synthesis_torch.ops import attention as TA
from text_to_sound_synthesis_torch.ops import int8_block as TB
from text_to_sound_synthesis_torch.ops import quant as TQ
from text_to_sound_synthesis_torch.ops.quant import QuantizedWeight

torch.set_num_threads(1)

B, Lp, D, H, Skv = 2, 32, 128, 4, 16
M, DH = B * Lp, 4 * D
# bf16 outputs of the dense and block twins, as tests/test_int8_blocks.py and
# tests/test_torch_int8_blocks.py hold them: the integer dots are exact on both
# sides, the f32 LayerNorm sums run in another order in the two frameworks, so
# an ulp can move a value across a .5 step of the int8 grid ("int8 flip"),
# which moves a few outputs by a bf16 ulp or two.
TOL = 2e-2
# K9 twin against its JAX oracle: the JAX test's tolerance for its kernel
# against the same oracle (tests/test_int8_blocks.py::test_mlp_block_chunked)
CHUNK_TOL = 5e-3
# K8 twin against JAX's composed oracle, which rounds x to bf16 between the
# two halves where the kernel (and the twin) keep it in f32: the JAX test's
# tolerance for its kernel against that oracle (test_attn_pair_block)
PAIR_ORACLE_TOL = 3e-2
# two composed layers: an int8 flip in layer 0 reaches layer 1's output at a
# few bf16 ulps (tests/test_torch_int8_runtime.py's backbone tolerance)
LAYERS_TOL = 3e-2


def _jweight(seed, k, n):
    rng = np.random.default_rng(seed)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.05).astype(np.float32))
    b = jnp.asarray((rng.standard_normal(n) * 0.05).astype(np.float32))
    return JQ.quantize_weight(w, b)


def _tw(jw):
    """JAX QuantizedWeight (K, N) -> the port's (N, K), same int8 values."""
    return QuantizedWeight(torch.from_numpy(np.array(jw.w_q).T.copy()),
                           torch.from_numpy(np.array(jw.scale)[0]),
                           torch.from_numpy(np.array(jw.bias)[0]))


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _f32(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _rows(seed, rows, cols, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((rows, cols)) * scale).astype(np.float32)


def _mod(seed, width, ln=False):
    """(2, width) modulation rows: AdaLN (scale; shift), or LN (gamma ~ 1; beta)."""
    m = _rows(seed, 2, width, 0.2)
    if ln:
        m[0] += 1.0
    return _f32(m)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# K6: fused_quant_dense / fused_quant_dense_multi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["none", "gelu2"])
@pytest.mark.parametrize("norm", ["none", "ln", "adaln"])
def test_quant_dense_twin_matches_jax(norm, act, residual, static):
    N = 256
    jx, tx = _bf16(_rows(0, M, D))
    jm, tm = _mod(1, D, ln=norm == "ln")
    jres, tres = _bf16(_rows(2, M, N)) if residual else (None, None)
    jw = _jweight(3, D, N)
    kw = dict(norm=norm, act=act, s_static=0.03 if static else None)
    want = JQ.quant_dense_reference(jx, jw, mod=jm if norm != "none" else None, residual=jres,
                                    **kw)
    got = TQ.fused_quant_dense(tx, _tw(jw), mod=tm if norm != "none" else None, residual=tres,
                               **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    _close(got, want)


# the engine's per-dense calls (JAX int8_runtime.py:459-477) at this geometry
ENGINE_DENSES = {
    "qkv": dict(k=D, n=D, n_w=3, norm="adaln"),
    "proj": dict(k=D, n=D, n_w=1, residual=True),
    "fc1": dict(k=D, n=DH, n_w=1, norm="ln", act="gelu2"),
    "fc2": dict(k=DH, n=D, n_w=1, residual=True),
}


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("site", list(ENGINE_DENSES))
def test_quant_dense_multi_twin_matches_jax(site, static, out_dtype):
    c = ENGINE_DENSES[site]
    norm = c.get("norm", "none")
    jx, tx = _bf16(_rows(4, M, c["k"]))
    jm, tm = _mod(5, c["k"], ln=norm == "ln")
    jres, tres = _bf16(_rows(6, M, c["n"])) if c.get("residual") else (None, None)
    jws = [_jweight(7 + i, c["k"], c["n"]) for i in range(c["n_w"])]
    kw = dict(norm=norm, act=c.get("act", "none"), s_static=0.03 if static else None)
    got = TQ.fused_quant_dense_multi(tx, [_tw(w) for w in jws], mod=tm, residual=tres,
                                     out_dtype=getattr(torch, out_dtype), **kw)
    assert len(got) == c["n_w"]
    for jw, g in zip(jws, got):
        want = JQ.quant_dense_reference(jx, jw, mod=jm, residual=jres,
                                        out_dtype=getattr(jnp, out_dtype), **kw)
        assert g.dtype == getattr(torch, out_dtype) and g.shape == (M, c["n"])
        # f32 outputs: no final rounding, so only an int8 flip separates them
        _close(g, want, TOL if out_dtype == "bfloat16" else 5e-3)


def test_quant_dense_multi_twin_matches_jax_kernel_interpret():
    """Against the Pallas kernel itself: q/k/v from one AdaLN + quantize."""
    jx, tx = _bf16(_rows(10, M, D))
    jm, tm = _mod(11, D)
    jws = [_jweight(12 + i, D, D) for i in range(3)]
    want = JQ.fused_quant_dense_multi(jx, jws, norm="adaln", mod=jm, block_m=32, interpret=True)
    got = TQ.fused_quant_dense_multi(tx, [_tw(w) for w in jws], norm="adaln", mod=tm)
    for g, w in zip(got, want):
        _close(g, w)


def test_quant_dense_twin_matches_jax_kernel_interpret():
    """The single-weight kernel: LN + GELU2 + residual, f32 out, static scale."""
    jx, tx = _bf16(_rows(15, M, D))
    jm, tm = _mod(16, D, ln=True)
    jres, tres = _bf16(_rows(17, M, D))
    jw = _jweight(18, D, D)
    kw = dict(norm="ln", act="gelu2", s_static=0.03)
    want = JQ.fused_quant_dense(jx, jw, mod=jm, residual=jres, out_dtype=jnp.float32,
                                block_m=32, interpret=True, **kw)
    got = TQ.fused_quant_dense(tx, _tw(jw), mod=tm, residual=tres, out_dtype=torch.float32, **kw)
    _close(got, want, 5e-3)


def test_quant_dense_refuses_what_jax_refuses():
    w = _tw(_jweight(19, D, D))
    w2 = _tw(_jweight(20, D, 2 * D))
    x = torch.zeros((M, D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="requires mod"):
        TQ.fused_quant_dense(x, w, norm="ln")
    with pytest.raises(ValueError, match="equal output widths"):
        TQ.fused_quant_dense_multi(x, (w, w2), residual=torch.zeros((M, D)))
    with pytest.raises(ValueError):
        TQ.fused_quant_dense(x, w, act="relu")
    # without a residual, outputs of other widths are fine (the twin maps over them)
    a, b = TQ.fused_quant_dense_multi(x, (w, w2))
    assert a.shape == (M, D) and b.shape == (M, 2 * D)


# ---------------------------------------------------------------------------
# K7: fused_mha
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys,kv_valid", [(Lp, Lp), (Lp, Lp - 5), (Skv, Skv), (Skv, Skv - 4)])
def test_fused_mha_twin_matches_jax(keys, kv_valid):
    jq, tq = _bf16(_rows(21, M, D))
    jk, tk = _bf16(_rows(22, B * keys, D))
    jv, tv = _bf16(_rows(23, B * keys, D))
    want = JA.mha_reference(jq, jk, jv, batch=B, n_head=H, kv_valid=kv_valid)
    got = TA.fused_mha(tq, tk, tv, batch=B, n_head=H, kv_valid=kv_valid)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want)


def test_fused_mha_twin_matches_jax_kernel_interpret():
    jq, tq = _bf16(_rows(24, M, D))
    jk, tk = _bf16(_rows(25, M, D))
    jv, tv = _bf16(_rows(26, M, D))
    want = JA.fused_mha(jq, jk, jv, batch=B, n_head=H, kv_valid=Lp - 5, interpret=True)
    got = TA.fused_mha(tq, tk, tv, batch=B, n_head=H, kv_valid=Lp - 5)
    _close(got, want)


# ---------------------------------------------------------------------------
# K8: attn_pair_block
# ---------------------------------------------------------------------------

def _pair_inputs(seed):
    jx, tx = _bf16(_rows(seed, M, D))
    jmods, tmods = _f32(_rows(seed + 1, 4, D, 0.2))
    jck, tck = _bf16(_rows(seed + 2, B * Skv, D))
    jcv, tcv = _bf16(_rows(seed + 3, B * Skv, D))
    jws = [_jweight(seed + 4 + i, D, D) for i in range(6)]
    return (jx, jmods, jck, jcv, *jws), (tx, tmods, tck, tcv, *map(_tw, jws))


PAIR_KW = dict(batch=B, n_head=H, q_valid=Lp - 3, kv_valid=Skv - 2)
PAIR_STATIC = (0.03, 0.02, 0.03, 0.02)


@pytest.mark.parametrize("static", [False, True])
def test_attn_pair_twin_matches_jax_kernel_interpret(static):
    """The twin computes what the TPU kernel computes, x in f32 between the
    halves: within TOL of the kernel (interpret mode), as the block twins."""
    jargs, targs = _pair_inputs(30)
    ss = PAIR_STATIC if static else None
    want = JB.attn_pair_block(*jargs, interpret=True, static_s=ss, **PAIR_KW)
    got = TB.attn_pair_block(*targs, static_s=ss, **PAIR_KW)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want)


@pytest.mark.parametrize("static", [False, True])
def test_attn_pair_twin_matches_jax_composed_oracle(static):
    jargs, targs = _pair_inputs(40)
    ss = PAIR_STATIC if static else None
    want = JB.attn_pair_block_reference(*jargs, static_s=ss, **PAIR_KW)
    got = TB.attn_pair_block(*targs, static_s=ss, **PAIR_KW)
    _close(got, want, PAIR_ORACLE_TOL)


def test_attn_pair_twin_keeps_x_in_f32():
    """The twin is not the two block twins composed: those round x to bf16
    between the halves. Feeding the composition's bf16 intermediate back
    gives the composition exactly."""
    _, (tx, tmods, tck, tcv, *tws) = _pair_inputs(50)
    kw = dict(batch=B, n_head=H)
    mid = TB.self_attn_block_reference(tx, tmods[0:2], *tws[:4], q_valid=Lp - 3, **kw)
    composed = TB.cross_attn_block_reference(mid, tmods[2:4], tck, tcv, *tws[4:],
                                             kv_valid=Skv - 2, **kw)
    pair = TB.attn_pair_block(tx, tmods, tck, tcv, *tws, **PAIR_KW)
    assert not torch.equal(pair, composed)
    _close(pair, composed.float(), PAIR_ORACLE_TOL)


# ---------------------------------------------------------------------------
# K9: mlp_block_chunked / mlp_block_streamed
# ---------------------------------------------------------------------------

def _mlp_inputs(seed):
    jx, tx = _bf16(_rows(seed, M, D))
    jm, tm = _mod(seed + 1, D, ln=True)
    jws = [_jweight(seed + 2, D, DH), _jweight(seed + 3, DH, D)]
    return (jx, jm, *jws), (tx, tm, *map(_tw, jws))


MLP_STATIC = (0.03, 0.01)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("n_chunks", [4, 16])
@pytest.mark.parametrize("wrapper", ["chunked", "streamed"])
def test_mlp_chunked_twin_matches_jax(wrapper, n_chunks, static):
    jargs, targs = _mlp_inputs(60)
    ss = MLP_STATIC if static else None
    want = JB.mlp_chunked_reference(*jargs, n_chunks=n_chunks, static_s=ss)
    fn = TB.mlp_block_chunked if wrapper == "chunked" else TB.mlp_block_streamed
    got = fn(*targs, n_chunks=n_chunks, static_s=ss)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want, CHUNK_TOL)


def test_mlp_chunked_twin_matches_jax_kernel_interpret():
    jargs, targs = _mlp_inputs(70)
    want = JB.mlp_block_chunked(*jargs, block_m=32, n_chunks=4, interpret=True)
    _close(TB.mlp_block_chunked(*targs, n_chunks=4), want, CHUNK_TOL)


def test_mlp_streamed_twin_matches_jax_kernel_interpret():
    """Static scales and 16 chunks of 32 columns (the streamed default)."""
    jargs, targs = _mlp_inputs(80)
    want = JB.mlp_block_streamed(*jargs, block_m=32, n_chunks=16, interpret=True,
                                 static_s=MLP_STATIC)
    _close(TB.mlp_block_streamed(*targs, static_s=MLP_STATIC), want, CHUNK_TOL)


def test_mlp_chunked_twin_refuses_uneven_chunks():
    _, targs = _mlp_inputs(90)
    with pytest.raises(ValueError, match="n_chunks"):
        TB.mlp_block_chunked(*targs, n_chunks=3)


# ---------------------------------------------------------------------------
# the wrappers on the CPU and elsewhere
# ---------------------------------------------------------------------------

def _wrapper_calls(dev, dtype=torch.bfloat16):
    x = torch.zeros((M, D), dtype=dtype, device=dev)
    mod = torch.zeros((4, D), device=dev)
    w = QuantizedWeight(torch.zeros((D, D), dtype=torch.int8, device=dev),
                        torch.ones(D, device=dev), torch.zeros(D, device=dev))
    w1 = QuantizedWeight(torch.zeros((DH, D), dtype=torch.int8, device=dev),
                         torch.ones(DH, device=dev), torch.zeros(DH, device=dev))
    w2 = QuantizedWeight(torch.zeros((D, DH), dtype=torch.int8, device=dev),
                         torch.ones(D, device=dev), torch.zeros(D, device=dev))
    kv = torch.zeros((B * Skv, D), dtype=dtype, device=dev)
    return {
        "fused_quant_dense": (TQ.fused_quant_dense, lambda: TQ.fused_quant_dense(x, w)),
        "fused_quant_dense_multi": (TQ.fused_quant_dense_multi,
                                    lambda: TQ.fused_quant_dense_multi(x, (w, w, w))),
        "fused_mha": (TA.fused_mha, lambda: TA.fused_mha(x, kv, kv, batch=B, n_head=H,
                                                         kv_valid=Skv)),
        "attn_pair_block": (TB.attn_pair_block,
                            lambda: TB.attn_pair_block(x, mod, kv, kv, *[w] * 6, **PAIR_KW)),
        "mlp_block_chunked": (TB.mlp_block_chunked,
                              lambda: TB.mlp_block_chunked(x, mod[:2], w1, w2)),
        "mlp_block_streamed": (TB.mlp_block_streamed,
                               lambda: TB.mlp_block_streamed(x, mod[:2], w1, w2)),
    }


WRAPPERS = ["fused_quant_dense", "fused_quant_dense_multi", "fused_mha", "attn_pair_block",
            "mlp_block_chunked", "mlp_block_streamed"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_run_the_twin_on_cpu_and_count_no_launch(name):
    fn, call = _wrapper_calls("cpu")[name]
    before = fn.launches
    out = call()
    assert fn.launches == before
    for t in out if isinstance(out, tuple) else (out,):
        assert t.device.type == "cpu" and torch.isfinite(t.float()).all()


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrappers_raise_on_other_devices(name):
    """Neither CPU nor CUDA: the wrappers raise, they do not fall back."""
    _, call = _wrapper_calls("meta")[name]
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        call()


# ---------------------------------------------------------------------------
# the engine: both kernel paths of the backbone, the switches, impl
# ---------------------------------------------------------------------------

T, NUM_EMBED, COND_DIM, N_LAYER = 10, 16, 64, 2
K = NUM_EMBED + 1
TCFG = {"params": dict(n_layer=N_LAYER, n_embd=D, n_head=H, content_seq_len=Lp,
                       condition_dim=COND_DIM, content_spatial_size=(4, 8),
                       block_activate="GELU2")}
ECFG = {"params": dict(num_embed=NUM_EMBED, embed_dim=D, spatial_size=(4, 8))}
STATIC_SCALES = ((0.05, 0.03, 0.05, 0.03, 0.05, 0.01),) * N_LAYER


@pytest.fixture(scope="module")
def engine():
    """A random JAX denoiser's W8 and W4 engines, tokens and a condition."""
    jmodel = JDiffusion(transformer_config=TCFG, content_emb_config=ECFG, diffusion_step=T)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, Lp), 0, K), np.int32)
    cond = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (B, Skv, COND_DIM)))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(cond),
                         jnp.zeros((B,), jnp.int32))
    q = lambda bits: jrt.quantize_denoiser(params, n_head=H, seq_len=Lp, num_timesteps=T,
                                           weight_bits=bits)
    return q(8), q(4), tokens, cond


def _engines(engine, bits, static):
    jqp = engine[0] if bits == 8 else engine[1]
    if static:
        jqp = jqp.replace(act_scales=STATIC_SCALES)
    tqp = from_jax.load_int8_engine(jax.device_get(jqp), device="cpu")
    return jrt.unpack_denoiser(jqp), tqp


def _jax_layers(jqp, tokens, t, cond, layer):
    """Embedding, then ``layer(x, lyr, ck, cv, mod1, mod2, scales)`` per layer."""
    kvs = jrt.precompute_cond_kvs(jqp, jnp.asarray(cond))
    x = (jqp.tok_emb[jnp.asarray(tokens)] + jqp.pos_emb[None]).reshape(M, D)
    act = jqp.act_scales or ((None,) * 6,) * len(jqp.layers)
    for lyr, (ck, cv), ls in zip(jqp.layers, kvs, act):
        x = layer(x, lyr, ck.reshape(B * Skv, D), cv.reshape(B * Skv, D),
                  lyr.ada1[t].reshape(2, D), lyr.ada2[t].reshape(2, D), ls)
    return x


def _jax_per_dense_layer(x, lyr, ck, cv, mod1, mod2, ls):
    """JAX int8_runtime.py:458-477 with its kernels' oracles:
    quant_dense_reference for fused_quant_dense_multi, mha_reference for
    fused_mha."""
    dense = JQ.quant_dense_reference
    q, k, v = (dense(x, w, norm="adaln", mod=mod1, s_static=ls[0]) for w in (lyr.q, lyr.k, lyr.v))
    y = JA.mha_reference(q, k, v, batch=B, n_head=H, kv_valid=Lp)
    x = dense(y, lyr.proj, residual=x, s_static=ls[1])
    q2 = dense(x, lyr.crossq, norm="adaln", mod=mod2, s_static=ls[2])
    y = JA.mha_reference(q2, ck, cv, batch=B, n_head=H, kv_valid=Skv)
    x = dense(y, lyr.crossproj, residual=x, s_static=ls[3])
    h = dense(x, lyr.fc1, norm="ln", mod=lyr.ln2_mod, act="gelu2", s_static=ls[4])
    return dense(h, lyr.fc2, residual=x, s_static=ls[5])


def _jax_pair_f32(x, lyr, ck, cv, mod1, mod2, ls):
    """What JAX's attn_pair_block kernel computes (int8_block.py:500-527),
    composed from the JAX oracles: the self half's x + proj stays f32
    (``out_dtype=float32``), the cross AdaLN reads it, and only the output is
    rounded. JAX's ``attn_pair_block_reference`` rounds x to bf16 in between
    instead; the K8 twin is held to that one block by block above."""
    dense = JQ.quant_dense_reference
    q, k, v = (dense(x, w, norm="adaln", mod=mod1, s_static=ls[0]) for w in (lyr.q, lyr.k, lyr.v))
    y = JA.mha_reference(q, k, v, batch=B, n_head=H, kv_valid=Lp)
    x = dense(y, lyr.proj, residual=x, s_static=ls[1], out_dtype=jnp.float32)
    q2 = dense(x, lyr.crossq, norm="adaln", mod=mod2, s_static=ls[2])
    y = JA.mha_reference(q2, ck, cv, batch=B, n_head=H, kv_valid=Skv)
    return dense(y, lyr.crossproj, residual=x, s_static=ls[3])


def _jax_block_layer(pair: bool, mlp: str):
    """JAX int8_runtime.py:400-430 with the block kernels' oracles."""
    def layer(x, lyr, ck, cv, mod1, mod2, ls):
        two = lambda s: None if s[0] is None else tuple(s)
        kw = dict(batch=B, n_head=H)
        if pair:
            x = _jax_pair_f32(x, lyr, ck, cv, mod1, mod2, ls)
        else:
            x = JB.self_attn_block_reference(x, mod1, lyr.q, lyr.k, lyr.v, lyr.proj, q_valid=Lp,
                                             static_s=two(ls[0:2]), **kw)
            x = JB.cross_attn_block_reference(x, mod2, ck, cv, lyr.crossq, lyr.crossproj,
                                              kv_valid=Skv, static_s=two(ls[2:4]), **kw)
        if mlp == "base":
            return JB.mlp_block_reference(x, lyr.ln2_mod, lyr.fc1, lyr.fc2, static_s=two(ls[4:6]))
        n = 16 if mlp == "streamed" else 4
        return JB.mlp_chunked_reference(x, lyr.ln2_mod, lyr.fc1, lyr.fc2, n_chunks=n,
                                        static_s=two(ls[4:6]))
    return layer


def _port_hidden(tqp, engine, **kw):
    _, _, tokens, cond = engine
    kvs = trt.precompute_cond_kvs(tqp, torch.from_numpy(cond))
    return trt._int8_backbone_hidden(tqp, torch.from_numpy(tokens), 3, kvs, **kw)


@pytest.mark.parametrize("bits,static", [(8, False), (8, True), (4, False)])
def test_backbone_per_dense_matches_jax_oracles(engine, bits, static):
    """impl="pallas_dense" (a W4 engine is unpacked first) against the JAX
    per-dense path composed from its kernels' oracles. The JAX engine itself
    cannot run the Pallas per-dense path on a CPU. W4 runs with dynamic
    scales: under this geometry's coarse static scales a one-ulp difference
    of the cross attention (torch and XLA sum the softmax in other orders)
    flips int8 values that layer 1 carries to 2-3 bf16 ulps on 0.4 % of the
    outputs, on the block path as on this one. That a W4 engine on this
    path answers as its unpacked W8 engine, bit for bit, is held in
    test_generate_int8_per_dense_end_to_end."""
    jqp, tqp = _engines(engine, bits, static)
    want = _jax_layers(jqp, engine[2], 3, engine[3], _jax_per_dense_layer)
    got = _port_hidden(tqp, engine, impl="pallas_dense")
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want, LAYERS_TOL)


SWITCHES = [("1", "base"), ("0", "chunked"), ("1", "chunked"), ("1", "streamed")]


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("pair,mlp", SWITCHES)
def test_backbone_block_switches_match_jax_oracles(engine, monkeypatch, pair, mlp, static):
    """T2S_ATTN_PAIR / T2S_MLP_IMPL pick K8 / K9 on a W8 engine, as in the JAX
    engine: the layers against the JAX oracles of the blocks it would run."""
    monkeypatch.setenv("T2S_ATTN_PAIR", pair)
    monkeypatch.setenv("T2S_MLP_IMPL", mlp)
    jqp, tqp = _engines(engine, 8, static)
    want = _jax_layers(jqp, engine[2], 3, engine[3], _jax_block_layer(pair == "1", mlp))
    _close(_port_hidden(tqp, engine), want, LAYERS_TOL)


def test_backbone_switches_are_read_at_each_call(engine, monkeypatch):
    """No switch is cached: the same engine takes K8 + K9 and then K4, K5 and
    K3 again as the environment changes between two calls, and
    T2S_MLP_CHUNKS sets the chunks."""
    _, tqp = _engines(engine, 8, False)
    base = _port_hidden(tqp, engine)
    monkeypatch.setenv("T2S_ATTN_PAIR", "1")
    monkeypatch.setenv("T2S_MLP_IMPL", "chunked")
    monkeypatch.setenv("T2S_MLP_CHUNKS", "2")
    seen = []
    real = TB.mlp_block_chunked
    monkeypatch.setattr(TB, "mlp_block_chunked",
                        lambda *a, **kw: seen.append(kw["n_chunks"]) or real(*a, **kw))
    assert not torch.equal(_port_hidden(tqp, engine), base)
    assert seen == [2] * N_LAYER
    monkeypatch.setenv("T2S_ATTN_PAIR", "0")
    monkeypatch.setenv("T2S_MLP_IMPL", "anything else")
    assert torch.equal(_port_hidden(tqp, engine), base)


@pytest.mark.parametrize("static", [False, True])
def test_w4_engine_runs_base_blocks_under_the_switches(engine, monkeypatch, static):
    """As in JAX, a W4 engine forces the base MLP and no pair."""
    _, tqp = _engines(engine, 4, static)
    want = _port_hidden(tqp, engine)
    monkeypatch.setenv("T2S_ATTN_PAIR", "1")
    monkeypatch.setenv("T2S_MLP_IMPL", "streamed")

    def refuse(*args, **kwargs):
        raise AssertionError("a W4 engine ran a W8-only block")

    for name in ("attn_pair_block", "mlp_block_chunked", "mlp_block_streamed"):
        monkeypatch.setattr(TB, name, refuse)
    assert torch.equal(_port_hidden(tqp, engine), want)


@pytest.mark.parametrize("impl", ["xla", "reference", "pallas_blocks"])
def test_impls_without_a_counterpart_raise(engine, impl):
    _, tqp = _engines(engine, 8, False)
    with pytest.raises(ValueError, match="impl"):
        _port_hidden(tqp, engine, impl=impl)
    with pytest.raises(ValueError, match="impl"):
        trt.sample_tokens_int8(tqp, None, torch.from_numpy(engine[3]),
                               generator=torch.Generator(), impl=impl)


# ---------------------------------------------------------------------------
# the composite: generate_int8(impl="pallas_dense")
# ---------------------------------------------------------------------------

def test_generate_int8_per_dense_end_to_end(monkeypatch):
    """The tiny composite of tests/test_torch_slice.py: a W4 engine on the
    per-dense path is unpacked once per request, not once per step, and
    answers as its unpacked W8 engine does, bit for bit."""
    from test_torch_slice import TINY_CFG, _cond_tokens

    model, cond = build_model(TINY_CFG, device="cpu", seed=0), torch.from_numpy(_cond_tokens())
    qp = model.quantize_for_serving(weight_bits=4)
    noise = torch.from_numpy(np.random.default_rng(4).gumbel(size=(4, 2, 16, 11)).astype(np.float32))
    unpacks = []
    real = trt.unpack_denoiser
    monkeypatch.setattr(trt, "unpack_denoiser",
                        lambda q: unpacks.append(q.weight_bits) or real(q))
    mel, tokens = model.generate_int8(qp, torch.Generator().manual_seed(1), cond,
                                      impl="pallas_dense", noise=noise, return_tokens=True)
    assert unpacks.count(4) == 1
    assert mel.shape == (2, 4, 16, 1) and torch.isfinite(mel).all()
    assert ((tokens >= 0) & (tokens < 10)).all()
    _, w8 = model.generate_int8(real(qp), torch.Generator().manual_seed(1), cond,
                                impl="pallas_dense", noise=noise, return_tokens=True)
    assert torch.equal(w8, tokens)
    with pytest.raises(ValueError, match="impl"):
        model.generate_int8(qp, torch.Generator().manual_seed(1), cond, impl="xla")
