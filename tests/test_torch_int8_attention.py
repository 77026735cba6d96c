"""K10, the int8 attention of the serving engine's blocks, the bf16
attention with its softmax divide folded into the output, and the pair-packed
MHA that the engine serves at a head width of 64, against the JAX package.

The JAX engine reaches the first two through ``int8_block.py::_mha``:
``T2S_ATTN_INT8=1`` runs ``_mha_inline_int8``, ``T2S_SOFTMAX_FOLD_DIV=1`` the
folded ``_mha_inline``, inside K4 and K5 when the attention mode is "base"
and inside K8 always. In mode "pair" (``T2S_ATTN_MHA``'s default at two heads
of 64 a 128-lane group) K4 and K5 run ``_mha_pair_premasked`` / ``_mha_pair``
whatever those flags say. The port's blocks take that choice as ``attn``
("int8", "bf16_fold", "bf16" or "pair"), and the engine maps the switches
onto it (``int8_runtime._block_switches``). Here the plain twins are held
against the JAX functions called directly (per batch element, as one JAX
block program holds one), the block twins against the JAX Pallas kernels in
interpret mode with the module flag or ``mha_mode`` set, and the engine's
backbone under each switch setting against the JAX oracles composed per
layer with that MHA. The CUDA kernels are checked against the same twins on
the card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Geometry of tests/test_torch_int8_blocks.py: batch 2, 32 tokens, width 128,
condition 16, MLP 512; 4 heads of 32 (JAX's default attention mode there is
"base") and 2 heads of 64 (default "pair").
"""

from functools import lru_cache

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
from text_to_sound_synthesis_torch.models.diffusion import int8_runtime as trt
from text_to_sound_synthesis_torch.ops import attention as TA
from text_to_sound_synthesis_torch.ops import int8_block as TB
from text_to_sound_synthesis_torch.ops.quant import QuantizedWeight

torch.set_num_threads(1)

B, Lp, D, Skv = 2, 32, 128, 16
M, DH = B * Lp, 4 * D
HEADS = [4, 2]          # head width 32 (JAX mode "base") and 64 (JAX mode "pair")
# K10's twin against JAX's _mha_inline_int8, f32 outputs: the integer dots are
# exact on both sides; exp and the softmax sums differ by an ulp between the
# two frameworks, which can move a value of P across a .5 step of its int8
# grid and the output by one step s_p * s_v (observed max |d| 3.6e-7 at values
# up to 1.9: f32 rounding only, no flip at these inputs)
INT8_TOL = 1e-5
# the bf16 MHA twins against JAX's _mha_inline rounded to bf16: one bf16 ulp
# at values up to 2 (observed: equal at these inputs)
MHA_TOL = 1e-2
# bf16 block outputs, as tests/test_torch_int8_blocks.py holds them (an int8
# flip upstream moves a few outputs by a bf16 ulp or two; observed max |d|
# 1.6e-2 against the JAX kernels with int8 attention, 7.8e-3 folded)
TOL = 2e-2
# K8 against JAX's composed oracle, which rounds x to bf16 between its halves
# (tests/test_torch_int8_schedules.py)
PAIR_ORACLE_TOL = 3e-2
# two composed layers (tests/test_torch_int8_schedules.py)
LAYERS_TOL = 3e-2

_JAX_MHA_REFERENCE = JA.mha_reference


def _jweight(seed, k, n, w4=False):
    rng = np.random.default_rng(seed)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.05).astype(np.float32))
    b = jnp.asarray((rng.standard_normal(n) * 0.05).astype(np.float32))
    return (JQ.quantize_weight_w4 if w4 else JQ.quantize_weight)(w, b)


def _tw(jw):
    """JAX QuantizedWeight (K, N) -> the port's (N, K), same int8 values."""
    return QuantizedWeight(torch.from_numpy(np.array(jw.w_q).T.copy()),
                           torch.from_numpy(np.array(jw.scale)[0]),
                           torch.from_numpy(np.array(jw.bias)[0]))


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _rows(seed, rows, cols, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((rows, cols)) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _qkv(seed, keys, kv_valid):
    """bf16 q (M, D), k/v (B*keys, D); the masked keys of v four times larger,
    so that they set V's column scale."""
    v = _rows(seed + 2, B * keys, D)
    v.reshape(B, keys, D)[:, kv_valid:] *= 4.0
    return _bf16(_rows(seed, M, D)), _bf16(_rows(seed + 1, B * keys, D)), _bf16(v)


def _jax_per_element(fn, q, k, v, n_head, kv_valid):
    """A JAX (Lq, D) attention applied to each batch element, as one JAX block
    program runs it on its rows."""
    Lq, Lkv = q.shape[0] // B, k.shape[0] // B
    return jnp.concatenate([fn(q[b * Lq:(b + 1) * Lq], k[b * Lkv:(b + 1) * Lkv],
                               v[b * Lkv:(b + 1) * Lkv], n_head, kv_valid) for b in range(B)])


KEYS = [(Lp, Lp), (Lp, Lp - 5), (Skv, Skv), (Skv, Skv - 4)]


# ---------------------------------------------------------------------------
# the plain twins against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys,kv_valid", KEYS)
@pytest.mark.parametrize("n_head", HEADS)
def test_mha_inline_int8_twin_matches_jax(n_head, keys, kv_valid):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, keys, kv_valid)
    want = _jax_per_element(JB._mha_inline_int8, jq, jk, jv, n_head, kv_valid)
    got = TB.mha_inline_int8_reference(tq, tk, tv, batch=B, n_head=n_head, kv_valid=kv_valid)
    assert got.dtype == torch.float32 and got.shape == (M, D)
    _close(got, want, INT8_TOL)
    if kv_valid < keys:
        # V's scale is a column max over all keys of the element, masked ones
        # included: without the masked keys the answer changes
        kept = lambda t: t.reshape(B, keys, D)[:, :kv_valid].reshape(B * kv_valid, D)
        alone = TB.mha_inline_int8_reference(tq, kept(tk), kept(tv), batch=B, n_head=n_head,
                                             kv_valid=kv_valid)
        assert not torch.allclose(alone, got, rtol=INT8_TOL, atol=INT8_TOL)


@pytest.mark.parametrize("keys,kv_valid", [KEYS[1], KEYS[3]])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("n_head", HEADS)
def test_mha_twin_matches_jax_mha_inline(monkeypatch, n_head, fold, keys, kv_valid):
    """``mha_reference(fold_div=...)`` against ``_mha_inline`` with JAX's
    ``T2S_SOFTMAX_FOLD_DIV`` flag as given."""
    monkeypatch.setattr(JB, "_FOLD_DIV", fold)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(10, keys, kv_valid)
    want = _jax_per_element(JB._mha_inline, jq, jk, jv, n_head, kv_valid).astype(jnp.bfloat16)
    got = TA.mha_reference(tq, tk, tv, batch=B, n_head=n_head, kv_valid=kv_valid, fold_div=fold)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want, MHA_TOL)


def _pair_masked(k):
    """k with head B's lanes zeroed, and with head A's: each 128-lane group
    of a pair, as JAX folds the masks into its K/V dequants."""
    lane = jnp.arange(k.shape[1]) % 128
    return jnp.where(lane < 64, k, 0).astype(k.dtype), jnp.where(lane >= 64, k, 0).astype(k.dtype)


@pytest.mark.parametrize("keys,kv_valid", KEYS)
@pytest.mark.parametrize("fn", ["_mha_pair_premasked", "_mha_pair"])
def test_pair_twin_matches_jax_pair_mha(fn, keys, kv_valid):
    """``mha_pair_reference`` against JAX's two pair-packed MHAs on bf16
    inputs, output rounded to bf16 (one row max shared by a pair, the
    divide after P V): one bf16 ulp at values up to 2 (MHA_TOL)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(60, keys, kv_valid)
    if fn == "_mha_pair":
        call = JB._mha_pair
    else:
        call = lambda q, k, v, n_head, valid: JB._mha_pair_premasked(
            q, *_pair_masked(k), *_pair_masked(v), n_head, valid)
    want = _jax_per_element(call, jq, jk, jv, 2, kv_valid).astype(jnp.bfloat16)
    got = TA.mha_pair_reference(tq, tk, tv, batch=B, n_head=2, kv_valid=kv_valid)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want, MHA_TOL)


def test_pair_twin_refuses_other_heads():
    (_, tq), (_, tk), (_, tv) = _qkv(61, Skv, Skv)
    with pytest.raises(ValueError, match="even number of heads of width 64"):
        TA.mha_pair_reference(tq, tk, tv, batch=B, n_head=4, kv_valid=Skv)


def test_fold_div_rounds_otherwise():
    """The folded divide rounds exp(s - max), not p, to bf16: another result."""
    (_, tq), (_, tk), (_, tv) = _qkv(20, Lp, Lp)
    kw = dict(batch=B, n_head=4, kv_valid=Lp)
    fold = TA.mha_reference(tq, tk, tv, fold_div=True, **kw)
    plain = TA.mha_reference(tq, tk, tv, **kw)
    assert not torch.equal(fold, plain)
    _close(fold, plain.float(), MHA_TOL)


# ---------------------------------------------------------------------------
# K4, K5, K8 with attn="int8" / "bf16_fold" against the JAX kernels
# ---------------------------------------------------------------------------

JAX_FLAG = {"int8": "_ATTN_INT8", "bf16_fold": "_FOLD_DIV"}


def _block_case(block, n_head, seed):
    """(JAX call, port call) of one block on the same inputs: K4 and K5 with
    W4 weights, K8 (W8 only); static scales at 2 heads, dynamic at 4."""
    jx, tx = _bf16(_rows(seed, M, D))
    jmods, tmods = jnp.asarray(_rows(seed + 1, 4, D, 0.2)), torch.from_numpy(_rows(seed + 1, 4, D, 0.2))
    jck, tck = _bf16(_rows(seed + 2, B * Skv, D))
    jcv, tcv = _bf16(_rows(seed + 3, B * Skv, D))
    static = n_head == 2
    w4 = block != "pair"
    jws = [_jweight(seed + 4 + i, D, D, w4) for i in range(6)]
    tws = [_tw(w) for w in jws]
    kw = dict(batch=B, n_head=n_head)
    if block == "self":
        ss = (0.03, 0.02) if static else None
        return (lambda: JB.self_attn_block(jx, jmods[:2], *jws[:4], q_valid=Lp - 3, static_s=ss,
                                           w4=True, interpret=True, mha_mode="base", **kw),
                lambda attn: TB.self_attn_block(tx, tmods[:2], *tws[:4], q_valid=Lp - 3,
                                                static_s=ss, w4=True, attn=attn, **kw))
    if block == "cross":
        ss = (0.03, 0.02) if static else None
        return (lambda: JB.cross_attn_block(jx, jmods[:2], jck, jcv, *jws[:2], kv_valid=Skv - 4,
                                            static_s=ss, w4=True, interpret=True,
                                            mha_mode="base", **kw),
                lambda attn: TB.cross_attn_block(tx, tmods[:2], tck, tcv, *tws[:2],
                                                 kv_valid=Skv - 4, static_s=ss, w4=True,
                                                 attn=attn, **kw))
    ss = (0.03, 0.02, 0.03, 0.02) if static else None
    pkw = dict(q_valid=Lp - 3, kv_valid=Skv - 2, static_s=ss, **kw)
    return (lambda: JB.attn_pair_block(jx, jmods, jck, jcv, *jws, interpret=True, **pkw),
            lambda attn: TB.attn_pair_block(tx, tmods, tck, tcv, *tws, attn=attn, **pkw))


@pytest.mark.parametrize("n_head", HEADS)
@pytest.mark.parametrize("attn", ["int8", "bf16_fold"])
@pytest.mark.parametrize("block", ["self", "cross", "pair"])
def test_block_twins_match_jax_kernel_interpret(monkeypatch, block, attn, n_head):
    """Each block twin with ``attn`` against the Pallas kernel (interpret
    mode, ``mha_mode="base"``) with JAX's module flag for that MHA set."""
    monkeypatch.setattr(JB, JAX_FLAG[attn], True)
    jax_call, port_call = _block_case(block, n_head, 30)
    got = port_call(attn)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, jax_call())


def _pair_case(block, seed, rows):
    """(JAX call, port call) of K4 or K5 in pair mode on the same inputs:
    two heads of 64, W4 weights, static scales; the JAX kernel with
    ``rows_per_program`` ``rows``."""
    jx, tx = _bf16(_rows(seed, M, D))
    jmods, tmods = jnp.asarray(_rows(seed + 1, 2, D, 0.2)), torch.from_numpy(_rows(seed + 1, 2, D, 0.2))
    jck, tck = _bf16(_rows(seed + 2, B * Skv, D))
    jcv, tcv = _bf16(_rows(seed + 3, B * Skv, D))
    jws = [_jweight(seed + 4 + i, D, D, True) for i in range(4)]
    tws = [_tw(w) for w in jws]
    kw = dict(batch=B, n_head=2, static_s=(0.03, 0.02), w4=True)
    if block == "self":
        return (lambda: JB.self_attn_block(jx, jmods, *jws, q_valid=Lp - 3, interpret=True,
                                           mha_mode="pair", rows_per_program=rows, **kw),
                lambda attn: TB.self_attn_block(tx, tmods, *tws, q_valid=Lp - 3, attn=attn, **kw))
    return (lambda: JB.cross_attn_block(jx, jmods, jck, jcv, *jws[:2], kv_valid=Skv - 4,
                                        interpret=True, mha_mode="pair", rows_per_program=rows,
                                        **kw),
            lambda attn: TB.cross_attn_block(tx, tmods, tck, tcv, *tws[:2], kv_valid=Skv - 4,
                                             attn=attn, **kw))


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("block", ["self", "cross"])
def test_pair_blocks_match_jax_kernel_interpret(block, rows):
    """K4 / K5 with ``attn="pair"`` against the Pallas kernels with
    ``mha_mode="pair"`` (interpret mode), one or two batch rows a program."""
    jax_call, port_call = _pair_case(block, 70, rows)
    got = port_call("pair")
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, jax_call())


@pytest.mark.parametrize("block", ["self", "cross"])
def test_bf16_mha_was_further_from_jax_pair_kernel(block):
    """The MHA the port ran in pair mode before (``attn="bf16"``: a max per
    head, the divide before P V) lies further from JAX's pair kernel than
    ``attn="pair"`` does: more outputs differ, and by more."""
    jax_call, port_call = _pair_case(block, 80, 1)
    want = torch.from_numpy(np.array(jax_call().astype(jnp.float32)))
    d = {attn: (port_call(attn).float() - want).abs() for attn in ("pair", "bf16")}
    assert int((d["pair"] > 0).sum()) < int((d["bf16"] > 0).sum())
    assert float(d["pair"].mean()) < float(d["bf16"].mean())


def _jax_mha(kind):
    """JAX's MHA of the blocks for ``kind``, with ``mha_reference``'s
    signature and output dtype: the bf16 oracle, or ``_mha_inline`` (flag as
    set) / ``_mha_inline_int8`` / ``_mha_pair`` per batch element."""
    if kind == "bf16":
        return _JAX_MHA_REFERENCE
    fn = {"int8": JB._mha_inline_int8, "pair": JB._mha_pair}.get(kind, JB._mha_inline)

    def mha(q, k, v, *, batch, n_head, kv_valid):
        assert batch == B
        return _jax_per_element(fn, q, k, v, n_head, kv_valid).astype(q.dtype)
    return mha


@pytest.mark.parametrize("static", [False, True])
def test_pair_int8_twin_matches_jax_composed_oracle(monkeypatch, static):
    """K8 with int8 attention against JAX's composed oracle with the int8 MHA
    in both halves."""
    monkeypatch.setattr(JA, "mha_reference", _jax_mha("int8"))
    jx, tx = _bf16(_rows(40, M, D))
    mods = _rows(41, 4, D, 0.2)
    jck, tck = _bf16(_rows(42, B * Skv, D))
    jcv, tcv = _bf16(_rows(43, B * Skv, D))
    jws = [_jweight(44 + i, D, D) for i in range(6)]
    kw = dict(batch=B, n_head=4, q_valid=Lp - 3, kv_valid=Skv - 2,
              static_s=(0.03, 0.02, 0.03, 0.02) if static else None)
    want = JB.attn_pair_block_reference(jx, jnp.asarray(mods), jck, jcv, *jws, **kw)
    got = TB.attn_pair_block(tx, torch.from_numpy(mods), tck, tcv, *map(_tw, jws), attn="int8",
                             **kw)
    _close(got, want, PAIR_ORACLE_TOL)


# ---------------------------------------------------------------------------
# the engine's switches
# ---------------------------------------------------------------------------

T, NUM_EMBED, COND_DIM, N_LAYER = 10, 16, 64, 2
K = NUM_EMBED + 1


@lru_cache(maxsize=None)
def _engine(n_head):
    """A random JAX denoiser with ``n_head`` heads, its W8 and W4 engines,
    tokens and a condition."""
    tcfg = {"params": dict(n_layer=N_LAYER, n_embd=D, n_head=n_head, content_seq_len=Lp,
                           condition_dim=COND_DIM, content_spatial_size=(4, 8),
                           block_activate="GELU2")}
    ecfg = {"params": dict(num_embed=NUM_EMBED, embed_dim=D, spatial_size=(4, 8))}
    jmodel = JDiffusion(transformer_config=tcfg, content_emb_config=ecfg, diffusion_step=T)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, Lp), 0, K), np.int32)
    cond = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (B, Skv, COND_DIM)))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(cond),
                         jnp.zeros((B,), jnp.int32))
    q = lambda bits: jrt.quantize_denoiser(params, n_head=n_head, seq_len=Lp, num_timesteps=T,
                                           weight_bits=bits)
    return {8: q(8), 4: q(4)}, tokens, cond


def _jax_hidden(jqp, tokens, cond, n_head, pair):
    """JAX int8_runtime.py:400-430 with the block kernels' oracles, the MHA
    being whatever ``JA.mha_reference`` is now: K4 -> K5 (or K8, its self
    half's x + proj kept in f32) -> K3, per layer."""
    jqp = jrt.unpack_denoiser(jqp)
    kvs = jrt.precompute_cond_kvs(jqp, jnp.asarray(cond))
    x = (jqp.tok_emb[jnp.asarray(tokens)] + jqp.pos_emb[None]).reshape(M, D)
    dense = JQ.quant_dense_reference
    kw = dict(batch=B, n_head=n_head)
    for lyr, (ck, cv) in zip(jqp.layers, kvs):
        ck, cv = ck.reshape(B * Skv, D), cv.reshape(B * Skv, D)
        mod1, mod2 = lyr.ada1[3].reshape(2, D), lyr.ada2[3].reshape(2, D)
        if pair:
            q, k, v = (dense(x, w, norm="adaln", mod=mod1) for w in (lyr.q, lyr.k, lyr.v))
            y = JA.mha_reference(q, k, v, kv_valid=Lp, **kw)
            x = dense(y, lyr.proj, residual=x, out_dtype=jnp.float32)
            q2 = dense(x, lyr.crossq, norm="adaln", mod=mod2)
            x = dense(JA.mha_reference(q2, ck, cv, kv_valid=Skv, **kw), lyr.crossproj, residual=x)
        else:
            x = JB.self_attn_block_reference(x, mod1, lyr.q, lyr.k, lyr.v, lyr.proj, q_valid=Lp,
                                             **kw)
            x = JB.cross_attn_block_reference(x, mod2, ck, cv, lyr.crossq, lyr.crossproj,
                                              kv_valid=Skv, **kw)
        x = JB.mlp_block_reference(x, lyr.ln2_mod, lyr.fc1, lyr.fc2)
    return x


def _port_hidden(tqp, tokens, cond, **kw):
    kvs = trt.precompute_cond_kvs(tqp, torch.from_numpy(cond))
    return trt._int8_backbone_hidden(tqp, torch.from_numpy(tokens), 3, kvs, **kw)


def _spy_attn(monkeypatch):
    """Records (block, attn) of every attention block the engine calls."""
    seen = []
    for name in ("self_attn_block", "cross_attn_block", "attn_pair_block"):
        real = getattr(TB, name)
        monkeypatch.setattr(TB, name, lambda *a, _r=real, _n=name, **kw:
                            seen.append((_n, kw["attn"])) or _r(*a, **kw))
    return seen


# (heads, weight bits, switches, K8 or not, the blocks' MHA)
SWITCH_CASES = {
    "hd32 int8": (4, 8, dict(T2S_ATTN_INT8="1"), False, "int8"),
    "hd32 int8 W4": (4, 4, dict(T2S_ATTN_INT8="1", T2S_ATTN_PAIR="1"), False, "int8"),
    "hd32 fold": (4, 8, dict(T2S_SOFTMAX_FOLD_DIV="1"), False, "bf16_fold"),
    "hd32 int8 and fold": (4, 8, dict(T2S_ATTN_INT8="1", T2S_SOFTMAX_FOLD_DIV="1"), False,
                           "int8"),
    "hd32 pair int8": (4, 8, dict(T2S_ATTN_PAIR="1", T2S_ATTN_INT8="1"), True, "int8"),
    "hd64 default": (2, 8, {}, False, "pair"),
    "hd64 int8, pair mode": (2, 8, dict(T2S_ATTN_INT8="1"), False, "pair"),
    "hd64 fold, pair mode": (2, 8, dict(T2S_SOFTMAX_FOLD_DIV="1"), False, "pair"),
    "hd64 int8, base mode": (2, 8, dict(T2S_ATTN_INT8="1", T2S_ATTN_MHA="base"), False, "int8"),
    "hd64 fold, base mode": (2, 8, dict(T2S_SOFTMAX_FOLD_DIV="1", T2S_ATTN_MHA="base"), False,
                             "bf16_fold"),
    "hd64 pair int8": (2, 8, dict(T2S_ATTN_PAIR="1", T2S_ATTN_INT8="1"), True, "int8"),
    "hd64 pair fold, pair mode": (2, 8, dict(T2S_ATTN_PAIR="1", T2S_SOFTMAX_FOLD_DIV="1"), True,
                                  "bf16_fold"),
}


@pytest.mark.parametrize("case", list(SWITCH_CASES))
def test_backbone_attention_switches_match_jax_oracles(monkeypatch, case):
    """The switches pick each block's MHA as the JAX engine does: K8 always
    reaches ``_mha``, K4 and K5 only in mode "base" (the default at a head
    width of 32, ``T2S_ATTN_MHA=base`` at 64); in mode "pair", the default at
    64, K4 and K5 run the pair-packed MHA whatever the other switches say.
    The layers against the JAX oracles with that MHA."""
    n_head, bits, env, pair, attn = SWITCH_CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if attn == "bf16_fold":
        monkeypatch.setattr(JB, "_FOLD_DIV", True)
    engines, tokens, cond = _engine(n_head)
    tqp = from_jax.load_int8_engine(jax.device_get(engines[bits]), device="cpu")
    seen = _spy_attn(monkeypatch)
    got = _port_hidden(tqp, tokens, cond)
    blocks = ["attn_pair_block"] if pair else ["self_attn_block", "cross_attn_block"]
    assert seen == [(b, attn) for b in blocks] * N_LAYER
    monkeypatch.setattr(JA, "mha_reference", _jax_mha(attn))
    want = _jax_hidden(engines[bits], tokens, cond, n_head, pair)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want, LAYERS_TOL)


def test_w4_engine_serves_the_pair_mha(monkeypatch):
    """The served configuration, W4 at a head width of 64 under the default
    switches, runs K4 and K5 with the pair-packed MHA (their W4 numerics
    against JAX: test_pair_blocks_match_jax_kernel_interpret)."""
    engines, tokens, cond = _engine(2)
    tqp = from_jax.load_int8_engine(jax.device_get(engines[4]), device="cpu")
    seen = _spy_attn(monkeypatch)
    _port_hidden(tqp, tokens, cond)
    assert seen == [("self_attn_block", "pair"), ("cross_attn_block", "pair")] * N_LAYER


def test_attention_switches_change_the_answer(monkeypatch):
    """Each MHA gives another backbone output (so the comparisons above see
    which one ran), and the switches are read at each call."""
    engines, tokens, cond = _engine(4)
    tqp = from_jax.load_int8_engine(jax.device_get(engines[8]), device="cpu")
    outs = {}
    for name, env in (("bf16", {}), ("int8", dict(T2S_ATTN_INT8="1")),
                      ("bf16_fold", dict(T2S_SOFTMAX_FOLD_DIV="1")), ("again", {})):
        for var in ("T2S_ATTN_INT8", "T2S_SOFTMAX_FOLD_DIV"):
            monkeypatch.delenv(var, raising=False)
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        outs[name] = _port_hidden(tqp, tokens, cond)
    assert not torch.equal(outs["bf16"], outs["int8"])
    assert not torch.equal(outs["bf16"], outs["bf16_fold"])
    assert not torch.equal(outs["int8"], outs["bf16_fold"])
    assert torch.equal(outs["bf16"], outs["again"])


def test_attention_mode_switch_refuses_other_values(monkeypatch):
    engines, tokens, cond = _engine(2)
    tqp = from_jax.load_int8_engine(jax.device_get(engines[8]), device="cpu")
    monkeypatch.setenv("T2S_ATTN_MHA", "rows")
    with pytest.raises(ValueError, match="T2S_ATTN_MHA"):
        _port_hidden(tqp, tokens, cond)


def test_per_dense_path_ignores_the_attention_switches(monkeypatch):
    """K7 (``impl="pallas_dense"``) has its own MHA, untouched by both
    switches, as in JAX (``ops/attention.py``)."""
    engines, tokens, cond = _engine(4)
    tqp = from_jax.load_int8_engine(jax.device_get(engines[8]), device="cpu")
    want = _port_hidden(tqp, tokens, cond, impl="pallas_dense")
    monkeypatch.setenv("T2S_ATTN_INT8", "1")
    monkeypatch.setenv("T2S_SOFTMAX_FOLD_DIV", "1")
    monkeypatch.setenv("T2S_ATTN_MHA", "base")
    assert torch.equal(_port_hidden(tqp, tokens, cond, impl="pallas_dense"), want)


# ---------------------------------------------------------------------------
# the wrappers on the CPU and elsewhere
# ---------------------------------------------------------------------------

def _wrapper_calls(dev, attn="int8"):
    g = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g).to(dev)
    x, kv = rnd(M, D).bfloat16(), rnd(B * Skv, D).bfloat16()
    mods = rnd(4, D) * 0.2
    w = QuantizedWeight(torch.randint(-127, 128, (D, D), generator=g, dtype=torch.int8).to(dev),
                        torch.full((D,), 0.01).to(dev), torch.zeros(D).to(dev))
    kw = dict(batch=B, n_head=4)
    return {
        "mha_inline_int8": lambda: TB.mha_inline_int8(x, kv, kv, kv_valid=Skv - 4, **kw),
        "self_attn_block": lambda: TB.self_attn_block(x, mods[:2], w, w, w, w, q_valid=Lp,
                                                      attn=attn, **kw),
        "cross_attn_block": lambda: TB.cross_attn_block(x, mods[:2], kv, kv, w, w,
                                                        kv_valid=Skv, attn=attn, **kw),
        "attn_pair_block": lambda: TB.attn_pair_block(x, mods, kv, kv, *[w] * 6, q_valid=Lp,
                                                      kv_valid=Skv, attn=attn, **kw),
    }


COUNTED = ["mha_inline_int8", "self_attn_block", "cross_attn_block", "attn_pair_block"]


@pytest.mark.parametrize("name", COUNTED)
def test_wrappers_run_the_twin_on_cpu_and_count_no_launch(name):
    before = {n: getattr(TB, n).launches for n in COUNTED}
    out = _wrapper_calls("cpu")[name]()
    assert {n: getattr(TB, n).launches for n in COUNTED} == before
    assert out.device.type == "cpu" and out.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()


def test_mha_inline_int8_wrapper_is_the_twin_rounded_once():
    (_, tq), (_, tk), (_, tv) = _qkv(50, Skv, Skv - 4)
    kw = dict(batch=B, n_head=4, kv_valid=Skv - 4)
    got = TB.mha_inline_int8(tq, tk, tv, **kw)
    assert torch.equal(got, TB.mha_inline_int8_reference(tq, tk, tv, **kw).bfloat16())


@pytest.mark.parametrize("name", COUNTED)
def test_wrappers_raise_on_other_devices(name):
    """Neither CPU nor CUDA: the wrappers raise, they do not fall back."""
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        _wrapper_calls("meta")[name]()


@pytest.mark.parametrize("name", COUNTED[1:])
def test_blocks_refuse_an_unknown_attention(name):
    with pytest.raises(ValueError, match="attn"):
        _wrapper_calls("cpu", attn="fp8")[name]()
