"""The port's int8 block twins (K3, K4, K5) and the fused head + sampler twin
(K2) against the JAX package.

Same numpy inputs and the same int8 weights (the JAX quantizer's output,
transposed to the port's (N, K) layout) go through the JAX ``*_reference``
oracles, once each through the JAX Pallas kernels in interpret mode, and
through the port's plain twins. On the CPU the port's wrappers run those
twins; the CUDA kernels are checked on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.ops import diffusion as jdd
from text_to_sound_synthesis_tpu.ops import fused_sampler as jfs
from text_to_sound_synthesis_tpu.ops import int8_block as JB
from text_to_sound_synthesis_tpu.ops.quant import quantize_weight, quantize_weight_w4, unpack_weight_w4
from text_to_sound_synthesis_torch.ops import diffusion as tdd
from text_to_sound_synthesis_torch.ops import fused_sampler as tfs
from text_to_sound_synthesis_torch.ops import int8_block as TB
from text_to_sound_synthesis_torch.ops.quant import QuantizedWeight

torch.set_num_threads(1)

# tests/test_int8_blocks.py's geometry
B, Lp, D, H, Skv = 2, 32, 128, 4, 16
M = B * Lp
TOL = 2e-2          # bf16 block outputs, as tests/test_int8_blocks.py
STATIC = {"self": (0.03, 0.02), "cross": (0.03, 0.02), "mlp": (0.03, 0.01)}


def _jweight(seed, k, n, w4):
    rng = np.random.default_rng(seed)
    w = jnp.asarray((rng.standard_normal((k, n)) * 0.05).astype(np.float32))
    b = jnp.asarray((rng.standard_normal(n) * 0.05).astype(np.float32))
    return (quantize_weight_w4 if w4 else quantize_weight)(w, b)


def _tw(jw):
    """JAX QuantizedWeight (K, N) -> the port's (N, K), same int8 values."""
    return QuantizedWeight(torch.from_numpy(np.array(jw.w_q).T.copy()),
                           torch.from_numpy(np.array(jw.scale)[0]),
                           torch.from_numpy(np.array(jw.bias)[0]))


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    mod = (rng.standard_normal((2, D)) * 0.2).astype(np.float32)
    ck = rng.standard_normal((B * Skv, D)).astype(np.float32)
    cv = rng.standard_normal((B * Skv, D)).astype(np.float32)
    return _bf16(x), (jnp.asarray(mod), torch.from_numpy(mod)), _bf16(ck), _bf16(cv)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _oracle_weights(jws, w4):
    """The JAX oracles take plain int8 weights: W4 goes through the unpack."""
    return [unpack_weight_w4(w) if w4 else w for w in jws]


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_self_attn_twin_matches_jax(w4, static):
    (jx, tx), (jm, tm), _, _ = _data()
    jws = [_jweight(i, D, D, w4) for i in (3, 4, 5, 6)]
    ss = STATIC["self"] if static else None
    want = JB.self_attn_block_reference(jx, jm, *_oracle_weights(jws, w4), batch=B, n_head=H,
                                        q_valid=Lp - 3, static_s=ss)
    got = TB.self_attn_block(tx, tm, *map(_tw, jws), batch=B, n_head=H, q_valid=Lp - 3,
                             static_s=ss, w4=w4)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    _close(got, want)


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_cross_attn_twin_matches_jax(w4, static):
    (jx, tx), (jm, tm), (jck, tck), (jcv, tcv) = _data()
    jws = [_jweight(i, D, D, w4) for i in (9, 10)]
    ss = STATIC["cross"] if static else None
    want = JB.cross_attn_block_reference(jx, jm, jck, jcv, *_oracle_weights(jws, w4), batch=B,
                                         n_head=H, kv_valid=Skv - 4, static_s=ss)
    got = TB.cross_attn_block(tx, tm, tck, tcv, *map(_tw, jws), batch=B, n_head=H,
                              kv_valid=Skv - 4, static_s=ss, w4=w4)
    _close(got, want)


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_mlp_twin_matches_jax(w4, static):
    (jx, tx), (jm, tm), _, _ = _data()
    jm, tm = jm.at[0].add(1.0), tm.clone()
    tm[0] += 1.0
    jws = [_jweight(11, D, 4 * D, w4), _jweight(12, 4 * D, D, w4)]
    ss = STATIC["mlp"] if static else None
    want = JB.mlp_block_reference(jx, jm, *_oracle_weights(jws, w4), static_s=ss)
    got = TB.mlp_block(tx, tm, *map(_tw, jws), static_s=ss, w4=w4)
    _close(got, want)


def test_self_attn_twin_matches_jax_kernel_interpret():
    """One case against the Pallas kernel itself (interpret mode): W4, dynamic."""
    (jx, tx), (jm, tm), _, _ = _data(1)
    jws = [_jweight(i, D, D, True) for i in (13, 14, 15, 16)]
    want = JB.self_attn_block(jx, jm, *jws, batch=B, n_head=H, q_valid=Lp - 3, interpret=True,
                              w4=True)
    got = TB.self_attn_block(tx, tm, *map(_tw, jws), batch=B, n_head=H, q_valid=Lp - 3, w4=True)
    _close(got, want)


def test_cross_attn_twin_matches_jax_kernel_interpret():
    """W8, static scales; the kernel takes the flat condition K/V as is."""
    (jx, tx), (jm, tm), (jck, tck), (jcv, tcv) = _data(2)
    jws = [_jweight(i, D, D, False) for i in (17, 18)]
    ss = STATIC["cross"]
    want = JB.cross_attn_block(jx, jm, jck, jcv, *jws, batch=B, n_head=H, kv_valid=Skv - 4,
                               interpret=True, static_s=ss)
    got = TB.cross_attn_block(tx, tm, tck, tcv, *map(_tw, jws), batch=B, n_head=H,
                              kv_valid=Skv - 4, static_s=ss)
    _close(got, want)


def test_mlp_twin_matches_jax_kernel_interpret():
    """W4, static scales (the served mode)."""
    (jx, tx), (jm, tm), _, _ = _data(3)
    jws = [_jweight(19, D, 4 * D, True), _jweight(20, 4 * D, D, True)]
    ss = STATIC["mlp"]
    want = JB.mlp_block(jx, jm, *jws, block_m=32, interpret=True, static_s=ss, w4=True)
    got = TB.mlp_block(tx, tm, *map(_tw, jws), static_s=ss, w4=True)
    _close(got, want)


@pytest.mark.parametrize("static", [False, True])
def test_w4_twins_bitwise_equal_unpacked_w8(static):
    """W4 changes the weights' storage, never the math: each twin on packed
    weights equals the same twin on the unpacked int8 weights bit for bit."""
    (_, tx), (_, tm), (_, tck), (_, tcv) = _data(4)
    from text_to_sound_synthesis_torch.ops.quant import unpack_weight_w4 as tunpack

    attn = [_tw(_jweight(i, D, D, True)) for i in (21, 22, 23, 24)]
    mlp = [_tw(_jweight(25, D, 4 * D, True)), _tw(_jweight(26, 4 * D, D, True))]
    ss = (0.03, 0.02) if static else None
    kw = dict(batch=B, n_head=H, static_s=ss)
    pairs = [
        (TB.self_attn_block(tx, tm, *attn, q_valid=Lp - 3, w4=True, **kw),
         TB.self_attn_block(tx, tm, *map(tunpack, attn), q_valid=Lp - 3, **kw)),
        (TB.cross_attn_block(tx, tm, tck, tcv, *attn[:2], kv_valid=Skv - 4, w4=True, **kw),
         TB.cross_attn_block(tx, tm, tck, tcv, *map(tunpack, attn[:2]), kv_valid=Skv - 4, **kw)),
        (TB.mlp_block(tx, tm, *mlp, static_s=ss, w4=True),
         TB.mlp_block(tx, tm, *map(tunpack, mlp), static_s=ss)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)


def test_wrappers_run_the_twin_on_cpu_and_count_no_launch():
    (_, tx), (_, tm), _, _ = _data(5)
    ws = [_tw(_jweight(i, D, D, False)) for i in (27, 28, 29, 30)]
    before = TB.self_attn_block.launches
    got = TB.self_attn_block(tx, tm, *ws, batch=B, n_head=H, q_valid=Lp)
    want = TB.self_attn_block_reference(tx, tm, *ws, batch=B, n_head=H, q_valid=Lp)
    assert torch.equal(got, want)
    assert TB.self_attn_block.launches == before


@pytest.mark.parametrize("block", ["self", "cross", "mlp", "head"])
def test_wrappers_raise_on_other_devices(block):
    """Neither CPU nor CUDA: the wrappers raise, they do not fall back."""
    meta = torch.device("meta")
    x = torch.empty((M, D), dtype=torch.bfloat16, device=meta)
    mod = torch.empty((2, D), device=meta)
    w = QuantizedWeight(torch.empty((D, D), dtype=torch.int8, device=meta),
                        torch.empty(D, device=meta), torch.empty(D, device=meta))
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        if block == "self":
            TB.self_attn_block(x, mod, w, w, w, w, batch=B, n_head=H, q_valid=Lp)
        elif block == "cross":
            TB.cross_attn_block(x, mod, x, x, w, w, batch=B, n_head=H, kv_valid=Lp)
        elif block == "mlp":
            TB.mlp_block(x, mod, w, w)
        else:
            tfs.fused_head_sample(x, torch.empty(M, dtype=torch.int32, device=meta), mod,
                                  torch.empty((D, 16), dtype=torch.bfloat16, device=meta),
                                  torch.empty(16, device=meta), torch.empty(10, device=meta), 0)


# ---------------------------------------------------------------------------
# K2: final LN + head + sampler step
# ---------------------------------------------------------------------------

T_, K_ = 10, 17
# posterior log-probs: f32 log-space chains fed by f32 logits whose head sums
# run in another order in the two frameworks (about 1e-6 relative)
POST_ATOL = 2e-4


def _head_inputs(seed=0, k=K_):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32) * 2
    norm = np.stack([1.0 + rng.standard_normal(D) * 0.1, rng.standard_normal(D) * 0.1]).astype(np.float32)
    hw = (rng.standard_normal((D, k - 1)) * 0.1).astype(np.float32)
    hb = (rng.standard_normal(k - 1) * 0.1).astype(np.float32)
    xt = rng.integers(0, k, M).astype(np.int32)
    xt[0] = k - 1
    return x, norm, hw, hb, xt


def _jhead(x, norm, hw, hb, xt, t_post, r):
    k = hw.shape[1] + 1
    c = jfs.step_coeffs(jdd.make_schedule(T_, k), jnp.asarray(t_post))
    return jfs.head_sample_reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(xt),
                                     jnp.asarray(norm), jnp.asarray(hw, jnp.bfloat16),
                                     jnp.asarray(hb), c, jax.random.PRNGKey(0),
                                     truncation_r=r)


def _targs(x, norm, hw, hb, xt, t_post):
    return (_bf16(x)[1], torch.from_numpy(xt), torch.from_numpy(norm), _bf16(hw)[1],
            torch.from_numpy(hb),
            tfs.step_coeffs(tdd.make_schedule(T_, hw.shape[1] + 1), t_post).as_array())


@pytest.mark.parametrize("r", [0.0, 0.85])
@pytest.mark.parametrize("t_post", [0, 4, T_ - 1])
def test_head_sample_twin_matches_jax(t_post, r):
    x, norm, hw, hb, xt = _head_inputs()
    _, want = _jhead(x, norm, hw, hb, xt, t_post, r)
    g = np.random.default_rng(7).gumbel(size=(M, K_)).astype(np.float32)
    tok, got = tfs.head_sample_reference(*_targs(x, norm, hw, hb, xt, t_post),
                                         gumbel=torch.from_numpy(g), truncation_r=r)
    assert got.shape == (M, K_) and tok.dtype == torch.int32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POST_ATOL)
    np.testing.assert_array_equal(tok.numpy(), np.argmax(np.asarray(want) + g, axis=-1))
    # the wrapper on a CPU tensor is that twin
    tok2, got2 = tfs.fused_head_sample(*_targs(x, norm, hw, hb, xt, t_post), 3, 1,
                                       truncation_r=r, gumbel=torch.from_numpy(g),
                                       return_log_probs=True)
    assert torch.equal(tok2, tok) and torch.equal(got2, got)


def test_head_sample_twin_matches_jax_kernel_interpret():
    """The posterior of the Pallas kernel (interpret mode) at r = 0.85."""
    from jax.experimental.pallas import tpu as pltpu

    x, norm, hw, hb, xt = _head_inputs(1)
    c = jfs.step_coeffs(jdd.make_schedule(T_, K_), jnp.asarray(4))
    with pltpu.force_tpu_interpret_mode():
        _, want = jfs.fused_head_sample(jnp.asarray(x, jnp.bfloat16), jnp.asarray(xt)[:, None],
                                        jnp.asarray(norm), jnp.asarray(hw, jnp.bfloat16),
                                        jnp.asarray(hb), c, jnp.asarray(5, jnp.int32),
                                        truncation_r=0.85, return_log_probs=True)
    _, got = tfs.head_sample_reference(*_targs(x, norm, hw, hb, xt, 4), truncation_r=0.85,
                                       generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POST_ATOL)


def test_head_sample_draws_equal_k1_draws_on_the_same_logits():
    """K2 keys its noise on (seed, step) and counts on (row, class) as K1
    does: on the same logits the two wrappers pick the same tokens."""
    x, norm, hw, hb, xt = _head_inputs(2)
    args = _targs(x, norm, hw, hb, xt, 0)
    logits = tfs.head_logits(args[0], args[2], args[3], args[4])
    for seed, step in ((5, 0), (5, 3), (9, 3)):
        k2 = tfs.fused_head_sample(*args, seed, step, truncation_r=0.85)
        k1 = tfs.fused_p_sample(logits[None], args[1][None], args[5], seed, step,
                                truncation_r=0.85)[0]
        assert torch.equal(k2, k1)
    assert not torch.equal(tfs.fused_head_sample(*args, 5, 0), tfs.fused_head_sample(*args, 5, 1))


@pytest.mark.parametrize("k", [100, 513, 2049])
def test_head_sample_twin_matches_jax_at_larger_codebooks(k):
    """The 512- and 2048-code configs' class counts (K2 runs them in column
    passes on the card) and 99 codes (a K - 1 that is no multiple of 8, whose
    weight K2's wrapper pads): the twin against JAX's oracle, r = 0 and 0.85."""
    x, norm, hw, hb, xt = _head_inputs(3, k)
    g = np.random.default_rng(8).gumbel(size=(M, k)).astype(np.float32)
    for r in (0.0, 0.85):
        _, want = _jhead(x, norm, hw, hb, xt, 4, r)
        tok, got = tfs.head_sample_reference(*_targs(x, norm, hw, hb, xt, 4),
                                             gumbel=torch.from_numpy(g), truncation_r=r)
        assert got.shape == (M, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POST_ATOL)
        np.testing.assert_array_equal(tok.numpy(), np.argmax(np.asarray(want) + g, axis=-1))


@pytest.mark.parametrize("k", [100, 513, 2049])
def test_head_sample_twin_matches_jax_kernel_interpret_at_larger_codebooks(k):
    """As test_head_sample_twin_matches_jax_kernel_interpret, at 99, 512 and 2048 codes."""
    from jax.experimental.pallas import tpu as pltpu

    x, norm, hw, hb, xt = _head_inputs(4, k)
    c = jfs.step_coeffs(jdd.make_schedule(T_, k), jnp.asarray(4))
    with pltpu.force_tpu_interpret_mode():
        _, want = jfs.fused_head_sample(jnp.asarray(x, jnp.bfloat16), jnp.asarray(xt)[:, None],
                                        jnp.asarray(norm), jnp.asarray(hw, jnp.bfloat16),
                                        jnp.asarray(hb), c, jnp.asarray(5, jnp.int32),
                                        truncation_r=0.85, return_log_probs=True)
    _, got = tfs.head_sample_reference(*_targs(x, norm, hw, hb, xt, 4), truncation_r=0.85,
                                       generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=POST_ATOL)


def test_head_sample_takes_seed_and_step_as_int32_tensors():
    """K2's key words as one-element int32 tensors: the int form's tokens."""
    x, norm, hw, hb, xt = _head_inputs(2)
    args = _targs(x, norm, hw, hb, xt, 0)
    key = lambda v: torch.tensor([v], dtype=torch.int32)
    a = tfs.fused_head_sample(*args, 5, 3, truncation_r=0.85)
    assert torch.equal(a, tfs.fused_head_sample(*args, key(5), key(3), truncation_r=0.85))
    assert torch.equal(tfs.fused_head_sample(*args, 2**32 - 1, 3),
                       tfs.fused_head_sample(*args, key(-1), 3))
    with pytest.raises(ValueError, match="one int32"):
        tfs.fused_head_sample(*args, torch.tensor([5]), 3)


@pytest.mark.parametrize("k", [K_, 100])
def test_head_sample_takes_a_padded_weight_view(k):
    """``head_weight_rows``'s view of a weight (padded rows when K - 1 is no
    multiple of 8) samples as the contiguous weight does."""
    x, norm, hw, hb, xt = _head_inputs(5, k)
    args = _targs(x, norm, hw, hb, xt, 2)
    view = tfs.head_weight_rows(args[3])
    assert view.stride(0) % 8 == 0
    want = tfs.fused_head_sample(*args, 5, 3, truncation_r=0.85, return_log_probs=True)
    got = tfs.fused_head_sample(*args[:3], view, *args[4:], 5, 3, truncation_r=0.85,
                                return_log_probs=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
