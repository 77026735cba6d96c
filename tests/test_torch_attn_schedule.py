"""The attention blocks' schedule on the card, composed from plain pieces on
the CPU: [quantize pass] -> [q/k/v dots] -> MHA -> [quantize pass] -> [proj
+ residual] (``int8_block._attn_half``), against the twins and the JAX
package.

Same numpy inputs go through the JAX functions and the port's. D 256, 4
heads of 64, two layers' worth of blocks (each layer's self half, then its
cross half, on the previous layer's output).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_to_sound_synthesis_tpu.ops import int8_block as JB
from text_to_sound_synthesis_tpu.ops import quant as JQ
from text_to_sound_synthesis_tpu.ops.quant import quantize_weight, quantize_weight_w4
from text_to_sound_synthesis_torch.ops import int8_block as TB
from text_to_sound_synthesis_torch.ops.quant import QuantizedWeight

torch.set_num_threads(1)

B, L, D, H, S = 2, 40, 256, 4, 16
M = B * L
LAYERS = 2
TOL = 2e-2          # bf16 block outputs, as tests/test_torch_int8_blocks.py
STATIC = (0.03, 0.02)


def _tw(jw):
    """JAX QuantizedWeight (K, N) -> the port's (N, K), same int8 values."""
    return QuantizedWeight(torch.from_numpy(np.array(jw.w_q).T.copy()),
                           torch.from_numpy(np.array(jw.scale)[0]),
                           torch.from_numpy(np.array(jw.bias)[0]))


def _jweights(seed, n, w4):
    rng = np.random.default_rng(seed)
    q = quantize_weight_w4 if w4 else quantize_weight
    return [q(jnp.asarray((rng.standard_normal((D, D)) * 0.05).astype(np.float32)),
              jnp.asarray((rng.standard_normal(D) * 0.05).astype(np.float32)))
            for _ in range(n)]


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _pm_rows(rng, rows, width):
    """Rows half +2^e, half -2^e (e in 3..5 per row), in a random order: their
    mean (0) and variance (4^e) are exact in f32 in any summation order, and
    4^e + 1e-6 rounds to 4^e, whose 1/sqrt is exact; so any two LayerNorms of
    them agree bit for bit (XLA's rsqrt on the CPU lies an ulp from the
    correctly rounded one that torch.rsqrt gives, elsewhere)."""
    x = np.ones((rows, width), np.float32)
    x[:, width // 2:] = -1.0
    x = np.take_along_axis(x, np.argsort(rng.random((rows, width)), axis=1), axis=1)
    return x * 2.0 ** rng.integers(3, 6, (rows, 1))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    mods = (rng.standard_normal((LAYERS, 4, D)) * 0.2).astype(np.float32)
    ck = rng.standard_normal((B * S, D)).astype(np.float32)
    cv = rng.standard_normal((B * S, D)).astype(np.float32)
    return _bf16(x), mods, _bf16(ck), _bf16(cv)


@pytest.mark.parametrize("norm", ["adaln", "none"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_pass_twin_equals_jax_bitwise(norm, dtype, static):
    """The quantize pass's plain version: its int8 rows equal JAX's
    ``_quant(_prologue(x, mod, norm))``, and its row max gives JAX's row
    scale (max(amax, 1e-8) / 127), bit for bit. AdaLN on rows whose
    statistics are exact in any order (``_pm_rows``); no norm on Gaussian
    rows."""
    rng = np.random.default_rng(3)
    x = _pm_rows(rng, M, D) if norm == "adaln" else rng.standard_normal((M, D)).astype(np.float32)
    mod = (rng.standard_normal((2, D)) * 0.2).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    s = STATIC[0] if static else None
    jh = JQ._prologue(jx.astype(jnp.float32), jnp.asarray(mod[0:1]), jnp.asarray(mod[1:2]), norm)
    jq, js = JB._quant(jh, s)
    tq, amax = TB.quantize_rows_reference(tx, torch.from_numpy(mod) if norm == "adaln" else None,
                                          static_s=s)
    assert tq.dtype == torch.int8 and tq.shape == (M, D)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if static:
        assert amax is None
    else:
        np.testing.assert_array_equal((amax.clamp_min(1e-8) / 127.0).numpy(),
                                      np.asarray(js)[:, 0])


def _plain_mha(n_head, valid, attn):
    return lambda q, k, v: TB._ref_mha(q, k, v, B, n_head, valid, attn).bfloat16()


def _layer_weights(seed, w4):
    """Per layer: q, k, v, proj, crossq, crossproj (JAX's, for the oracles)."""
    return [_jweights(seed + 10 * i, 6, w4) for i in range(LAYERS)]


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("attn", ["bf16", "bf16_fold", "pair", "int8"])
def test_schedule_equals_block_twins_bitwise(w4, static, attn):
    """Two layers of K4 then K5, each half the five-step schedule from plain
    pieces, equal to ``self_attn_block_reference`` and
    ``cross_attn_block_reference`` composed the same way, bit for bit."""
    (_, x), mods, (_, ck), (_, cv) = _inputs()
    layers = [[_tw(w) for w in lw] for lw in _layer_weights(40, w4)]
    ss = STATIC if static else None
    got = want = x
    for ws, m in zip(layers, torch.from_numpy(mods)):
        got = TB._attn_half(got, m[0:2], ws[0:3], ws[3], *(ss or (None, None)), x.dtype, w4,
                            _plain_mha(H, L - 3, attn))
        got = TB._attn_half(got, m[2:4], ws[4:5], ws[5], *(ss or (None, None)), x.dtype, w4,
                            _plain_mha(H, S - 4, attn), kv=(ck, cv))
        want = TB.self_attn_block_reference(want, m[0:2], *ws[0:4], batch=B, n_head=H,
                                            q_valid=L - 3, static_s=ss, w4=w4, attn=attn)
        want = TB.cross_attn_block_reference(want, m[2:4], ck, cv, *ws[4:6], batch=B, n_head=H,
                                             kv_valid=S - 4, static_s=ss, w4=w4, attn=attn)
    assert got.dtype == torch.bfloat16 and got.shape == (M, D)
    assert torch.equal(got, want)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("attn", ["bf16", "pair", "int8"])
def test_schedule_equals_pair_twin_bitwise(static, attn):
    """K8's schedule, two layers: the self half writes x + proj in f32, the
    cross half's quantize pass reads it and its proj adds it and rounds
    once; equal to ``attn_pair_block_reference`` bit for bit."""
    (_, x), mods, (_, ck), (_, cv) = _inputs(1)
    layers = [[_tw(w) for w in lw] for lw in _layer_weights(60, False)]
    ss = STATIC * 2 if static else None
    s1, s2 = (ss[:2], ss[2:]) if ss else ((None, None), (None, None))
    got = want = x
    for ws, m in zip(layers, torch.from_numpy(mods)):
        x1 = TB._attn_half(got, m[0:2], ws[0:3], ws[3], *s1, torch.float32, False,
                           _plain_mha(H, L - 3, attn))
        assert x1.dtype == torch.float32
        got = TB._attn_half(x1, m[2:4], ws[4:5], ws[5], *s2, x.dtype, False,
                            _plain_mha(H, S - 4, attn), kv=(ck, cv))
        want = TB.attn_pair_block_reference(want, m, ck, cv, *ws, batch=B, n_head=H,
                                            q_valid=L - 3, kv_valid=S - 4, static_s=ss, attn=attn)
    assert torch.equal(got, want)


def test_quantize_rows_runs_the_twin_on_cpu_and_counts_no_launch():
    (_, x), mods, _, _ = _inputs(2)
    before = TB.quantize_rows.launches
    got = TB.quantize_rows(x, torch.from_numpy(mods[0, 0:2]), static_s=None)
    want = TB.quantize_rows_reference(x, torch.from_numpy(mods[0, 0:2]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TB.quantize_rows.launches == before


@pytest.mark.parametrize("mha_mode", ["base", "pair"])
@pytest.mark.parametrize("case", ["self W4 dynamic", "self W8 static", "cross W4 static",
                                  "cross W8 dynamic"])
def test_schedule_matches_jax_kernels_interpret(case, mha_mode):
    """The schedule from plain pieces against JAX's ``self_attn_block`` /
    ``cross_attn_block`` Pallas kernels in interpret mode (their MHA
    ``mha_mode``, the port's ``attn`` "bf16" or "pair"), within TOL."""
    block, wbits, scales = case.split()
    w4, static = wbits == "W4", scales == "static"
    (jx, tx), mods, (jck, tck), (jcv, tcv) = _inputs(3)
    jws = _jweights(80, 4 if block == "self" else 2, w4)
    ws = [_tw(w) for w in jws]
    ss = STATIC if static else None
    attn = "bf16" if mha_mode == "base" else "pair"
    m = torch.from_numpy(mods[0, 0:2])
    kw = dict(batch=B, n_head=H, interpret=True, static_s=ss, w4=w4, mha_mode=mha_mode)
    if block == "self":
        want = JB.self_attn_block(jx, jnp.asarray(mods[0, 0:2]), *jws, q_valid=L - 3, **kw)
        got = TB._attn_half(tx, m, ws[0:3], ws[3], *(ss or (None, None)), tx.dtype, w4,
                            _plain_mha(H, L - 3, attn))
    else:
        want = JB.cross_attn_block(jx, jnp.asarray(mods[0, 0:2]), jck, jcv, *jws,
                                   kv_valid=S - 4, **kw)
        got = TB._attn_half(tx, m, ws[0:1], ws[1], *(ss or (None, None)), tx.dtype, w4,
                            _plain_mha(H, S - 4, attn), kv=(tck, tcv))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)
