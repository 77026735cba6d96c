"""The port's weight quantization and plain quantized dense against the JAX
package (``ops/quant.py``).

The port stores ``w_q`` as (N, K) (the torch ``Linear`` layout) where the JAX
package stores (K, N); the values must be bit-identical, so every exact check
compares the port's array with the JAX array transposed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_to_sound_synthesis_tpu.ops import quant as jq
from text_to_sound_synthesis_torch.ops import quant as tq

torch.set_num_threads(1)

K, N, M = 128, 96, 24
TOL = 2e-2   # bf16 outputs: 1 bf16 ulp at |y| ~ 2, as tests/test_int8_blocks.py


def _weight(seed, k=K, n=N, scale=0.05):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * scale).astype(np.float32)   # JAX layout (K, N)
    w[3, 5] = 0.0                                                   # a zero and
    w[:, 7] = 0.0                                                   # an all-zero column
    b = (rng.standard_normal(n) * 0.05).astype(np.float32)
    return w, b


def _port(w, b, fn):
    return fn(torch.from_numpy(w.T.copy()), torch.from_numpy(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_weight_bit_identical(seed):
    w, b = _weight(seed)
    want = jq.quantize_weight(jnp.asarray(w), jnp.asarray(b))
    got = _port(w, b, tq.quantize_weight)
    assert got.w_q.dtype == torch.int8 and got.w_q.shape == (N, K)
    np.testing.assert_array_equal(got.w_q.numpy().T, np.asarray(want.w_q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale)[0])
    np.testing.assert_array_equal(got.bias.numpy(), np.asarray(want.bias)[0])


def test_round_half_to_even_as_jax():
    """Values exactly on .5 steps of the grid round to even on both sides."""
    w = np.zeros((8, 2), np.float32)
    w[:, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]       # scale 1: exact halves
    w[:, 1] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    want = jq.quantize_weight(jnp.asarray(w))
    got = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(got.w_q.numpy().T, np.asarray(want.w_q))
    np.testing.assert_array_equal(got.w_q.numpy()[0, 1:], [0, 2, 2, 0, -2, -2, 4])
    want4 = jq.quantize_weight_w4(jnp.asarray(w))
    got4 = tq.quantize_weight_w4(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(got4.w_q.numpy().T, np.asarray(want4.w_q))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_weight_w4_bit_identical(seed):
    w, b = _weight(seed)
    want = jq.quantize_weight_w4(jnp.asarray(w), jnp.asarray(b))
    got = _port(w, b, tq.quantize_weight_w4)
    assert got.w_q.shape == (N, K // 2)
    np.testing.assert_array_equal(got.w_q.numpy().T, np.asarray(want.w_q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale)[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_unpack_weight_w4_bit_identical(seed):
    w, b = _weight(seed)
    want = jq.unpack_weight_w4(jq.quantize_weight_w4(jnp.asarray(w), jnp.asarray(b)))
    got = tq.unpack_weight_w4(_port(w, b, tq.quantize_weight_w4))
    assert got.w_q.shape == (N, K) and got.w_q.dtype == torch.int8
    np.testing.assert_array_equal(got.w_q.numpy().T, np.asarray(want.w_q))


def test_w4_nibbles_cover_the_int4_range():
    """Every value in [-7, 7] in either half packs and unpacks to itself
    (low nibble = w[:, :K/2], high nibble = w[:, K/2:])."""
    vals = np.arange(-7, 8, dtype=np.float32)
    lo, hi = np.meshgrid(vals, vals)
    w = np.concatenate([lo.reshape(1, -1), hi.reshape(1, -1)], axis=1)   # (1, 2*225)
    w[0, 0] = 7.0                                                         # amax 7 -> scale 1
    p = tq.quantize_weight_w4(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.unpack_weight_w4(p).w_q.numpy(), w.astype(np.int8))


@pytest.mark.parametrize("norm,act,res,s_static", [
    ("none", "none", False, None),
    ("adaln", "none", False, None),
    ("ln", "gelu2", False, None),
    ("none", "none", True, None),
    ("adaln", "none", True, 0.03),
    ("ln", "gelu2", False, 0.05),
])
def test_quant_dense_matches_jax(norm, act, res, s_static):
    rng = np.random.default_rng(5)
    w, b = _weight(3)
    x = rng.standard_normal((M, K)).astype(np.float32)
    mod = np.stack([rng.standard_normal(K) * 0.2, rng.standard_normal(K) * 0.2]).astype(np.float32)
    if norm == "ln":
        mod[0] += 1.0
    r = rng.standard_normal((M, N)).astype(np.float32) if res else None
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jq.quant_dense_reference(jx, jq.quantize_weight(jnp.asarray(w), jnp.asarray(b)),
                                    norm=norm, mod=jnp.asarray(mod), act=act,
                                    residual=None if r is None else jnp.asarray(r, jnp.bfloat16),
                                    s_static=s_static)
    got = tq.quant_dense_reference(
        torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16(), _port(w, b, tq.quantize_weight),
        norm=norm, mod=torch.from_numpy(mod), act=act,
        residual=None if r is None else torch.from_numpy(r).bfloat16(), s_static=s_static)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL)
    assert tq.quant_dense_xla is tq.quant_dense_reference


def test_static_quantize_rounds_reciprocal_to_f32():
    """h * f32(1/s): the reciprocal taken in double and rounded once, as the
    JAX package's Python float is; values beyond 127 s saturate."""
    s = 0.037
    h = torch.tensor([[0.0, 1.0, -1.0, 5.0, -5.0, 0.0185]])
    q, s_out = tq._quantize_static(h, s)
    inv = np.float32(1.0 / s)
    want = np.clip(np.round(h.numpy() * inv), -127, 127)
    np.testing.assert_array_equal(q.numpy(), want)
    assert q.numpy()[0, 3] == 127 and q.numpy()[0, 4] == -127
    assert s_out == float(np.float32(s))
    jqv, _ = jq._quantize_static(jnp.asarray(h.numpy()), s)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))


def test_int_dot_is_exact_at_the_worst_case():
    """127 * 127 * 4096 is exact in the float64 dot."""
    q = torch.full((2, 4096), 127, dtype=torch.int8)
    w = torch.full((3, 4096), -127, dtype=torch.int8)
    got = tq.int_dot(q, w)
    assert float(got[0, 0]) == -127 * 127 * 4096
