"""K6's and the MLP blocks' schedules on the card, composed from plain pieces
on the CPU, against the twins and the JAX package.

On the card K6 (``fused_quant_dense[_multi]``) is a quantize pass (the row
pass with its LN / AdaLN at K <= 1024, the wide pass else) and one dot in
the Hopper GEMM's int8 A mode (``quant._dense_schedule``); K3 and K9 under
dynamic scales are fc1, the wide pass over the middle (each chunk with its
own row scale) and fc2, K9's with the chunked epilogue (``int8_block._mlp``).
The same schedules run on CPU tensors from the plain pieces: here they are
held bit for bit against ``quant_dense_reference``, ``mlp_block_reference``
and ``mlp_chunked_reference``, the passes' twins bit for bit against JAX's
``_prologue`` + ``_quant``, and the schedules once each within 2e-2 of JAX's
Pallas kernels in interpret mode.

Same numpy inputs through the JAX functions and the port's: M 80 rows, D
256, Dh 1024.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_to_sound_synthesis_tpu.ops import int8_block as JB
from text_to_sound_synthesis_tpu.ops import quant as JQ
from text_to_sound_synthesis_torch.ops import int8_block as TB
from text_to_sound_synthesis_torch.ops import quant as TQ
from text_to_sound_synthesis_torch.ops.quant import QuantizedWeight

torch.set_num_threads(1)

M, D, DH = 80, 256, 1024
TOL = 2e-2          # bf16 block outputs, as tests/test_torch_int8_blocks.py
STATIC = 0.03


def _tw(jw):
    """JAX QuantizedWeight (K, N) -> the port's (N, K), same int8 values."""
    return QuantizedWeight(torch.from_numpy(np.array(jw.w_q).T.copy()),
                           torch.from_numpy(np.array(jw.scale)[0]),
                           torch.from_numpy(np.array(jw.bias)[0]))


def _jweight(seed, k, n, w4=False):
    rng = np.random.default_rng(seed)
    q = JQ.quantize_weight_w4 if w4 else JQ.quantize_weight
    return q(jnp.asarray((rng.standard_normal((k, n)) * 0.05 * (256 / k) ** 0.5).astype(np.float32)),
             jnp.asarray((rng.standard_normal(n) * 0.05).astype(np.float32)))


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _pm_rows(rng, rows, width):
    """Rows half +2^e, half -2^e (e in 3..5 per row), in a random order: their
    LayerNorm statistics are exact in f32 in any order, and 4^e + 1e-6 rounds
    to 4^e, whose 1/sqrt is exact, so any two LayerNorms of them agree bit
    for bit (XLA's CPU rsqrt lies an ulp from torch's elsewhere)."""
    x = np.ones((rows, width), np.float32)
    x[:, width // 2:] = -1.0
    x = np.take_along_axis(x, np.argsort(rng.random((rows, width)), axis=1), axis=1)
    return x * 2.0 ** rng.integers(3, 6, (rows, 1))


def _mod(rng, width, ln):
    m = (rng.standard_normal((2, width)) * 0.2).astype(np.float32)
    if ln:
        m[0] += 1.0
    return m


# ---------------------------------------------------------------------------
# the passes' twins against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("static", [False, True])
def test_row_pass_ln_twin_equals_jax_bitwise(dtype, static):
    """The row pass with the affine LN (K6's fc1 site): its int8 rows equal
    JAX's ``_quant(_prologue(x, mod, "ln"))`` and its row max gives JAX's row
    scale, bit for bit, on rows of +-2^e."""
    rng = np.random.default_rng(3)
    x = _pm_rows(rng, M, D)
    mod = _mod(rng, D, ln=True)
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    s = STATIC if static else None
    jh = JQ._prologue(jx.astype(jnp.float32), jnp.asarray(mod[0:1]), jnp.asarray(mod[1:2]), "ln")
    jq, js = JB._quant(jh, s)
    tq, amax = TQ.quantize_rows_reference(tx, torch.from_numpy(mod), static_s=s, norm="ln")
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    if static:
        assert amax is None
    else:
        np.testing.assert_array_equal((amax.clamp_min(1e-8) / 127.0).numpy(), np.asarray(js)[:, 0])


@pytest.mark.parametrize("rows", ["+-2^e", "Gaussian"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["own max", "nch 4", "nch 16", "static"])
def test_wide_pass_twin_equals_jax_bitwise(rows, dtype, mode):
    """The wide pass's plain version (no norm, rows of Dh): its int8 rows
    equal JAX's ``_quant`` of each row (own max), of each chunk of the row
    with the chunk's own max given (``_mlp_chunked_kernel``'s per-chunk
    quantize), or static; the maxima give JAX's scales, bit for bit."""
    rng = np.random.default_rng(4)
    x = _pm_rows(rng, M, DH) if rows == "+-2^e" else rng.standard_normal((M, DH)).astype(np.float32)
    x = x * rng.uniform(0.5, 2.0, (M, DH)).astype(np.float32) if rows == "Gaussian" else x
    jx = jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jh = jx.astype(jnp.float32)
    if mode == "static":
        jq, _ = JB._quant(jh, STATIC)
        tq, amax = TQ.quantize_wide_reference(tx, static_s=STATIC)
        assert amax is None
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        return
    nch = 1 if mode == "own max" else int(mode.split()[1])
    ck = DH // nch
    parts = [JB._quant(jh[:, c * ck:(c + 1) * ck], None) for c in range(nch)]
    jq = np.concatenate([np.asarray(q) for q, _ in parts], axis=1)
    js = np.concatenate([np.asarray(s) for _, s in parts], axis=1)
    if mode == "own max":
        tq, amax = TQ.quantize_wide_reference(tx)
        amax = amax[:, None]
    else:
        given = tx.float().abs().reshape(M, nch, ck).amax(-1)
        tq, amax = TQ.quantize_wide_reference(tx, amax=given)
        assert amax is given
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal((amax.clamp_min(1e-8) / 127.0).numpy(), js)


def test_wide_pass_runs_the_twin_on_cpu_and_counts_no_launch():
    x = torch.randn((M, DH))
    before = TQ.quantize_wide.launches
    got = TQ.quantize_wide(x, amax=x.abs().reshape(M, 4, -1).amax(-1))
    want = TQ.quantize_wide_reference(x, amax=x.abs().reshape(M, 4, -1).amax(-1))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert TQ.quantize_wide.launches == before


# ---------------------------------------------------------------------------
# K6: the pass and the int8-A-mode dot against quant_dense_reference
# ---------------------------------------------------------------------------

def _sites(rng):
    """K6's per-dense sites (q/k/v, proj, crossq, crossproj, fc1, fc2) and
    the single dense of chip_smoke.py (fc1, proj with an f32 output):
    (x, weights, kwargs)."""
    x = _bf16(rng.standard_normal((M, D)).astype(np.float32))[1]
    h = _bf16((rng.standard_normal((M, DH)) * 0.5).astype(np.float32))[1]
    mods = torch.from_numpy(_mod(rng, D, ln=False)), torch.from_numpy(_mod(rng, D, ln=False))
    ln = torch.from_numpy(_mod(rng, D, ln=True))
    w = lambda i, k, n: _tw(_jweight(100 + i, k, n))
    return {"qkv": (x, [w(i, D, D) for i in range(3)], dict(norm="adaln", mod=mods[0])),
            "proj": (x, [w(3, D, D)], dict(residual=x)),
            "crossq": (x, [w(4, D, D)], dict(norm="adaln", mod=mods[1])),
            "crossproj": (x, [w(5, D, D)], dict(residual=x)),
            "fc1": (x, [w(6, D, DH)], dict(norm="ln", mod=ln, act="gelu2")),
            "fc2": (h, [w(7, DH, D)], dict(residual=x)),
            "single fc1": (x, [w(6, D, DH)], dict(norm="ln", mod=ln, act="gelu2")),
            "single proj f32": (x, [w(3, D, D)], dict(residual=x, out_dtype=torch.float32))}


@pytest.mark.parametrize("site", ["qkv", "proj", "crossq", "crossproj", "fc1", "fc2", "single fc1",
                                  "single proj f32"])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
def test_dense_schedule_equals_twin_bitwise(site, static, out_dtype):
    """K6's schedule from plain pieces (``quant._dense_schedule``: the row or
    the wide pass, then ``_dense_int8``) equal to
    ``quant_dense_multi_reference`` bit for bit, at each site, dynamic and
    static, bf16 and f32 out; the pass is the wide one only past the row
    pass's width (fc2)."""
    x, ws, kw = _sites(np.random.default_rng(5))[site]
    kw = dict(dict(norm="none", mod=None, act="none", residual=None,
                   out_dtype=getattr(torch, out_dtype)), **kw,
              s_static=STATIC if static else None)
    rows, wide = TQ.quantize_rows.launches, TQ.quantize_wide.launches
    got = TQ._dense_schedule(x, ws, **kw)
    want = TQ.quant_dense_multi_reference(x, ws, **kw)
    assert len(got) == len(ws)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (TQ.quantize_rows.launches, TQ.quantize_wide.launches) == (rows, wide)   # CPU: none


# ---------------------------------------------------------------------------
# K3 and K9: fc1, the wide pass, fc2 (chunked) against their twins
# ---------------------------------------------------------------------------

def _mlp_inputs(seed, w4=False):
    rng = np.random.default_rng(seed)
    jx, tx = _bf16(rng.standard_normal((M, D)).astype(np.float32))
    mod = _mod(rng, D, ln=True)
    jw1, jw2 = _jweight(seed + 1, D, DH, w4), _jweight(seed + 2, DH, D, w4)
    return (jx, jnp.asarray(mod), jw1, jw2), (tx, torch.from_numpy(mod), _tw(jw1), _tw(jw2))


@pytest.mark.parametrize("n_chunks", [1, 4, 16])
@pytest.mark.parametrize("static", [False, True])
def test_mlp_schedule_equals_chunked_twin_bitwise(n_chunks, static):
    """K9's schedule from plain pieces (``int8_block._mlp``: fc1 with its
    per-(row, chunk) maxima, the wide pass, the chunked fc2) equal to
    ``mlp_chunked_reference`` bit for bit at 1, 4 and 16 chunks."""
    _, (x, mod, w1, w2) = _mlp_inputs(20)
    ss = (STATIC, 0.012) if static else None
    got = TB._mlp(x, mod, w1, w2, ss, False, n_chunks)
    want = TB.mlp_chunked_reference(x, mod, w1, w2, n_chunks=n_chunks, static_s=ss)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("w4", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_mlp_schedule_equals_block_twin_bitwise(w4, static):
    """K3's schedule from plain pieces (under dynamic scales fc1, the wide
    pass over its whole middle, fc2) equal to ``mlp_block_reference`` bit for
    bit, W8 and W4."""
    _, (x, mod, w1, w2) = _mlp_inputs(30, w4)
    ss = (STATIC, 0.012) if static else None
    got = TB._mlp(x, mod, w1, w2, ss, w4)
    want = TB.mlp_block_reference(x, mod, w1, w2, static_s=ss, w4=w4)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the schedules against the JAX Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

def test_dense_schedule_matches_jax_kernel_interpret():
    """K6's schedule at the q/k/v site (AdaLN, three weights, dynamic)
    against JAX's ``fused_quant_dense_multi`` in interpret mode, within TOL."""
    rng = np.random.default_rng(40)
    jx, tx = _bf16(rng.standard_normal((M, D)).astype(np.float32))
    mod = _mod(rng, D, ln=False)
    jws = [_jweight(41 + i, D, D) for i in range(3)]
    want = JQ.fused_quant_dense_multi(jx, jws, norm="adaln", mod=jnp.asarray(mod), block_m=16,
                                      interpret=True)
    got = TQ._dense_schedule(tx, [_tw(w) for w in jws], norm="adaln", mod=torch.from_numpy(mod),
                             act="none", residual=None, out_dtype=torch.bfloat16, s_static=None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), rtol=TOL, atol=TOL)


def test_mlp_schedule_matches_jax_kernel_interpret():
    """K9's schedule (4 chunks, dynamic) against JAX's ``mlp_block_chunked``
    in interpret mode, within TOL."""
    (jx, jmod, jw1, jw2), (x, mod, w1, w2) = _mlp_inputs(50)
    want = JB.mlp_block_chunked(jx, jmod, jw1, jw2, block_m=16, n_chunks=4, interpret=True)
    got = TB._mlp(x, mod, w1, w2, None, False, 4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


def test_bench_schedules_refuses_unknown_names_and_needs_a_card():
    """The A/B tool of these schedules: an unknown name exits 2; without a
    card it exits 1 and measures nothing."""
    from text_to_sound_synthesis_torch.tools import bench_schedules

    assert bench_schedules.main(["nope"]) == 2
    assert bench_schedules.main(["qkv", "k9_4"]) == (0 if torch.cuda.is_available() else 1)
