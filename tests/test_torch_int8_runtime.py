"""The port's int8 serving engine against the JAX package's: quantization of
the denoiser, the engine bridge, calibration, the backbone, and the sampler
loop as a whole; plus the composite's serving entry points.

Geometry of tests/test_int8_runtime.py (2 layers, D 128, 4 heads, L 15,
condition 7 x 64, 10 steps, 16 codes + MASK). The JAX denoiser's parameters
are loaded into the port's with ``convert.from_jax.load_diffusion``; engines
move between the packages with ``convert.from_jax.load_int8_engine``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.models.diffusion import DiscreteDiffusion as JDiffusion
from text_to_sound_synthesis_tpu.models.diffusion import calibrate as jcal
from text_to_sound_synthesis_tpu.models.diffusion import int8_runtime as jrt
from text_to_sound_synthesis_tpu.models.diffusion.process import _timestep_plan
from text_to_sound_synthesis_tpu.ops import fused_sampler as jfs
from text_to_sound_synthesis_tpu.ops import int8_block as JB
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.diffusion import calibrate as tcal
from text_to_sound_synthesis_torch.models.diffusion import int8_runtime as trt
from text_to_sound_synthesis_torch.models.diffusion.process import DiscreteDiffusion

torch.set_num_threads(1)

T, L, NUM_EMBED, D, HEADS, COND_DIM, S, B = 10, 15, 16, 128, 4, 64, 7, 2
K = NUM_EMBED + 1
TOL = 2e-2
TCFG = {"params": dict(n_layer=2, n_embd=D, n_head=HEADS, content_seq_len=L,
                       condition_dim=COND_DIM, content_spatial_size=(3, 5),
                       block_activate="GELU2")}
ECFG = {"params": dict(num_embed=NUM_EMBED, embed_dim=D, spatial_size=(3, 5))}
DENSE = trt.DENSE_FIELDS


@pytest.fixture(scope="module")
def setup():
    jmodel = JDiffusion(transformer_config=TCFG, content_emb_config=ECFG, diffusion_step=T)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (B, L), 0, NUM_EMBED + 1)
    cond = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (B, S, COND_DIM)))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), tokens, jnp.asarray(cond), jnp.zeros((B,), jnp.int32)))
    port = from_jax.load_diffusion(
        DiscreteDiffusion(transformer_config=TCFG, content_emb_config=ECFG, diffusion_step=T),
        params)
    return jmodel, params, port, np.asarray(tokens, np.int32), cond


def _jqp(params, bits, **kw):
    return jrt.quantize_denoiser(params, n_head=HEADS, seq_len=L, num_timesteps=T,
                                 weight_bits=bits, **kw)


def _tqp(port, bits):
    return trt.quantize_denoiser(port, n_head=HEADS, seq_len=L, num_timesteps=T,
                                 weight_bits=bits)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_engines_equal(got, want, ada_rtol=1e-5):
    """Port engine vs JAX engine: int8 values, scales and the rest exact; the
    AdaLN tables (an f32 matmul in each framework) within ``ada_rtol``."""
    assert got.weight_bits == want.weight_bits and got.n_head == want.n_head
    assert len(got.layers) == len(want.layers)
    for gl, wl in zip(got.layers, want.layers):
        for f in DENSE:
            g, w = getattr(gl, f), getattr(wl, f)
            np.testing.assert_array_equal(g.w_q.numpy().T, np.asarray(w.w_q), err_msg=f)
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale)[0], err_msg=f)
            np.testing.assert_array_equal(g.bias.numpy(), np.asarray(w.bias)[0], err_msg=f)
        for f in ("ln2_mod", "ck_w", "ck_b", "cv_w", "cv_b"):
            np.testing.assert_array_equal(_np(getattr(gl, f)), np.asarray(getattr(wl, f), np.float32),
                                          err_msg=f)
        for f in ("ada1", "ada2"):
            np.testing.assert_allclose(_np(getattr(gl, f)), np.asarray(getattr(wl, f)),
                                       rtol=ada_rtol, atol=1e-6, err_msg=f)
    for f in ("tok_emb", "pos_emb", "norm_out", "head_w", "head_b"):
        np.testing.assert_array_equal(_np(getattr(got, f)), np.asarray(getattr(want, f), np.float32),
                                      err_msg=f)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_denoiser_matches_jax(setup, bits):
    _, params, port, _, _ = setup
    got, want = _tqp(port, bits), _jqp(params, bits)
    if bits == 4:
        assert got.layers[0].fc1.w_q.shape == (4 * D, D // 2)
    _assert_engines_equal(got, want)


def test_unpack_denoiser_matches_jax(setup):
    _, params, port, _, _ = setup
    got = trt.unpack_denoiser(_tqp(port, 4))
    want = jrt.unpack_denoiser(_jqp(params, 4))
    assert got.weight_bits == 8
    _assert_engines_equal(got, want)
    q8 = _tqp(port, 8)
    assert trt.unpack_denoiser(q8) is q8


def test_load_int8_engine_keeps_values_and_metadata(setup):
    _, params, port, _, _ = setup
    scales = tuple(tuple(0.01 * (i + 1) + 0.001 * j for j in range(6)) for i in range(2))
    jqp = _jqp(params, 4).replace(act_scales=scales)
    got = from_jax.load_int8_engine(jax.device_get(jqp), device="cpu")
    assert got.act_scales == scales and got.weight_bits == 4 and got.seq_len == L
    _assert_engines_equal(got, jqp, ada_rtol=0)


def _jax_kvs(jqp, cond):
    return jrt.precompute_cond_kvs(jqp, jnp.asarray(cond))


def test_precompute_cond_kvs_matches_jax(setup):
    _, params, _, _, cond = setup
    jqp = _jqp(params, 8)
    want = _jax_kvs(jqp, cond)
    got = trt.precompute_cond_kvs(from_jax.load_int8_engine(jqp, device="cpu"),
                                  torch.from_numpy(cond))
    for (gk, gv), (wk, wv) in zip(got, want):
        assert gk.shape == (B * S, D) and gk.dtype == torch.bfloat16
        np.testing.assert_allclose(gk.float().numpy(), np.asarray(wk, np.float32).reshape(B * S, D),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(gv.float().numpy(), np.asarray(wv, np.float32).reshape(B * S, D),
                                   rtol=TOL, atol=TOL)


def _jax_hidden_from_block_oracles(jqp, tokens, t, cond):
    """The JAX block oracles composed: what the kernels compute per layer."""
    kvs = _jax_kvs(jqp, cond)
    x = (jqp.tok_emb[jnp.asarray(tokens)] + jqp.pos_emb[None]).reshape(B * L, D)
    act = jqp.act_scales or ((None,) * 6,) * len(jqp.layers)
    pair = lambda s: None if s[0] is None else tuple(s)
    for lyr, (ck, cv), ls in zip(jqp.layers, kvs, act):
        x = JB.self_attn_block_reference(x, lyr.ada1[t].reshape(2, D), lyr.q, lyr.k, lyr.v,
                                         lyr.proj, batch=B, n_head=HEADS, q_valid=L,
                                         static_s=pair(ls[0:2]))
        x = JB.cross_attn_block_reference(x, lyr.ada2[t].reshape(2, D), ck.reshape(B * S, D),
                                          cv.reshape(B * S, D), lyr.crossq, lyr.crossproj,
                                          batch=B, n_head=HEADS, kv_valid=S,
                                          static_s=pair(ls[2:4]))
        x = JB.mlp_block_reference(x, lyr.ln2_mod, lyr.fc1, lyr.fc2, static_s=pair(ls[4:6]))
    return x


@pytest.mark.parametrize("static", [False, True])
def test_backbone_hidden_matches_jax_block_oracles(setup, static):
    """W4 engine: the port's layer loop (K4 -> K5 -> K3 twins on the packed
    weights) against the JAX block oracles on the unpacked weights."""
    _, params, _, tokens, cond = setup
    jqp = _jqp(params, 4)
    if static:
        jqp = jqp.replace(act_scales=((0.05, 0.03, 0.05, 0.03, 0.05, 0.01),) * 2)
    tqp = from_jax.load_int8_engine(jqp, device="cpu")
    want = _jax_hidden_from_block_oracles(jrt.unpack_denoiser(jqp), tokens, 3, cond)
    kvs = trt.precompute_cond_kvs(tqp, torch.from_numpy(cond))
    got = trt._int8_backbone_hidden(tqp, torch.from_numpy(tokens), 3, kvs)
    # two layers of bf16 blocks: an int8 flip in layer 0 reaches layer 1's
    # output at 1-2 bf16 ulps, so 3e-2 (tests/test_int8_blocks.py's tolerance
    # for two composed blocks, test_attn_pair_block)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=3e-2,
                               atol=3e-2)
    w8 = trt._int8_backbone_hidden(trt.unpack_denoiser(tqp), torch.from_numpy(tokens), 3, kvs)
    assert torch.equal(w8, got)   # W4 against the unpacked W8 engine: bitwise the same


def test_backbone_logits_track_jax_reference_impl(setup):
    """Against the JAX engine's own non-kernel path (impl="reference"), whose
    attention rounds scores to bf16, whose MLP middle is bf16 and whose
    logits are bf16. Those roundings alone move the JAX reference impl 1.6 %
    away from the JAX block oracles (the kernels' semantics) at this size;
    measured 1.7 % here, gated at 3.5 % (tests/test_int8_runtime.py's int8
    gate)."""
    _, params, _, tokens, cond = setup
    jqp = _jqp(params, 8)
    want = np.asarray(jrt.int8_backbone_logits(jqp, jnp.asarray(tokens), jnp.int32(3),
                                               _jax_kvs(jqp, cond), impl="reference"), np.float64)
    tqp = from_jax.load_int8_engine(jqp, device="cpu")
    got = trt.int8_backbone_logits(tqp, torch.from_numpy(tokens), 3,
                                   trt.precompute_cond_kvs(tqp, torch.from_numpy(cond)))
    assert got.shape == (B, L, NUM_EMBED) and got.dtype == torch.float32
    g = got.double().numpy()
    assert np.linalg.norm(g - want) / np.linalg.norm(want) < 0.035


def test_backbone_amax_matches_jax(setup):
    """Calibration's dynamic forward on fixed tokens: per-site maxima within
    2e-2 (relative; measured 0.8 %) and the logits within 3.5 % in norm
    (measured 1.8 %). The port follows the JAX pass op by op as JAX runs it
    eagerly; under jit XLA fuses the bf16 rounding of the attention scores
    away, which moves the JAX side by that much."""
    _, params, _, tokens, cond = setup
    jqp = _jqp(params, 8)
    kvs = _jax_kvs(jqp, cond)
    ck_st = jnp.stack([k.reshape(B, S, -1) for k, _ in kvs])
    cv_st = jnp.stack([v.reshape(B, S, -1) for _, v in kvs])
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jqp.layers)
    w_logits, w_amax = jcal._backbone_amax(jqp, jnp.asarray(tokens), 3, stacked, ck_st, cv_st)
    tqp = from_jax.load_int8_engine(jqp, device="cpu")
    g_logits, g_amax = tcal._backbone_amax(tqp, torch.from_numpy(tokens), 3,
                                           trt.precompute_cond_kvs(tqp, torch.from_numpy(cond)))
    assert g_amax.shape == (2, tcal.N_SITES)
    np.testing.assert_allclose(g_amax.numpy(), np.asarray(w_amax), rtol=TOL)
    g, w = g_logits.double().numpy(), np.asarray(w_logits, np.float64)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) < 0.035


# The sampler loop. The port's loop runs the kernels' semantics (the block
# twins, then K2's f32 logits). It is held against two JAX loops on the same
# Gumbel noise, each ending in head_sample_reference + argmax(post + noise):
#   - the JAX engine's non-kernel path, _int8_backbone_hidden(impl="reference"),
#     whose bf16 attention scores and bf16 MLP middle move its logits ~1.6 %
#     (see above); near-ties of the Gumbel argmax then flip, and a flip changes
#     every later step's input. Measured agreement 0.83 (W4 static) and 0.73
#     (W8 dynamic) of the 30 tokens; gated at 0.6.
#   - the JAX block oracles composed (the kernels' semantics), which differ
#     from the port only in f32 summation order: an ulp can still move an
#     int8 value across a .5 boundary and tip a near-tie. Measured 0.9 (W4
#     static) and 1.0 (W8 dynamic); gated at 0.85.
MIN_AGREEMENT_REFERENCE_IMPL = 0.6
MIN_AGREEMENT_BLOCK_ORACLES = 0.85


def _jax_loop(jqp, sched, cond, noise, hidden):
    ts, t_post = _timestep_plan(T, T, 0)
    tokens = jnp.full((B, L), K - 1, jnp.int32)
    for idx, (t, tp) in enumerate(zip(np.asarray(ts), np.asarray(t_post))):
        x = hidden(tokens, int(t))
        _, post = jfs.head_sample_reference(x, tokens.reshape(-1), jqp.norm_out, jqp.head_w,
                                            jqp.head_b, jfs.step_coeffs(sched, jnp.asarray(tp)),
                                            jax.random.PRNGKey(0), truncation_r=0.85)
        tokens = jnp.argmax(post + noise[idx].reshape(B * L, K), axis=-1).astype(jnp.int32)
        tokens = tokens.reshape(B, L)
    return np.asarray(tokens)


@pytest.mark.parametrize("bits,static", [(4, True), (8, False)])
def test_sampler_loop_matches_jax_loops(setup, bits, static):
    jmodel, params, _, _, cond = setup
    jqp = _jqp(params, bits)
    if static:
        jqp = jqp.replace(act_scales=jcal.calibrate_act_scales(
            jrt.unpack_denoiser(jqp), jmodel.schedule(), jax.random.PRNGKey(3),
            jnp.asarray(cond), truncation_r=0.85))
    n_steps = len(_timestep_plan(T, T, 0)[0])
    noise = np.random.default_rng(11).gumbel(size=(n_steps, B, L, K)).astype(np.float32)
    ref = jrt.unpack_denoiser(jqp)
    kvs = _jax_kvs(ref, cond)
    sched = jmodel.schedule()
    want_impl = _jax_loop(ref, sched, cond, noise, lambda tok, t: jrt._int8_backbone_hidden(
        ref, tok, jnp.int32(t), kvs, impl="reference")[0])
    want_blocks = _jax_loop(ref, sched, cond, noise,
                            lambda tok, t: _jax_hidden_from_block_oracles(ref, tok, t, cond))

    tqp = from_jax.load_int8_engine(jqp, device="cpu")
    port_sched = DiscreteDiffusion(transformer_config=TCFG, content_emb_config=ECFG,
                                   diffusion_step=T).schedule()
    got = trt.sample_tokens_int8(tqp, port_sched, torch.from_numpy(cond),
                                 generator=torch.Generator().manual_seed(0), truncation_r=0.85,
                                 noise=torch.from_numpy(noise)).numpy()
    assert got.shape == (B, L) and ((got >= 0) & (got < NUM_EMBED)).all()
    agree_impl = float((got == want_impl).mean())
    agree_blocks = float((got == want_blocks).mean())
    assert agree_blocks >= MIN_AGREEMENT_BLOCK_ORACLES, agree_blocks
    assert agree_impl >= MIN_AGREEMENT_REFERENCE_IMPL, agree_impl


def test_sampler_without_noise_is_seeded_and_valid(setup):
    _, params, port, _, cond = setup
    tqp = _tqp(port, 4)
    sched = port.schedule()
    run = lambda seed, **kw: trt.sample_tokens_int8(
        tqp, sched, torch.from_numpy(cond), generator=torch.Generator().manual_seed(seed),
        truncation_r=0.85, **kw)
    a = run(0)
    assert torch.equal(a, run(0)) and not torch.equal(a, run(1))
    assert ((a >= 0) & (a < NUM_EMBED)).all()
    assert run(0, skip_step=3).shape == (B, L)


def test_calibrate_act_scales_gives_six_positive_scales_per_layer(setup):
    _, _, port, _, cond = setup
    tqp = _tqp(port, 4)
    scales = tcal.calibrate_act_scales(tqp, port.schedule(), torch.from_numpy(cond),
                                       generator=torch.Generator().manual_seed(0),
                                       truncation_r=0.85)
    assert len(scales) == 2 and all(len(r) == 6 and min(r) > 0 for r in scales)
    assert tqp.weight_bits == 4   # calibrated on the unpacked twin, engine untouched


# ---------------------------------------------------------------------------
# the composite: quantize_for_serving -> calibrate_serving_engine -> generate_int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The tiny composite of tests/test_torch_slice.py, seeded at random."""
    from test_torch_slice import TINY_CFG, _cond_tokens

    return build_model(TINY_CFG, device="cpu", seed=0), torch.from_numpy(_cond_tokens())


def test_serving_entry_points_end_to_end(tiny):
    model, cond = tiny
    qp = model.quantize_for_serving(weight_bits=4)
    assert qp.weight_bits == 4 and qp.act_scales is None and qp.n_head == 2
    assert model.calibrate_serving_engine(qp, torch.Generator().manual_seed(0), cond) is qp
    assert len(qp.act_scales) == 2 and all(len(r) == 6 for r in qp.act_scales)
    noise = torch.from_numpy(np.random.default_rng(4).gumbel(size=(4, B, 16, 11)).astype(np.float32))
    mel, tokens = model.generate_int8(qp, torch.Generator().manual_seed(1), cond,
                                      noise=noise, return_tokens=True)
    assert mel.shape == (B, 4, 16, 1) and torch.isfinite(mel).all()
    assert ((tokens >= 0) & (tokens < 10)).all()
    # the same request on the unpacked W8 engine: bitwise the same tokens
    _, w8 = model.generate_int8(trt.unpack_denoiser(qp), torch.Generator().manual_seed(1), cond,
                                noise=noise, return_tokens=True)
    assert torch.equal(w8, tokens)


@pytest.mark.parametrize("sample_type", ["top100p", "top0.85r,q0.5"])
def test_generate_int8_raises_for_other_sample_types(tiny, sample_type):
    model, cond = tiny
    qp = model.quantize_for_serving()
    with pytest.raises(ValueError, match="int8 serving"):
        model.generate_int8(qp, torch.Generator().manual_seed(0), cond, sample_type=sample_type)
    with pytest.raises(ValueError, match="int8 serving"):
        model.calibrate_serving_engine(qp, torch.Generator().manual_seed(0), cond,
                                       sample_type=sample_type)
