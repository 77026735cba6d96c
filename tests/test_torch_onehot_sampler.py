"""The port's one-hot reference sampler and the rest of Diffsound's inference
API against the JAX package, on the same numpy inputs and weights.

The JAX side draws from its own key schedule (``sample_tokens``: a start
key split off first, then ``split(key, 4)`` a step for the step's Gumbel
noise, the q-resample's coin and the resample's noise); the port is given
those very draws (``OneHotDraws``), so the tokens must agree exactly. The
tiny composite and the draws are ``tests/test_torch_slice.py``'s.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_slice import (ATOL, B, T_STEPS, _cond_tokens, _jax_slice, _jdiffsound,
                                    _port_slice, jax_draws)
from text_to_sound_synthesis_tpu.models.diffusion.process import (
    DiscreteDiffusion as JDiffusion, _timestep_plan)
from text_to_sound_synthesis_tpu.models.diffusion.process import sample_tokens as jsample_tokens
from text_to_sound_synthesis_tpu.ops import diffusion as jdd
from text_to_sound_synthesis_tpu.ops import fused_sampler as jfs
from text_to_sound_synthesis_tpu.ops import sampling as jsampling
from text_to_sound_synthesis_torch.models.diffusion.process import OneHotDraws, sample_tokens
from text_to_sound_synthesis_torch.ops import diffusion as tdd
from text_to_sound_synthesis_torch.ops import fused_sampler as tfs
from text_to_sound_synthesis_torch.ops import sampling as tsampling

torch.set_num_threads(1)

L, K = 16, 11          # the tiny composite's tokens and classes (10 codes + MASK)
# q_posterior in log space, f32 on both sides: the same ops, sums in another order
POST_ATOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _cond_emb():
    jclip, _, _, params, _ = _jax_slice()
    return np.asarray(jax.jit(jclip.apply)(params["cond"], jnp.asarray(_cond_tokens())))


# -- ops ----------------------------------------------------------------------------

def _posterior_inputs(seed: int, T: int, Kc: int):
    rng = np.random.default_rng(seed)
    sched_j = jdd.make_schedule(T, Kc)
    logits = rng.standard_normal((2, 24, Kc - 1)).astype(np.float32) * 2
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    log_x0 = np.concatenate([lp, np.full((2, 24, 1), -70.0, np.float32)], axis=-1)
    xt = rng.integers(0, Kc, (2, 24))
    xt[:, ::3] = Kc - 1                                   # MASK and non-MASK positions
    return sched_j, log_x0, xt


@pytest.mark.parametrize("t", [0, 1, 50, 99])
def test_q_posterior_matches_jax(t):
    sched_j, log_x0, xt = _posterior_inputs(0, 100, 257)
    tv = np.full((2,), t, np.int32)
    log_xt_j = jdd.index_to_log_onehot(jnp.asarray(xt), 257)
    want = np.asarray(jdd.q_posterior(sched_j, jnp.asarray(log_x0), log_xt_j, jnp.asarray(tv)))
    sched = tdd.make_schedule(100, 257)
    got = tdd.q_posterior(sched, _t(log_x0), tdd.index_to_log_onehot(_t(xt), 257), _t(tv))
    np.testing.assert_allclose(got.numpy(), want, atol=POST_ATOL, rtol=0)
    # q_pred_one_timestep alone, and the leak of the LOG_EPS placeholder kept
    np.testing.assert_allclose(
        tdd.q_pred_one_timestep(sched, _t(log_x0), _t(tv)).numpy(),
        np.asarray(jdd.q_pred_one_timestep(sched_j, jnp.asarray(log_x0), jnp.asarray(tv))),
        atol=POST_ATOL, rtol=0)
    assert tdd.LOG_EPS == jdd.LOG_EPS


def _rows_with_ties(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((3, 7, 40)) * 2), axis=-1))
    lp = lp.astype(np.float32)
    lp[0, 0] = np.log(1.0 / 40)                           # a row of 40 tied values
    lp[1, 1, :6] = lp[1, 1].max()                         # ties at the top
    lp[2, 2, 10:20] = np.sort(lp[2, 2])[-5]               # ties around a k-th value
    return lp


@pytest.mark.parametrize("r", [0.3, 0.85, 0.99])
def test_truncate_top_r_matches_jax(r):
    lp = _rows_with_ties(1)
    want = np.asarray(jsampling.truncate_top_r(jnp.asarray(lp), r))
    np.testing.assert_array_equal(tsampling.truncate_top_r(_t(lp), r).numpy(), want)


@pytest.mark.parametrize("k", [1, 3, 5, 40, 100])
def test_truncate_top_k_matches_jax(k):
    lp = _rows_with_ties(2)
    want = np.asarray(jsampling.truncate_top_k(jnp.asarray(lp), k))
    np.testing.assert_array_equal(tsampling.truncate_top_k(_t(lp), k).numpy(), want)


def test_fused_nucleus_leaves_out_the_crossing_class():
    """The fused samplers' top-r nucleus (a bisection: keep p > tau, the
    largest set whose mass stays below r) is the sort rule's (the
    reference's and the one-hot sampler's: keep a class while the mass
    before it is below r) less the one class that crosses r, in JAX's
    fused twin as in the port's (JAX's own test allows this one class)."""
    rng = np.random.default_rng(7)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(rng.standard_normal((4, 50, 257)) * 2), axis=-1))
    lp = np.concatenate([lp.astype(np.float32), np.full((4, 50, 1), -70.0, np.float32)], axis=-1)
    sort_keep = tsampling.truncate_top_r(_t(lp), 0.85) > -70
    bisect_keep = tfs._truncate_rows(_t(lp), 0.85) > -70
    np.testing.assert_array_equal(sort_keep.numpy(),
                                  np.asarray(jsampling.truncate_top_r(jnp.asarray(lp), 0.85)) > -70)
    np.testing.assert_array_equal(bisect_keep.numpy(),
                                  np.asarray(jfs._truncate_rows(jnp.asarray(lp), 0.85)) > -70)
    assert bool((bisect_keep <= sort_keep).all())
    top_crosses = torch.from_numpy(np.exp(lp).max(-1) >= 0.85)
    extra = (sort_keep.sum(-1) - bisect_keep.sum(-1))
    assert torch.equal(extra, torch.where(top_crosses, 0, 1)) and int(extra.sum()) > 150
    # a tie at the crossing value: the sort rule keeps all of its classes
    tie = torch.log(torch.tensor([[0.4, 0.3, 0.1, 0.1, 0.1]]))
    assert tsampling.truncate_top_r(tie, 0.85).gt(-70).tolist() == [[True] * 5]
    assert tfs._truncate_rows(tie, 0.85).gt(-70).tolist() == [[True, True, False, False, False]]


def test_top_k_multinomial_matches_jax_categorical():
    """Under JAX's own Gumbel draws: ``jax.random.categorical`` is the
    argmax of that noise plus the logits."""
    logits = np.random.default_rng(3).standard_normal((4, 9, 50)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jsampling.top_k_multinomial(key, jnp.asarray(logits), 7, temperature=0.8))
    got = tsampling.top_k_multinomial(None, _t(logits), 7, temperature=0.8,
                                      gumbel=_t(jax.random.gumbel(key, logits.shape)))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tsampling.top_k_multinomial(torch.Generator().manual_seed(0), _t(logits), 7)
    kth = torch.topk(_t(logits), 7).values[..., -1:]
    assert bool((_t(logits).gather(-1, drawn[..., None]) >= kth).all())   # one of the top 7


def test_log_sample_categorical_with_supplied_noise_matches_jax():
    _, log_x0, _ = _posterior_inputs(4, 100, 257)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jdd.log_sample_categorical(key, jnp.asarray(log_x0)))
    got = tdd.log_sample_categorical(None, _t(log_x0),
                                     gumbel=_t(jax.random.gumbel(key, log_x0.shape)))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the sampler --------------------------------------------------------------------

def test_predict_start_matches_jax():
    _, jdiff, _, params, _ = _jax_slice()
    model, _ = _port_slice()
    cond = _cond_emb()
    toks = np.random.default_rng(5).integers(0, K, (B, L)).astype(np.int32)
    tv = np.array([3, 1], np.int32)
    want = np.asarray(jax.jit(partial(jdiff.apply, method=jdiff.predict_start))(
        params["diffusion"], jnp.asarray(toks), jnp.asarray(cond), jnp.asarray(tv)))
    with torch.no_grad():
        got = model.diffusion.predict_start(_t(toks), _t(cond), _t(tv))
        assert torch.equal(model.diffusion(_t(toks), _t(cond), _t(tv)), got)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert bool((got[..., -1] == -70.0).all())


def _filter(head: str):
    if head.endswith("r"):
        return (partial(jsampling.truncate_top_r, r=float(head[3:-1])),
                partial(tsampling.truncate_top_r, r=float(head[3:-1])))
    return (partial(jsampling.truncate_top_k, k=int(head[3:-1])),
            partial(tsampling.truncate_top_k, k=int(head[3:-1])))


# (filter head, skip_step, resample_q, filter_ratio, start): q 1 always
# resamples (the coin is in [0, 1)), q 0 never does
SAMPLER_CASES = {
    "top0.85r": ("top0.85r", 0, 0.0, 0.0, "mask"),
    "top3p": ("top3p", 0, 0.0, 0.0, "mask"),
    "top0.85r,fast2": ("top0.85r", 2, 0.0, 0.0, "mask"),
    "top0.85r,q0": ("top0.85r", 0, 0.0, 0.0, "mask"),
    "top0.85r,q1": ("top0.85r", 0, 1.0, 0.0, "mask"),
    "filter_ratio=0.5": ("top0.85r", 0, 0.0, 0.5, "q_sample"),
    "uniform_start": ("top3p", 0, 0.0, 0.0, "uniform"),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sample_tokens_matches_jax(case):
    head, skip, q, fr, start = SAMPLER_CASES[case]
    _, jdiff, _, params, _ = _jax_slice()
    model, _ = _port_slice()
    pdiff = model.diffusion
    if start == "uniform":    # the reference's sample_uniform_only, on its schedule
        jdiff = JDiffusion(transformer_config=jdiff.transformer_config,
                           content_emb_config=jdiff.content_emb_config,
                           diffusion_step=T_STEPS, schedule_kind="uniform_only")
        pdiff.schedule_kind = "uniform_only"
    cond = _cond_emb()
    content = np.random.default_rng(6).integers(0, K - 1, (B, L)).astype(np.int32)
    jfilter, tfilter = _filter(head)
    key = jax.random.PRNGKey(11)
    kw = dict(filter_ratio=fr, skip_step=skip, resample_q=q,
              uniform_start=start == "uniform")
    try:
        want, want_p = jsample_tokens(jdiff, params["diffusion"], key, jnp.asarray(cond),
                                      content_tokens=jnp.asarray(content) if fr else None,
                                      filter_fn=jfilter, return_logits=True, **kw)
        n_steps = len(_timestep_plan(T_STEPS, int(T_STEPS * fr) or T_STEPS, skip)[0])
        got, got_p = sample_tokens(pdiff, _t(cond), draws=jax_draws(key, n_steps, start),
                                   content_tokens=_t(content) if fr else None,
                                   filter_fn=tfilter, return_logits=True, **kw)
    finally:
        pdiff.schedule_kind = "mask_and_uniform"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert got.dtype == torch.int32 and bool(((got >= 0) & (got < K - 1)).all())


def test_sample_tokens_draws_from_generator():
    """Without supplied draws: seeded, and the start checks its inputs."""
    model, _ = _port_slice()
    cond = _t(_cond_emb())
    run = lambda seed, **kw: sample_tokens(model.diffusion, cond,
                                           generator=torch.Generator().manual_seed(seed),
                                           filter_fn=partial(tsampling.truncate_top_k, k=3), **kw)
    a = run(0, resample_q=0.5)
    assert torch.equal(a, run(0, resample_q=0.5)) and not torch.equal(a, run(1, resample_q=0.5))
    with pytest.raises(ValueError, match="content_tokens"):
        run(0, filter_ratio=0.5)
    with pytest.raises(ValueError, match="generator or the draws"):
        sample_tokens(model.diffusion, cond)
    with pytest.raises(ValueError, match="draws.start"):
        sample_tokens(model.diffusion, cond, uniform_start=True,
                      draws=OneHotDraws(gumbel=torch.zeros(T_STEPS, B, L, K)))


# -- Diffsound's inference API --------------------------------------------------------

@pytest.mark.parametrize("sample_type", ["top0.85r", "top3p,fast1"])
def test_generate_onehot_matches_jax(sample_type):
    jds, params = _jdiffsound()
    model, _ = _port_slice()
    key = jax.random.PRNGKey(3)
    want_mel, want_tok = jds.generate(params, key, jnp.asarray(_cond_tokens()),
                                      sample_type=sample_type, use_fused=False,
                                      return_tokens=True)
    skip = int(sample_type.split(",fast")[1]) if ",fast" in sample_type else 0
    draws = jax_draws(key, len(_timestep_plan(T_STEPS, T_STEPS, skip)[0]))
    mel, tok = model.generate(None, _t(_cond_tokens()), sample_type=sample_type,
                              use_fused=False, noise=draws, return_tokens=True)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(mel.numpy(), np.asarray(want_mel), atol=ATOL)


def test_reconstruct_matches_jax():
    jds, params = _jdiffsound()
    model, _ = _port_slice()
    mel = np.random.default_rng(7).uniform(-1, 1, (B, 4, 16, 1)).astype(np.float32)
    want = np.asarray(jds.reconstruct(params, jnp.asarray(mel)))
    np.testing.assert_allclose(model.reconstruct(_t(mel)).numpy(), want, atol=ATOL)


def test_sample_grid_matches_jax():
    """The same keys and images; each generation under the JAX grid's key."""
    jds, params = _jdiffsound()
    model, _ = _port_slice()
    mel = np.random.default_rng(8).uniform(-1, 1, (B, 4, 16, 1)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    frs = (0.0, 0.5)
    want = jds.sample_grid(params, key, jnp.asarray(mel), jnp.asarray(_cond_tokens()),
                           filter_ratios=frs)
    noises = []
    for fr in frs:        # the grid splits one key off a generation
        key, k = jax.random.split(key)
        start = int(T_STEPS * fr)
        noises.append(jax_draws(k, start or T_STEPS, "q_sample" if start else "mask"))
    got = model.sample_grid(None, _t(mel), _t(_cond_tokens()), filter_ratios=frs,
                            use_fused=False, noises=noises)
    assert list(got) == list(want) == ["input_image", "reconstruction_image",
                                       "cond1_cont1.0_fr0.0_image", "cond1_cont1.0_fr0.5_image"]
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), atol=ATOL,
                                   err_msg=name)


def test_generate_routes_by_the_jax_rule(monkeypatch):
    """Fused for no truncation and top-r without q, unless use_fused=False;
    one-hot for top-k and any q, whatever use_fused says."""
    from text_to_sound_synthesis_torch.models import diffsound as tds

    model, _ = _port_slice()
    calls = []
    monkeypatch.setattr(tds, "sample_tokens_fused",
                        lambda *a, **kw: calls.append("fused") or torch.zeros(B, L, dtype=torch.int32))
    monkeypatch.setattr(tds, "sample_tokens",
                        lambda *a, **kw: calls.append("onehot") or torch.zeros(B, L, dtype=torch.int32))
    cases = [("top0.85r", None, "fused"), ("", None, "fused"), ("top0.85r,fast2", True, "fused"),
             ("top0.85r", False, "onehot"), ("top5p", None, "onehot"), ("top5p", True, "onehot"),
             ("top0.85r,q0.5", None, "onehot"), ("top0.85r,q0.5", True, "onehot")]
    for sample_type, use_fused, path in cases:
        calls.clear()
        model.generate(torch.Generator().manual_seed(0), _t(_cond_tokens()),
                       sample_type=sample_type, use_fused=use_fused)
        assert calls == [path], (sample_type, use_fused)
