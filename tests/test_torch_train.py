"""The port's Stage-2 training against the JAX package's, on the CPU.

A tiny composite (2 denoiser layers of d64, 2 heads, 16 tokens of 10 codes +
MASK, 4 diffusion steps; the VQGAN of ``tests/test_composite.py``'s
TINY_MODEL_CFG; a 1-layer CLIP over a 64-word vocabulary) made from the JAX
sub-modules (the JAX ``build_model`` needs the CLIP BPE table) and loaded
into the port with ``convert.from_jax.load_diffsound``. BPE ids are drawn
with numpy. The JAX side draws from its keys; the port is handed those very
draws: ``q_sample``'s Gumbel noise, and the timesteps' (the categorical's
Gumbel noise and the uniform draw), replayed from the key schedule of JAX's
train step (``split(key)`` -> t's key, the loss's key; t's key -> the
importance key, the uniform key).

Tolerances (f32 on both sides; the ops run in another order):
- the loss and its parts within rtol 1e-5 (sums over 16 x 11 values);
- each gradient within 1e-4 of its tensor's largest magnitude, or 1e-7 of
  the largest gradient of all, whichever is larger (the attention keys' bias
  has a zero gradient in exact arithmetic: the softmax does not see a shift
  that all keys share; both sides hold only rounding there, ~1e-8);
- after each train step, the parameters and the EMA within 2e-6, except at
  most 1e-3 of each tensor's values, which stay within 2 lr of JAX's. AdamW
  moves a weight by lr (1e-3) g / (|g| + eps) at the first step: a
  gradient's f32 rounding moves that by a relative 1e-4 or less, except
  where |g| is near eps = 1e-8 or below it, where the step is lr g / eps and
  a rounding of 1e-10 in g moves it by 1e-5 (the attention keys' gradients,
  zero in exact arithmetic in part, hold such values). The keys' biases
  have a zero gradient in exact arithmetic: each side steps them by its own
  rounding, scaled up to about lr / 10, so they are held to 2 lr alone. The
  grad norm within rtol 1e-5, the visit counts and the timesteps exactly.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.engine import clip_grad as jclip
from text_to_sound_synthesis_tpu.engine import ema as jema
from text_to_sound_synthesis_tpu.engine import optimizers as jopt
from text_to_sound_synthesis_tpu.engine import schedulers as jsched
from text_to_sound_synthesis_tpu.engine.train_state import (DiffusionTrainState as JState,
                                                            make_train_step as j_make_step)
from text_to_sound_synthesis_tpu.models.clip.text_model import CLIPTextEmbedding as JClip
from text_to_sound_synthesis_tpu.models.diffsound import Diffsound as JDiffsound
from text_to_sound_synthesis_tpu.models.diffusion import process as jproc
from text_to_sound_synthesis_tpu.models.vqgan.model import VQModel as JVQModel
from text_to_sound_synthesis_tpu.ops import diffusion as jdd
from text_to_sound_synthesis_tpu.ops import permuter as jperm
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.engine import clip_grad as tclip
from text_to_sound_synthesis_torch.engine import ema as tema
from text_to_sound_synthesis_torch.engine import optimizers as topt
from text_to_sound_synthesis_torch.engine import schedulers as tsched
from text_to_sound_synthesis_torch.engine.train_state import (DiffusionTrainState, TrainDraws,
                                                              make_train_step)
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.diffusion import process as tproc
from text_to_sound_synthesis_torch.ops import diffusion as tdd

from tests._torch_tiny import (B, CLIP_CFG, CONTENT_EMB_CFG, CTX, K, L, OPT_CFG, T, TRAIN_CFG,
                               TRANSFORMER_CFG, VOCAB, VQ_DD, batch, tbatch)

torch.set_num_threads(1)

LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def jax_model():
    """A JAX Diffsound over the tiny sub-modules, and its parameters (numpy)."""
    jvq = JVQModel(ddconfig=VQ_DD, n_embed=K - 1, embed_dim=16)
    jclip = JClip(**CLIP_CFG)
    jdiff = jproc.DiscreteDiffusion(transformer_config=TRANSFORMER_CFG,
                                    content_emb_config=CONTENT_EMB_CFG, diffusion_step=T,
                                    auxiliary_loss_weight=5e-4)
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    params = _np({
        "codec": jax.jit(jvq.init)(k[0], jnp.zeros((1, 4, 16, 1))),
        "cond": jax.jit(jclip.init)(k[1], jnp.zeros((1, CTX), jnp.int32)),
        "diffusion": jax.jit(jdiff.init)(k[2], jnp.zeros((1, L), jnp.int32),
                                         jnp.zeros((1, CTX, 8)), jnp.zeros((1,), jnp.int32)),
    })
    j = object.__new__(JDiffsound)
    j.codec, j.cond, j.diffusion = jvq, jclip, jdiff
    j.permuter, j.token_hw = jperm.ColumnMajor(2, 8), (2, 8)
    j.content_info, j.condition_info = {"key": "image"}, {"key": "text"}
    return j, params


def port_model():
    """A fresh port model holding the JAX parameters."""
    _, params = jax_model()
    return from_jax.load_diffsound(build_model(TRAIN_CFG, device="cpu"), params)


def step_draws(key) -> TrainDraws:
    """The draws of JAX's train step under ``key``, for the port."""
    k_t, k_loss = jax.random.split(key)
    k_imp, k_unif = jax.random.split(k_t)
    t = lambda a: torch.from_numpy(np.array(a))
    return TrainDraws(
        timesteps=tproc.TimestepDraws(gumbel=t(jax.random.gumbel(k_imp, (B, T))),
                                      uniform=t(jax.random.randint(k_unif, (B,), 0, T))),
        gumbel=t(jax.random.gumbel(k_loss, (B, L, K))))


def grads_by_name(grad_tree) -> dict:
    """A JAX gradient tree of the denoiser, under the port's names and layouts."""
    return {k[len("transformer."):]: v for k, v in from_jax.diffusion_state_dict(grad_tree).items()}


# -- the loss -----------------------------------------------------------------------

T_FIXED = np.array([0, 1, 3, 2], np.int32)
PT_FIXED = np.array([0.3, 0.2, 0.25, 0.4], np.float32)


@pytest.mark.parametrize("is_train", [True, False])
def test_train_loss_matches_jax(is_train):
    jds, params = jax_model()
    b = batch()
    key = jax.random.PRNGKey(3)
    want = jds.loss(params, key, jnp.asarray(b["image"]), jnp.asarray(b["condition_token"]),
                    jnp.asarray(T_FIXED), jnp.asarray(PT_FIXED), is_train=is_train)
    model = port_model()
    tb = tbatch(b)
    got = model.loss(tb["image"], tb["condition_token"], torch.from_numpy(T_FIXED).long(),
                     torch.from_numpy(PT_FIXED), gumbel=torch.from_numpy(
                         np.array(jax.random.gumbel(key, (B, L, K)))), is_train=is_train)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-5)
    np.testing.assert_allclose(got.kl_loss.detach().numpy(), np.asarray(want.kl_loss), rtol=1e-5)
    np.testing.assert_array_equal(got.acc_x0.numpy(), np.asarray(want.acc_x0))
    np.testing.assert_array_equal(got.acc_keep.numpy(), np.asarray(want.acc_keep))
    np.testing.assert_allclose(got.log_model_prob.detach().numpy(),
                               np.asarray(want.log_model_prob), atol=1e-4)
    assert got.t is not None and torch.equal(got.t, torch.from_numpy(T_FIXED).long())


def test_gradients_match_jax_by_name():
    jds, params = jax_model()
    b = batch(1)
    key = jax.random.PRNGKey(4)
    frozen = {"codec": params["codec"], "cond": params["cond"]}

    def loss_fn(dp):
        return jds.loss(dict(frozen, diffusion=dp), key, jnp.asarray(b["image"]),
                        jnp.asarray(b["condition_token"]), jnp.asarray(T_FIXED),
                        jnp.asarray(PT_FIXED)).loss

    want = grads_by_name(_np(jax.grad(loss_fn)(params["diffusion"])))
    model = port_model()
    tb = tbatch(b)
    out = model.loss(tb["image"], tb["condition_token"], torch.from_numpy(T_FIXED).long(),
                     torch.from_numpy(PT_FIXED),
                     gumbel=torch.from_numpy(np.array(jax.random.gumbel(key, (B, L, K)))))
    out.loss.backward()
    got = {n: p.grad.numpy() for n, p in model.diffusion.transformer.named_parameters()}
    assert sorted(got) == sorted(want)
    # the frozen parts took no gradient
    assert all(p.grad is None for p in model.codec.parameters())
    assert all(p.grad is None for p in model.cond.parameters())
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        atol = max(1e-4 * float(np.abs(w).max()), 1e-7 * top)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol, err_msg=name)


# -- three train steps --------------------------------------------------------------

def _rule_history(prev, t, kl):
    """The port's documented rule for a repeated timestep: the last copy in batch order."""
    hist = prev.copy()
    for i in range(len(t)):
        hist[t[i]] = 0.1 * kl[i] ** 2 + 0.9 * prev[t[i]]
    return hist


def _close_weights(got, want, what):
    """Within 2e-6, but for at most 1e-3 of the values, within 2 lr (the
    module docstring)."""
    d = np.abs(got - want)
    assert float(d.max()) <= 2 * LR, (what, float(d.max()))
    if not what.endswith("key.bias"):    # a zero gradient in exact arithmetic
        assert float((d > 2e-6).mean()) <= 1e-3, (what, int((d > 2e-6).sum()), d.size)


def test_three_train_steps_match_jax():
    """EMA interval 2, clipping on (start 0, end 5000, max 0.5): params, EMA,
    Lt_history and Lt_count after each step."""
    jds, params = jax_model()
    b = batch(2)
    tx = jopt.build_optimizer(OPT_CFG, LR)
    jstep = j_make_step(jds, tx, jclip.ClipGradNorm(0, 5000, 0.5), ema_decay=0.9,
                        ema_interval=2, donate=False)
    jstate = JState.create(jax.tree_util.tree_map(jnp.asarray, params["diffusion"]), tx,
                           num_timesteps=T)
    frozen = jax.tree_util.tree_map(jnp.asarray, {"codec": params["codec"],
                                                  "cond": params["cond"]})
    jb = jax.tree_util.tree_map(jnp.asarray, b)

    model = port_model()
    den = model.diffusion.transformer
    state = DiffusionTrainState.create(den, topt.build_optimizer(OPT_CFG, den, LR), T)
    step = make_train_step(model, tclip.ClipGradNorm(0, 5000, 0.5), 0.9, 2)
    tb = tbatch(b)
    ema0 = [e.clone() for e in state.ema_params]

    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        # JAX's kl per sample for this step (same params, draws, t and pt), for
        # the port's rule on a repeated timestep
        k_t, k_loss = jax.random.split(key)
        jt, jpt = jproc.sample_timesteps(k_t, jstate.lt, B, T)
        jkl = np.asarray(jds.loss(dict(frozen, diffusion=jstate.params), k_loss, jb["image"],
                                  jb["condition_token"], jt, jpt).kl_loss)
        prev_hist = state.lt.Lt_history.numpy().copy()

        jstate, jm = jstep(jstate, frozen, jb, key, LR)
        state, m = step(state, tb, LR, draws=step_draws(key))

        np.testing.assert_array_equal(m.t.numpy(), np.asarray(jm.t))
        np.testing.assert_array_equal(m.t.numpy(), np.asarray(jt))
        np.testing.assert_allclose(m.loss.item(), float(jm.loss), rtol=1e-5)
        np.testing.assert_allclose(m.grad_norm.item(), float(jm.grad_norm), rtol=1e-5)
        assert state.step == int(jstate.step) == i + 1
        want_p = grads_by_name(_np(jstate.params))
        for n, p in den.named_parameters():
            _close_weights(p.detach().numpy(), want_p[n], f"step {i + 1} param {n}")
        want_e = grads_by_name(_np(jstate.ema_params))
        for (n, _), e in zip(state.named_params(), state.ema_params):
            _close_weights(e.numpy(), want_e[n], f"step {i + 1} ema {n}")
        np.testing.assert_array_equal(state.lt.Lt_count.numpy(), np.asarray(jstate.lt.Lt_count))
        t_np = m.t.numpy()
        np.testing.assert_allclose(state.lt.Lt_history.numpy(),
                                   _rule_history(prev_hist, t_np, jkl), rtol=1e-5)
        once = [tau for tau in range(T) if (t_np == tau).sum() == 1]
        np.testing.assert_allclose(state.lt.Lt_history.numpy()[once],
                                   np.asarray(jstate.lt.Lt_history)[once], rtol=1e-5)
    # the EMA moved at step 2 only (interval 2): it is no alias of the params
    assert any(not torch.equal(a, b) for a, b in zip(ema0, state.ema_params))
    assert float(state.lt.Lt_count.sum()) == 3 * B


def test_update_timestep_state_keeps_the_last_copy():
    """Repeated timesteps: counts add every copy; the history takes the last
    copy in batch order, from the old history (the port's rule)."""
    rng = np.random.default_rng(5)
    prev = rng.uniform(0, 2, T).astype(np.float32)
    t = np.array([1, 3, 1, 1, 0, 3, 2, 1], np.int64)
    kl = rng.uniform(0, 3, len(t)).astype(np.float32)
    state = tproc.TimestepSamplerState(torch.from_numpy(prev), torch.zeros(T))
    new = tproc.update_timestep_state(state, torch.from_numpy(t), torch.from_numpy(kl))
    np.testing.assert_allclose(new.Lt_history.numpy(), _rule_history(prev, t, kl), rtol=1e-6)
    np.testing.assert_array_equal(new.Lt_count.numpy(), np.bincount(t, minlength=T))
    # without repeats, as JAX's scatter
    t1 = np.array([2, 0, 3], np.int64)
    got = tproc.update_timestep_state(state, torch.from_numpy(t1), torch.from_numpy(kl[:3]))
    want = jproc.update_timestep_state(
        jproc.TimestepSamplerState(jnp.asarray(prev), jnp.zeros(T)), jnp.asarray(t1),
        jnp.asarray(kl[:3]))
    np.testing.assert_allclose(got.Lt_history.numpy(), np.asarray(want.Lt_history), rtol=1e-6)
    np.testing.assert_array_equal(got.Lt_count.numpy(), np.asarray(want.Lt_count))


@pytest.mark.parametrize("regime", ["uniform", "importance"])
def test_sample_timesteps_matches_jax(regime):
    """Under JAX's draws: the same t, and pt within rtol 1e-6. The importance
    regime needs every bucket past 10 visits; 10 visits in one bucket keeps
    the uniform one."""
    rng = np.random.default_rng(6)
    n = 64
    Tn = 8
    hist = rng.uniform(0, 4, Tn).astype(np.float32)
    count = np.full(Tn, 11.0 if regime == "importance" else 40.0, np.float32)
    if regime == "uniform":
        count[3] = 10.0
    jstate = jproc.TimestepSamplerState(jnp.asarray(hist), jnp.asarray(count))
    key = jax.random.PRNGKey(7)
    jt, jpt = jproc.sample_timesteps(key, jstate, n, Tn)
    k_imp, k_unif = jax.random.split(key)
    draws = tproc.TimestepDraws(torch.from_numpy(np.array(jax.random.gumbel(k_imp, (n, Tn)))),
                                torch.from_numpy(np.array(jax.random.randint(k_unif, (n,), 0, Tn))))
    state = tproc.TimestepSamplerState(torch.from_numpy(hist), torch.from_numpy(count))
    t, pt = tproc.sample_timesteps(state, n, draws=draws)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jpt), rtol=1e-6)
    if regime == "uniform":
        assert np.all(pt.numpy() == np.float32(1 / Tn))
    else:
        probs = tproc.timestep_probs(state).numpy()
        assert probs[0] == probs[1]       # the decoder term takes L1's weight
        np.testing.assert_allclose(pt.numpy(), probs[t.numpy()], rtol=0)


def test_sample_timesteps_from_a_generator():
    """The port's own draws: seeded, in range, and importance-weighted."""
    Tn = 8
    hist = torch.tensor([0.0, 0.0, 0.0, 9.0, 0.0, 0.0, 0.0, 0.0])
    state = tproc.TimestepSamplerState(hist, torch.full((Tn,), 20.0))
    t1, pt1 = tproc.sample_timesteps(state, 4000, generator=torch.Generator().manual_seed(0))
    t2, _ = tproc.sample_timesteps(state, 4000, generator=torch.Generator().manual_seed(0))
    assert torch.equal(t1, t2) and int(t1.min()) >= 0 and int(t1.max()) < Tn
    share = float((t1 == 3).float().mean())
    want = float(tproc.timestep_probs(state)[3])
    assert abs(share - want) < 0.03, (share, want)
    with pytest.raises(ValueError, match="generator or the draws"):
        tproc.sample_timesteps(state, 4)


# -- optimizer, schedulers, clipping, EMA ----------------------------------------------

def test_decay_mask_matches_jax():
    """The decay set is the Linear weights: JAX's ``kernel`` leaves, name by name;
    no embedding table (2-D) and no LayerNorm weight is in it."""
    _, params = jax_model()
    jmask = jopt.decay_mask(params["diffusion"])
    want = {n for n, v in grads_by_name(_np(jax.tree_util.tree_map(
        lambda m: np.float32(m), jmask))).items() if float(v) == 1.0}
    den = port_model().diffusion.transformer
    got = {n for n, d in topt.decay_mask(den).items() if d}
    assert got == want
    assert "content_emb.emb.weight" not in got and "blocks.0.ln1.emb.weight" not in got
    assert "to_logits.0.weight" not in got and "to_logits.1.weight" in got
    groups = topt.param_groups(den, 0.045)
    assert [g["weight_decay"] for g in groups] == [0.045, 0.0]
    assert len(groups[0]["params"]) == len(want)
    assert sum(len(g["params"]) for g in groups) == len(list(den.parameters()))


def _metric(i):
    # falls, then sits on a plateau with small noise, then falls again
    return (10.0 - 0.1 * i if i < 20 else 8.0 + 0.01 * (i % 3)) if i < 70 else 7.0 - 0.01 * i


@pytest.mark.parametrize("name", ["plateau", "cosine"])
def test_schedulers_match_jax(name):
    """The lr sequences are equal to JAX's classes' (both pure Python), and a
    state round trip in either direction continues them."""
    if name == "plateau":
        kw = dict(base_lr=3e-6, factor=0.5, patience=5, min_lr=1e-6, threshold=1e-1,
                  threshold_mode="rel", warmup_lr=4.5e-4, warmup=10, cooldown=2)
        make_j, make_t = jsched.ReduceLROnPlateauWithWarmup, tsched.ReduceLROnPlateauWithWarmup
    else:
        kw = dict(base_lr=1e-5, T_max=60, min_lr=1e-6, warmup_lr=1e-3, warmup=10)
        make_j, make_t = jsched.CosineAnnealingLRWithWarmup, tsched.CosineAnnealingLRWithWarmup
    j, t = make_j(**kw), make_t(**kw)
    seq_j = [j.step(_metric(i)) for i in range(100)]
    seq_t = [t.step(_metric(i)) for i in range(100)]
    assert seq_t == seq_j
    assert len(set(seq_t)) > 5
    # round trips: JAX -> port and port -> JAX at step 40, then 30 more steps
    j2, t2 = make_j(**kw), make_t(**kw)
    for i in range(40):
        j2.step(_metric(i))
        t2.step(_metric(i))
    t3, j3 = make_t(**kw), make_j(**kw)
    t3.load_state_dict(j2.state_dict())
    j3.load_state_dict(t2.state_dict())
    assert t2.state_dict() == j2.state_dict()
    for i in range(40, 70):
        want = j2.step(_metric(i))
        assert t3.step(_metric(i)) == want and j3.step(_metric(i)) == want
    assert t3.state_dict() == j2.state_dict()


def test_plateau_scheduler_reads_the_reference_state():
    t = tsched.ReduceLROnPlateauWithWarmup(base_lr=1e-4, patience=3)
    t.load_state_dict({"num_bad_epochs": 2, "last_epoch": 7, "best": 0.5,
                       "cooldown_counter": 0, "factor": 0.1, "min_lrs": [0.0]})
    assert (t.num_bad, t.last_epoch, t.best, t.lr) == (2, 7, 0.5, 1e-4)


@pytest.mark.parametrize("start,end", [(0, 5000), (0, -1), (100, -1), (100, 50), (10, 20)])
def test_clip_grad_norm_window_matches_jax(start, end):
    """The OR-ed start / end conditions, iteration by iteration, and the
    clipped gradients and global norm (within rtol 1e-6)."""
    jc, tc = jclip.ClipGradNorm(start, end, 0.5), tclip.ClipGradNorm(start, end, 0.5)
    rng = np.random.default_rng(8)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for it in (0, 5, 10, 19, 20, 49, 50, 99, 100, 4999, 5000, 10 ** 6):
        jg, jn = jc(gs, jnp.asarray(it))
        tg = [torch.from_numpy(g.copy()) for g in gs]
        tn = tc(tg, it)
        active = bool(it >= start or (end > 0 and it < end))
        assert tc.active(it) == active
        np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        for a, w in zip(tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6)
        scaled = not np.allclose(tg[0].numpy(), gs[0])
        assert scaled == active


def test_ema_update_matches_jax_and_copies():
    rng = np.random.default_rng(9)
    shapes = ((4, 3), (7,))
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    e = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jema.ema_update([jnp.asarray(x) for x in e], [jnp.asarray(x) for x in p], 0.99, True)
    tp = [torch.from_numpy(x.copy()) for x in p]
    shadow = tema.ema_copy(tp)
    assert all(s.data_ptr() != q.data_ptr() for s, q in zip(shadow, tp))
    for s, x in zip(shadow, e):
        s.copy_(torch.from_numpy(x))
    tema.ema_update(shadow, tp, 0.99)
    for s, w in zip(shadow, want):
        np.testing.assert_allclose(s.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tp[0].numpy(), p[0])   # the params are not touched


def test_multinomial_kl_and_log_categorical_match_jax():
    rng = np.random.default_rng(10)
    a = np.log(rng.dirichlet(np.ones(K), (B, L))).astype(np.float32)
    b = np.log(rng.dirichlet(np.ones(K), (B, L))).astype(np.float32)
    np.testing.assert_allclose(tdd.multinomial_kl(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jdd.multinomial_kl(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)
    np.testing.assert_allclose(tdd.log_categorical(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jdd.log_categorical(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5)


def test_clip_gradient_at_the_bounds_is_jax_clip():
    x = np.array([-70.0, -1.0, 0.0, 0.5, -71.0], np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, -70.0, 0.0).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    tdd.clip(xt, -70.0, 0.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)


# -- bf16: dtype is the compute dtype -------------------------------------------------
#
# ``Diffsound(dtype=bfloat16)`` keeps f32 parameters and runs its forward on
# their bf16 copies, as flax's ``dtype`` does. Tolerances, bf16 on both sides:
# the codec's argmin over bf16 distances tips on a near-tie now and then, so
# the tokens agree on most, not all, positions; the loss and its gradients are
# compared on JAX's tokens (the port's ``encode_content`` handed them): the
# loss within rtol 1e-3 and each sample's kl within 5e-3 (bf16 products
# summed in another order), each gradient within 5e-2 of its tensor's largest
# magnitude or 1e-2 of the largest gradient of all (the attention keys'
# biases: zero in exact arithmetic, rounding on both sides). After each of
# three AdamW steps (lr 1e-3) every weight and EMA value lies within 2 lr a
# step of JAX's (and an f32 rounding), and at most 2 values or 2 % of each
# tensor's values, whichever is more, more than lr / 4 off: the first step
# moves a weight by about lr sign(g), so only a gradient whose sign the bf16
# rounding flips moves it by 2 lr; later steps differ by the bf16 noise of the
# moments, about 1e-4. The attention keys' biases (zero gradient in exact
# arithmetic: each side steps them by its own rounding) are held to the 2 lr
# alone, as in the f32 steps.

BF16_CFG = {**TRAIN_CFG, "params": {**TRAIN_CFG["params"], "dtype": "bfloat16"}}


@lru_cache(maxsize=None)
def jax_bf16_model():
    """The JAX Diffsound of ``jax_model`` with bf16 as every module's dtype."""
    _, params = jax_model()
    bf = jnp.bfloat16
    j = object.__new__(JDiffsound)
    j.codec = JVQModel(ddconfig=VQ_DD, n_embed=K - 1, embed_dim=16, dtype=bf)
    j.cond = JClip(**CLIP_CFG, dtype=bf)
    j.diffusion = jproc.DiscreteDiffusion(transformer_config=TRANSFORMER_CFG,
                                          content_emb_config=CONTENT_EMB_CFG, diffusion_step=T,
                                          auxiliary_loss_weight=5e-4, dtype=bf)
    j.permuter, j.token_hw = jperm.ColumnMajor(2, 8), (2, 8)
    j.content_info, j.condition_info = {"key": "image"}, {"key": "text"}
    return j, params


def port_bf16_model(tokens=None):
    """A port bf16 model holding the JAX parameters; ``tokens`` (B, L) replace
    what its codec would give."""
    _, params = jax_model()
    model = from_jax.load_diffsound(build_model(BF16_CFG, device="cpu"), params)
    if tokens is not None:
        model.encode_content = lambda mel: tokens
    return model


def _jax_tokens(b, jit=False):
    """JAX's bf16 codec tokens of ``b``, as its eager ops or as its jitted
    step computes them (XLA fuses bf16 roundings away under ``jit``, which
    tips a near-tie of the argmin now and then)."""
    j, params = jax_bf16_model()
    enc = lambda p, m: j.encode_content(p, m)
    tok = (jax.jit(enc) if jit else enc)(params, jnp.asarray(b["image"]))
    return torch.from_numpy(np.array(tok)).long()


def test_bf16_model_keeps_f32_parameters_moments_and_ema():
    """Parameters, gradients, AdamW's moments and the EMA are f32 after two
    steps; the denoiser's products ran in bf16."""
    model = port_bf16_model()
    assert model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = []
    hook = model.diffusion.transformer.blocks[0].mlp[0].register_forward_hook(
        lambda mod, inp, out: seen.append((inp[0].dtype, mod.weight.dtype, out.dtype)))
    den = model.diffusion.transformer
    state = DiffusionTrainState.create(den, topt.build_optimizer(OPT_CFG, den, LR), T)
    step = make_train_step(model, tclip.ClipGradNorm(0, 5000, 0.5), 0.9, 1)
    for i in range(2):
        state, m = step(state, tbatch(batch(2)), LR, draws=step_draws(jax.random.PRNGKey(20 + i)))
        assert np.isfinite(m.loss.item())
    hook.remove()
    assert seen and all(s == (torch.bfloat16,) * 3 for s in seen)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for _, p in state.named_params())
    moments = [v for s in state.optimizer.state.values() for v in s.values()
               if torch.is_tensor(v) and v.dim() > 0]
    assert len(moments) == 2 * len(state.named_params())
    assert all(v.dtype == torch.float32 for v in moments)
    assert all(e.dtype == torch.float32 for e in state.ema_params)
    assert all(p.dtype == torch.float32 for p in model.parameters())   # restored after each call


def test_bf16_codec_and_text_tower_match_jax():
    """The frozen parts in bf16: CLIP features within 2e-2 of their largest
    magnitude; the codec's tokens equal on at least 90 % of 256 positions
    (bf16 near-ties of the argmin); its decoded mels within 5e-2."""
    j, params = jax_bf16_model()
    model = port_bf16_model()
    rng = np.random.default_rng(12)
    ids = rng.integers(0, VOCAB, (B, CTX)).astype(np.int32)
    want = np.asarray(j.embed_condition(params, jnp.asarray(ids)), np.float32)
    got = model.embed_condition(torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))
    mel = rng.uniform(-1, 1, (16, 4, 16, 1)).astype(np.float32)
    jt = np.asarray(j.encode_content(params, jnp.asarray(mel)))
    tt_ = model.encode_content(torch.from_numpy(mel)).numpy()
    assert (jt == tt_).mean() >= 0.9, (jt == tt_).mean()
    want_mel = np.asarray(j.decode_tokens(params, jnp.asarray(jt)), np.float32)
    got_mel = model.decode_tokens(torch.from_numpy(jt).long()).float().numpy()
    np.testing.assert_allclose(got_mel, want_mel, rtol=0, atol=5e-2 * float(np.abs(want_mel).max()))


def test_bf16_loss_and_gradients_match_jax():
    j, params = jax_bf16_model()
    b = batch(1)
    key = jax.random.PRNGKey(4)
    frozen = {"codec": params["codec"], "cond": params["cond"]}

    def loss_fn(dp):
        return j.loss(dict(frozen, diffusion=dp), key, jnp.asarray(b["image"]),
                      jnp.asarray(b["condition_token"]), jnp.asarray(T_FIXED),
                      jnp.asarray(PT_FIXED))

    want = loss_fn(params["diffusion"])
    want_g = grads_by_name(_np(jax.grad(lambda dp: loss_fn(dp).loss)(params["diffusion"])))
    model = port_bf16_model(_jax_tokens(b))
    tb = tbatch(b)
    out = model.loss(tb["image"], tb["condition_token"], torch.from_numpy(T_FIXED).long(),
                     torch.from_numpy(PT_FIXED),
                     gumbel=torch.from_numpy(np.array(jax.random.gumbel(key, (B, L, K)))))
    np.testing.assert_allclose(out.loss.item(), float(want.loss), rtol=1e-3)
    np.testing.assert_allclose(out.kl_loss.detach().numpy(), np.asarray(want.kl_loss), rtol=5e-3)
    out.loss.backward()
    got = {n: p.grad for n, p in model.diffusion.transformer.named_parameters()}
    assert sorted(got) == sorted(want_g)
    assert all(g.dtype == torch.float32 for g in got.values())
    assert all(p.grad is None for p in model.codec.parameters())
    top = max(float(np.abs(w).max()) for w in want_g.values())
    for name, w in want_g.items():
        atol = max(5e-2 * float(np.abs(w).max()), 1e-2 * top)
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=atol, err_msg=name)


def _close_bf16_weights(got, want, what, steps):
    d = np.abs(got - want)
    assert float(d.max()) <= 2 * LR * steps + 1e-6, (what, float(d.max()))   # + f32 rounding
    if not what.endswith("key.bias"):
        n = int((d > LR / 4).sum())
        assert n <= max(2, 2e-2 * d.size), (what, n, d.size)


def test_bf16_train_steps_match_jax():
    """Three bf16 steps against JAX's jitted bf16 step (clip on, EMA every
    step), on the tokens of JAX's jitted codec: the loss and grad norm within rtol 1e-2, the
    weights and the EMA as the block comment says, all f32 on both sides."""
    j, params = jax_bf16_model()
    b = batch(2)
    tx = jopt.build_optimizer(OPT_CFG, LR)
    jstep = j_make_step(j, tx, jclip.ClipGradNorm(0, 5000, 0.5), ema_decay=0.9,
                        ema_interval=1, donate=False)
    jstate = JState.create(jax.tree_util.tree_map(jnp.asarray, params["diffusion"]), tx,
                           num_timesteps=T)
    frozen = jax.tree_util.tree_map(jnp.asarray, {"codec": params["codec"],
                                                  "cond": params["cond"]})
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    model = port_bf16_model(_jax_tokens(b, jit=True))
    den = model.diffusion.transformer
    state = DiffusionTrainState.create(den, topt.build_optimizer(OPT_CFG, den, LR), T)
    step = make_train_step(model, tclip.ClipGradNorm(0, 5000, 0.5), 0.9, 1)
    for i in range(3):
        key = jax.random.PRNGKey(30 + i)
        jstate, jm = jstep(jstate, frozen, jb, key, LR)
        state, m = step(state, tbatch(b), LR, draws=step_draws(key))
        np.testing.assert_array_equal(m.t.numpy(), np.asarray(jm.t))
        np.testing.assert_allclose(m.loss.item(), float(jm.loss), rtol=1e-2)
        np.testing.assert_allclose(m.grad_norm.item(), float(jm.grad_norm), rtol=1e-2)
        want_p = grads_by_name(_np(jstate.params))
        want_e = grads_by_name(_np(jstate.ema_params))
        assert all(np.asarray(w).dtype == np.float32 for w in want_p.values())
        for (n, p), e in zip(state.named_params(), state.ema_params):
            _close_bf16_weights(p.detach().numpy(), want_p[n], f"step {i + 1} param {n}", i + 1)
            _close_bf16_weights(e.numpy(), want_e[n], f"step {i + 1} ema {n}", i + 1)


def test_bf16_serving_reads_the_rounded_weights_bit_for_bit():
    """A bf16 request computes what a model stored in bf16 computes: the
    fused and one-hot samplers' tokens and mels, ``reconstruct`` and the int8
    engine ``quantize_for_serving`` builds are bit for bit those of the same
    weights held as bf16 parameters (``.to(torch.bfloat16)``), and a seeded
    model's weights are the bf16 draws: the digests below pin those outputs
    on the seeded init's draws (flax's defaults: Linear and Conv weights
    truncated ``lecun_normal``)."""
    import hashlib

    model = build_model(BF16_CFG, device="cpu", seed=3)
    stored = build_model(BF16_CFG, device="cpu", seed=0)
    stored.load_state_dict(model.state_dict())
    stored.to(torch.bfloat16)     # its parameters bf16: compute_weights has nothing to cast
    assert all(torch.equal(p.bfloat16().float(), p) for p in model.parameters())

    def digest(t):
        return hashlib.sha256(t.detach().float().contiguous().numpy().tobytes()).hexdigest()[:16]

    ids = torch.from_numpy(np.random.default_rng(4).integers(0, VOCAB, (3, CTX))).long()
    mel_in = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (3, 4, 16, 1))
                              .astype(np.float32))
    got, ref = {}, {}
    for out, m in ((got, model), (ref, stored)):
        out["fused"] = m.generate(torch.Generator().manual_seed(5), ids, return_tokens=True)
        out["onehot"] = m.generate(torch.Generator().manual_seed(6), ids, sample_type="top3p",
                                   return_tokens=True)
        out["qp"] = torch.cat([t.float().reshape(-1)
                               for t in m.quantize_for_serving().state_dict().values()])
        out["rec"] = m.reconstruct(mel_in)
    for k in ("fused", "onehot"):
        assert torch.equal(got[k][0], ref[k][0]) and torch.equal(got[k][1], ref[k][1]), k
    assert torch.equal(got["qp"], ref["qp"]) and torch.equal(got["rec"], ref["rec"])
    assert {k: [digest(t) for t in (v if isinstance(v, tuple) else (v,))]
            for k, v in got.items()} == {
        "fused": ["7375f32ebb31050d", "4554f5974e65cfea"],
        "onehot": ["78705e6e6f173dc0", "879d5e4ab9deea1c"],
        "qp": ["60394337a45de943"], "rec": ["24a21537c03e902f"]}
    assert all(p.dtype == torch.float32 for p in model.parameters())


def _bf16_pair(seed=3):
    """A bf16 model (f32 weights) and a copy whose weights are stored in bf16."""
    model = build_model(BF16_CFG, device="cpu", seed=seed)
    stored = build_model(BF16_CFG, device="cpu", seed=0)
    stored.load_state_dict(model.state_dict())
    return model, stored.to(torch.bfloat16)


def test_bf16_parts_refuse_their_f32_storage_and_shard_as_stored():
    """A bf16 model's parts called on their own outside ``compute_weights``
    (the sharded sampler on ``model.diffusion``, the codec, the text tower,
    the int8 quantizer) raise rather than compute in f32; inside it, a
    sharded request over two CPU shards is bit for bit the same request on
    the model stored in bf16."""
    from text_to_sound_synthesis_torch.models.diffusion.int8_runtime import quantize_denoiser

    model, stored = _bf16_pair()
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, VOCAB, (4, CTX))).long()
    cond = model.embed_condition(ids)
    grid = torch.zeros((1, 2, 8), dtype=torch.long)
    for call in (lambda: tproc.sample_tokens_fused_sharded(model.diffusion, cond, seed=11,
                                                           devices=["cpu"] * 2),
                 lambda: model.codec.decode_code(grid), lambda: model.cond(ids),
                 lambda: quantize_denoiser(model.diffusion, n_head=2, seq_len=L, num_timesteps=T)):
        with pytest.raises(TypeError, match="compute_weights"):
            call()
    with torch.no_grad(), model.compute_weights(model.diffusion):
        got = tproc.sample_tokens_fused_sharded(model.diffusion, cond, seed=11,
                                                devices=["cpu"] * 2, truncation_r=0.85)
    want = tproc.sample_tokens_fused_sharded(stored.diffusion, stored.embed_condition(ids),
                                             seed=11, devices=["cpu"] * 2, truncation_r=0.85)
    assert torch.equal(got, want)
    assert torch.equal(model.decode_tokens(got), stored.decode_tokens(want))


def test_bf16_compute_copies_are_kept_until_a_weight_changes():
    """A second request casts nothing: every floating tensor's bf16 copy is
    the one the first request made. A train step reads the frozen codec's
    and text tower's kept copies and casts the denoiser afresh; the
    optimizer's writes then make the next request cast the denoiser anew,
    and that request is bit for bit the one of the stepped weights stored
    in bf16."""
    model, _ = _bf16_pair()
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, VOCAB, (3, CTX))).long()

    def request():
        return model.generate(torch.Generator().manual_seed(5), ids, return_tokens=True)

    first = request()
    kept = {k: v[2] for k, v in model._compute_copies.items()}
    floating = {id(t) for m in model.modules() for t in (*m._parameters.values(),
                                                          *m._buffers.values())
                if t is not None and t.is_floating_point()}
    assert set(kept) == floating
    second = request()
    assert all(model._compute_copies[k][2] is v for k, v in kept.items())
    assert torch.equal(first[1], second[1]) and torch.equal(first[0], second[0])

    den = model.diffusion.transformer
    state = DiffusionTrainState.create(den, topt.build_optimizer(OPT_CFG, den, LR), T)
    make_train_step(model)(state, tbatch(batch(2)), LR,
                           draws=step_draws(jax.random.PRNGKey(20)))
    frozen = {id(t) for part in (model.codec, model.cond) for t in part.parameters()}
    assert all(model._compute_copies[k][2] is kept[k] for k in frozen)
    after = request()
    moved = {id(p) for p in den.parameters()}
    assert all(model._compute_copies[k][2] is not kept[k] for k in moved)
    stored = build_model(BF16_CFG, device="cpu", seed=0)
    stored.load_state_dict(model.state_dict())
    stored.to(torch.bfloat16)
    want = stored.generate(torch.Generator().manual_seed(5), ids, return_tokens=True)
    assert torch.equal(after[1], want[1]) and torch.equal(after[0], want[0])


def test_bf16_model_set_to_f32_computes_in_f32():
    """Setting a bf16 model's ``dtype`` to f32 (an f32 reference copy of it)
    unmarks its parts and drops its kept copies: the copy runs on its f32
    weights, bit for bit a model built in f32 with the same weights."""
    import copy

    model, _ = _bf16_pair()
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, VOCAB, (3, CTX))).long()
    model.embed_condition(ids)
    assert model._compute_copies
    ref = copy.deepcopy(model)
    ref.dtype = torch.float32
    assert not ref._compute_copies
    f32_cfg = {**BF16_CFG, "params": {**BF16_CFG["params"], "dtype": "float32"}}
    want = build_model(f32_cfg, device="cpu", seed=0)
    want.load_state_dict(model.state_dict())
    with torch.no_grad():
        got_emb, want_emb = ref.embed_condition(ids), want.embed_condition(ids)
        assert got_emb.dtype == torch.float32 and torch.equal(got_emb, want_emb)
        assert torch.equal(ref.codec.decode_code(torch.zeros((1, 2, 8), dtype=torch.long)),
                           want.codec.decode_code(torch.zeros((1, 2, 8), dtype=torch.long)))
