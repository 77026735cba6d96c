"""The port's MelGAN vocoder training against the JAX package's, on the CPU.

Tiny geometry (a generator of ngf 4 and one residual layer, three
discriminator scales of ndf 4 and two layers, 4096-sample wavs), weights made
by the JAX modules' init and crossed with ``convert/from_jax.py``, inputs
from a numpy seed.

Tolerances (f32 on both sides, the ops in another order):
- ``mel_for_vocoder`` within 2e-5 (``tests/test_torch_loaders.py``'s mel
  chain: values in [0, 1], the FFTs and the filterbank product summed in
  another order); the discriminator's feature maps within 1e-4 of each
  map's largest magnitude;
- the three steps (Adam at the reference's lr 1e-4): the metrics within
  rtol 2e-3 or atol 2e-4 (``tests/test_gan_step_parity.py``'s); after each
  step every weight of G and D within 2 lr a step of JAX's, and within 5e-4
  but for at most 2 values or 1e-3 of a tensor's (Adam's first steps move a
  weight by about lr sign(g) whatever g's size, so a gradient crossing zero
  between the sides' roundings moves it 2 lr apart) and for the values whose
  gradient in the port's step lies below 1e-6 of its network's largest (zero
  in exact arithmetic: each side steps its own rounding there).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.engine import vocoder_solver as jvoc
from text_to_sound_synthesis_tpu.models.melgan import MelGANDiscriminator as JDisc
from text_to_sound_synthesis_tpu.models.melgan import MelGANGenerator as JGen
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.engine import vocoder_solver as tvoc
from text_to_sound_synthesis_torch.models.melgan import MelGANDiscriminator, MelGANGenerator
from text_to_sound_synthesis_torch.ops.gan import feature_matching_l1

from tests._torch_tiny import adam_grads, assert_grads_close, mark_zero_grads, set_adam_state

torch.set_num_threads(1)

B, T = 2, 4096
GEN_KW = dict(input_size=80, ngf=4, n_residual_layers=1)
DISC_KW = dict(num_D=3, ndf=4, n_layers=2)
LR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _wav(seed, n=B):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 22050.0
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 4000, (n, 1)) * t)
    return (tone + 0.05 * rng.standard_normal((n, T))).astype(np.float32)


@lru_cache(maxsize=None)
def jax_models():
    gen, disc = JGen(**GEN_KW), JDisc(**DISC_KW)
    wav = jnp.asarray(_wav(0))
    g = _np(jax.jit(gen.init)(jax.random.PRNGKey(0), jvoc.mel_for_vocoder(wav)))
    d = _np(jax.jit(disc.init)(jax.random.PRNGKey(1), wav[..., None]))
    return gen, disc, g, d


def port_models():
    _, _, g, d = jax_models()
    return (from_jax.load_melgan_generator(MelGANGenerator(**GEN_KW), g),
            from_jax.load_melgan_discriminator(MelGANDiscriminator(**DISC_KW), d))


def test_mel_for_vocoder_matches_jax():
    wav = _wav(1)
    want = np.asarray(jvoc.mel_for_vocoder(jnp.asarray(wav)))          # (B, frames, 80)
    got = tvoc.mel_for_vocoder(torch.from_numpy(wav))                   # (B, 80, frames)
    assert got.shape == (B, 80, T // 256)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=0, atol=2e-5)


def test_melgan_discriminator_matches_jax():
    """Every feature map of every scale; the reference's names."""
    _, disc, _, d = jax_models()
    wav = _wav(2)
    want = disc.apply(d, jnp.asarray(wav)[..., None])
    _, net = port_models()
    assert "model.disc_0.model.layer_0.1.weight" in net.state_dict()
    assert "model.disc_2.model.layer_4.weight" in net.state_dict()
    got = net(torch.from_numpy(wav)[:, None])
    assert len(got) == 3 and [len(s) for s in got] == [5, 5, 5]
    for i, (gs, ws) in enumerate(zip(got, want)):
        for j, (g, w) in enumerate(zip(gs, ws)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.detach().transpose(1, 2).numpy(), w, rtol=0,
                                       atol=1e-4 * float(np.abs(w).max()), err_msg=f"{i}/{j}")


def test_vocoder_train_step_matches_jax():
    """Three steps (D on G's output, G against the updated D, the FM targets
    from D before its update): the metrics, then G's and D's weights."""
    gen, disc, g, d = jax_models()
    tx = jvoc.optax.adam(LR, b1=0.5, b2=0.9)
    jstep = jvoc.make_vocoder_train_step(gen, disc, tx, tx, n_layers_D=DISC_KW["n_layers"],
                                         num_D=DISC_KW["num_D"], donate=False)
    jstate = jvoc.VocoderTrainState.create(g, d, tx, tx)
    tg, td = port_models()
    state = tvoc.VocoderTrainState.create(tg, td)
    step = tvoc.make_vocoder_train_step()
    noisy = {}
    for i in range(3):
        wav = _wav(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(wav))
        state, m = step(state, torch.from_numpy(wav))
        assert state.step == int(jstate.step) == i + 1
        for k in ("loss_D", "loss_G", "loss_feat", "mel_reconstruction"):
            got, want = float(m[k]), float(jm[k])
            assert abs(got - want) <= max(2e-3 * abs(want), 2e-4), (i, k, got, want)
        want_w = {**{f"gen.{k}": v for k, v in
                     from_jax.melgan_generator_state_dict(_np(jstate.g_params)).items()},
                  **{f"disc.{k}": v for k, v in
                     from_jax.melgan_discriminator_state_dict(_np(jstate.d_params)).items()}}
        got_w = {**{f"gen.{k}": v for k, v in state.gen.state_dict().items()},
                 **{f"disc.{k}": v for k, v in state.disc.state_dict().items()}}
        assert sorted(got_w) == sorted(want_w)
        mark_zero_grads({"gen": state.gen, "disc": state.disc}, noisy)
        for k, w in want_w.items():
            dlt = np.abs(got_w[k].numpy() - w)
            assert float(dlt.max()) <= 2 * LR * (i + 1) + 1e-6, (i, k, float(dlt.max()))
            beyond = int((dlt[~noisy[k].numpy()] > 5e-4).sum())
            assert beyond <= max(2, 1e-3 * dlt.size), (i, k, beyond, dlt.size)


def test_vocoder_step_gradients_match_jax():
    """Three steps, each taken from the JAX step's state (G's and D's
    weights and both Adams' moments and step counts loaded into the port's
    before it, so the sides start each step equal): the gradients the port's
    Adams took (``.grad``) against the ones JAX's took, read off optax's
    first moment. D's come from its hinge loss on the current G's output, G's
    from the adversarial term through the updated D and the feature matching
    against D's real maps before its update. Tolerance:
    ``assert_grads_close``.

    Both Adams take eps 1e-4 here (1e-8 in training). At eps 1e-8 Adam's
    first update is lr sign(g) however small g is, so D's weights whose
    gradient is zero in exact arithmetic step 2 lr apart on the two sides'
    roundings, and G's gradient through the updated D moves by up to 2.5e-3
    of its tensor's largest; at 1e-4 such an update is lr g / 1e-4, which
    rounding moves by nothing."""
    gen, disc, g, d = jax_models()
    tx = jvoc.optax.adam(LR, b1=0.5, b2=0.9, eps=1e-4)
    jstep = jvoc.make_vocoder_train_step(gen, disc, tx, tx, n_layers_D=DISC_KW["n_layers"],
                                         num_D=DISC_KW["num_D"], donate=False)
    jstate = jvoc.VocoderTrainState.create(g, d, tx, tx)
    state = tvoc.VocoderTrainState.create(*port_models())
    for group in state.g_opt.param_groups + state.d_opt.param_groups:
        group["eps"] = 1e-4
    step = tvoc.make_vocoder_train_step()

    def adam_by_name(js):
        """(count, mu, nu) of G's and D's optax Adams, under the port's names."""
        return [(int(o[0].count), conv({"params": _np(o[0].mu)}), conv({"params": _np(o[0].nu)}))
                for o, conv in ((js.g_opt, from_jax.melgan_generator_state_dict),
                                (js.d_opt, from_jax.melgan_discriminator_state_dict))]

    for i in range(3):
        from_jax.load_melgan_generator(state.gen, _np(jstate.g_params))
        from_jax.load_melgan_discriminator(state.disc, _np(jstate.d_params))
        before = adam_by_name(jstate)
        for (count, mu, nu), module, opt in zip(before, (state.gen, state.disc),
                                                (state.g_opt, state.d_opt)):
            set_adam_state(opt, dict(module.named_parameters()), mu, nu, count)
        state.step = int(jstate.step)
        wav = _wav(30 + i)
        jstate, _ = jstep(jstate, jnp.asarray(wav))
        state, _ = step(state, torch.from_numpy(wav))
        for (_, mu0, _), (_, mu, _), module, what in zip(before, adam_by_name(jstate),
                                                         (state.gen, state.disc), ("G", "D")):
            assert_grads_close(module, adam_grads(mu, mu0, 0.5), f"step {i + 1} {what}")


def test_vocoder_step_order():
    """D's loss is taken on G's output before G's update, G's adversarial term
    through the updated D, and the FM targets are D's real maps before its
    update: checked by recomputing each on a copy of the state."""
    import copy

    tg, td = port_models()
    state = tvoc.VocoderTrainState.create(tg, td)
    g0, d0 = copy.deepcopy(tg), copy.deepcopy(td)
    wav = torch.from_numpy(_wav(20))
    _, m = tvoc.make_vocoder_train_step()(state, wav)
    mel = tvoc.mel_for_vocoder(wav)
    with torch.no_grad():
        fake0 = g0(mel)
        loss_d = sum(torch.relu(1 + s[-1]).mean() for s in d0(fake0))
        loss_d = loss_d + sum(torch.relu(1 - s[-1]).mean() for s in d0(wav[:, None]))
        adv = -sum(s[-1].mean() for s in td(fake0))             # td: updated in place
        fm = feature_matching_l1(d0(wav[:, None]), td(fake0))
        s_err = (mel - tvoc.mel_for_vocoder(fake0[:, 0])).abs().mean()
    for k, want in (("loss_D", loss_d), ("loss_G", adv), ("loss_feat", fm),
                    ("mel_reconstruction", s_err)):
        assert float(m[k]) == pytest.approx(float(want), rel=1e-5, abs=1e-7), k
