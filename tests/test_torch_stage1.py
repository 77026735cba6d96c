"""The port's Stage-1 (SpecVQGAN) training against the JAX package's, on the CPU.

Tiny geometry (the JAX Stage-1 tests' SMALL_DD: ch 16, ch_mult [1, 2], one
res block, attention at 16; mels of 16 bins x 32 frames, the least height
VGG16's four max-pools leave whole), weights made by the JAX modules' init and
crossed with ``convert/from_jax.py``, inputs from a numpy seed.

Tolerances (f32 on both sides, the ops in another order):
- each module's outputs within 1e-4 of their largest magnitude (the GAN
  losses and LPAPS within rtol 1e-5); the quantizer's indices equal; the
  BatchNorm running statistics within 1e-6 (sums of 2 x 8 x 16 values).
- The steps run the codec at ch 64 (two and four channels a GroupNorm
  group) and lr 1e-4 (the flagship trains at 8 x 1e-6). Adam's first steps
  move a weight by about lr sign(g) whatever g's size, so a value whose
  gradient's sign the two sides' roundings set apart moves 2 lr apart, and
  the next forward carries that on; at ch 16 each GroupNorm group is one
  channel and takes away any per-channel constant, so every bias in front of
  one has a zero gradient but at the padded convs' borders, which carry the
  rounding steps into the reconstruction the discriminator sees next.
- The metrics within rtol 2e-3 or atol 2e-4 (``tests/test_gan_step_parity.py``'s).
- After each step every weight within 2 lr a step of JAX's, and within 5e-4
  but for at most 2 values or 1e-3 of a tensor's (a gradient crossing zero
  between the sides' roundings) and for the values whose gradient is zero in
  exact arithmetic: those whose gradient in the port's step lies below 1e-6
  of its network's largest, at this or an earlier step (the attention keys'
  biases, as the softmax does not see a shift all keys share; the codebook
  rows no code picked).
- The running statistics within 1e-4 after each step (means of 0.01-0.15,
  variances near 1; the D phase's reconstruction comes from the updated
  codec, whose weights differ as above).
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.engine import vqgan_solver as jvs
from text_to_sound_synthesis_tpu.models import discriminator as jdisc
from text_to_sound_synthesis_tpu.models.lpaps import LPAPS as JLPAPS
from text_to_sound_synthesis_tpu.models.lpaps import VGGishish as JVGG
from text_to_sound_synthesis_tpu.models.vqgan import model as jmodel
from text_to_sound_synthesis_tpu.models.vqgan.modules1d import VQModel1d as JVQModel1d
from text_to_sound_synthesis_tpu.models.vqgan.quantize import VectorQuantizer as JVQ
from text_to_sound_synthesis_tpu.ops import gan as jgan
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.engine import vqgan_solver as tvs
from text_to_sound_synthesis_torch.models import discriminator as tdisc
from text_to_sound_synthesis_torch.models.lpaps import LPAPS, VGGishish
from text_to_sound_synthesis_torch.models.vqgan import model as tmodel
from text_to_sound_synthesis_torch.models.vqgan.modules1d import VQModel1d
from text_to_sound_synthesis_torch.models.vqgan.quantize import VectorQuantizer
from text_to_sound_synthesis_torch.ops import gan as tgan

from tests._torch_tiny import adam_grads, assert_grads_close, mark_zero_grads, set_adam_state

torch.set_num_threads(1)

SMALL_DD = dict(double_z=False, z_channels=16, resolution=32, in_channels=1, out_ch=1, ch=16,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
B, H, W = 2, 16, 32
N_EMBED, EMBED_DIM = 8, 16
LR = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _mel(seed, n=B, c=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, H, W, c)).astype(np.float32)


def _close(got, want, rel=1e-4, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30),
                               err_msg=what)


# -- the GAN losses --------------------------------------------------------------------

def test_gan_losses_match_jax():
    rng = np.random.default_rng(0)
    real, fake = rng.standard_normal((2, 3, 5, 1)), rng.standard_normal((2, 3, 5, 1)) * 2
    real, fake = real.astype(np.float32), fake.astype(np.float32)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        want = float(getattr(jgan, name)(jnp.asarray(real), jnp.asarray(fake)))
        np.testing.assert_allclose(getattr(tgan, name)(_t(real), _t(fake)).item(), want, rtol=1e-6)
    np.testing.assert_allclose(tgan.hinge_g_loss(_t(fake)).item(),
                               float(jgan.hinge_g_loss(jnp.asarray(fake))), rtol=1e-6)
    for step in (0, 9, 10, 11):
        want = jgan.adopt_weight(0.7, jnp.asarray(step), 10)
        assert np.float32(tgan.adopt_weight(0.7, step, 10)) == want
    # MelGAN's feature structure: 2 scales of n_layers + 3 = 5 maps, the last the logits
    shapes = [(2, 4, 30), (2, 16, 8), (2, 64, 2), (2, 128, 2), (2, 1, 2)]
    fr = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2)]
    ff = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(2)]
    want = float(jgan.feature_matching_l1(fr, ff))
    got = tgan.feature_matching_l1([[_t(a) for a in s] for s in fr],
                                   [[_t(a) for a in s] for s in ff])
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


# -- the quantizer -----------------------------------------------------------------------

def test_vector_quantizer_result_and_gradients_match_jax():
    """VQResult (z_q, loss, int32 indices, perplexity) and the gradients of
    sum(z_q * c) + loss to z (straight through) and to the codebook."""
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 4, 8, EMBED_DIM)).astype(np.float32) * 0.1
    c = rng.standard_normal(z.shape).astype(np.float32)
    jq = JVQ(N_EMBED, EMBED_DIM)
    params = _np(jq.init(jax.random.PRNGKey(0), jnp.asarray(z)))
    cb = params["params"]["codebook"]
    assert np.abs(cb).max() <= 1.0 / N_EMBED            # U(-1/n_e, 1/n_e)

    def f(p, zz):
        r = jq.apply(p, zz)
        return jnp.sum(r.z_q * c) + r.loss, r

    (_, want), (gp, gz) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params,
                                                                           jnp.asarray(z))
    q = VectorQuantizer(N_EMBED, EMBED_DIM)
    q.embedding.weight.data.copy_(_t(cb))
    zt = _t(z).requires_grad_()
    got = q(zt)
    assert got.indices.dtype == torch.int32 and got.indices.shape == (2, 4, 8)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    _close(got.z_q, want.z_q)
    np.testing.assert_allclose(got.loss.item(), float(want.loss), rtol=1e-5)
    np.testing.assert_allclose(got.perplexity.item(), float(want.perplexity), rtol=1e-5)
    ((got.z_q * _t(c)).sum() + got.loss).backward()
    _close(zt.grad, gz, what="dz")
    _close(q.embedding.weight.grad, gp["params"]["codebook"], what="dcodebook")
    # the training init of a codebook, as JAX's and the reference's
    q.reset_parameters_(torch.Generator().manual_seed(0))
    assert float(q.embedding.weight.abs().max()) <= 1.0 / N_EMBED


# -- the codecs ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def jax_codec(kind="VQModel", n_labels=None, ch=16):
    labels = {"in_channels": n_labels, "out_ch": n_labels} if n_labels else {}
    dd = dict(SMALL_DD, ch=ch, **labels)
    kw = {"n_labels": n_labels} if kind == "VQSegmentationModel" else {}
    codec = getattr(jmodel, kind)(ddconfig=dd, n_embed=N_EMBED, embed_dim=EMBED_DIM, **kw)
    params = _np(jax.jit(codec.init)(jax.random.PRNGKey(1), jnp.zeros((1, H, W, n_labels or 1))))
    return codec, params, dd, kw


def port_codec(kind="VQModel", n_labels=None, ch=16):
    _, params, dd, kw = jax_codec(kind, n_labels, ch)
    return from_jax.load_vqgan(getattr(tmodel, kind)(dd, n_embed=N_EMBED, embed_dim=EMBED_DIM,
                                                     **kw), params)


@pytest.mark.parametrize("kind,n_labels", [("VQModel", None), ("VQNoDiscModel", None),
                                           ("VQSegmentationModel", 3)])
def test_codec_forward_encode_decode_match_jax(kind, n_labels):
    codec, params, _, _ = jax_codec(kind, n_labels)
    x = _mel(2, c=n_labels or 1)
    if n_labels:                       # a one-hot label map
        x = np.eye(n_labels, dtype=np.float32)[np.argmax(x, axis=-1)]
    want_rec, want_vq = codec.apply(params, jnp.asarray(x))
    model = port_codec(kind, n_labels)
    rec, vq = model(_t(x))
    assert rec.shape == (B, H, W, n_labels or 1)
    np.testing.assert_array_equal(vq.indices.numpy(), np.asarray(want_vq.indices))
    _close(rec, want_rec, what="xrec")
    _close(vq.z_q, want_vq.z_q, what="z_q")
    np.testing.assert_allclose(vq.loss.item(), float(want_vq.loss), rtol=1e-4)
    np.testing.assert_allclose(vq.perplexity.item(), float(want_vq.perplexity), rtol=1e-5)
    z_q, vq2 = model.encode(_t(x))
    assert torch.equal(vq2.indices, vq.indices) and torch.equal(z_q, vq.z_q)
    want_dec = codec.apply(params, jnp.asarray(np.asarray(want_vq.indices)),
                           method=codec.decode_code)
    _close(model.decode_code(vq.indices.long()), want_dec, what="decode_code")


def test_segmentation_model_refuses_a_label_count_the_decoder_does_not_emit():
    with pytest.raises(ValueError, match="n_labels=3 but ddconfig.out_ch=1"):
        tmodel.VQSegmentationModel(dict(SMALL_DD), n_embed=N_EMBED, embed_dim=EMBED_DIM,
                                   n_labels=3)
    with pytest.raises(ValueError, match="n_labels=3 but ddconfig.out_ch=1"):
        jmodel.VQSegmentationModel(ddconfig=dict(SMALL_DD), n_embed=N_EMBED, embed_dim=EMBED_DIM,
                                   n_labels=3).init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 1)))


def test_codec_dropout_acts_in_training_mode_only():
    """The ResnetBlocks' dropout (before conv2, as JAX's) acts in train mode;
    at 0 (every config) train and eval are the same function."""
    x = _t(_mel(3))
    m = tmodel.VQModel(dict(SMALL_DD, dropout=0.5), n_embed=N_EMBED, embed_dim=EMBED_DIM)
    m.eval()
    a, b = m(x)[0], m(x)[0]
    assert torch.equal(a, b)
    m.train()
    assert not torch.equal(m(x)[0], a)
    z = port_codec()
    assert torch.equal(z.train()(x)[0], z.eval()(x)[0])


def test_vqmodel1d_matches_jax():
    dd = dict(double_z=False, z_channels=16, resolution=32, in_channels=24, out_ch=24, ch=16,
              ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
    jm = JVQModel1d(ddconfig=dd, n_embed=N_EMBED, embed_dim=EMBED_DIM)
    x = np.random.default_rng(4).standard_normal((B, 32, 24)).astype(np.float32)
    params = _np(jm.init(jax.random.PRNGKey(2), jnp.asarray(x)))
    want_rec, want_vq = jm.apply(params, jnp.asarray(x))
    model = from_jax.load_vqgan1d(VQModel1d(dd, n_embed=N_EMBED, embed_dim=EMBED_DIM), params)
    rec, vq = model(_t(x))
    assert rec.shape == (B, 32, 24) and vq.indices.shape == (B, 16)
    np.testing.assert_array_equal(vq.indices.numpy(), np.asarray(want_vq.indices))
    _close(rec, want_rec, what="xrec")
    np.testing.assert_allclose(vq.loss.item(), float(want_vq.loss), rtol=1e-4)
    want_dec = jm.apply(params, jnp.asarray(np.asarray(want_vq.indices)), method=jm.decode_code)
    _close(model.decode_code(vq.indices.long()), want_dec, what="decode_code")


# -- the discriminators ---------------------------------------------------------------------

DISCS = {
    "2d batchnorm": (jdisc.NLayerDiscriminator, tdisc.NLayerDiscriminator,
                     dict(input_nc=1, ndf=8, n_layers=2), (B, H, W, 1)),
    "2d actnorm": (jdisc.NLayerDiscriminator, tdisc.NLayerDiscriminator,
                   dict(input_nc=1, ndf=8, n_layers=2, use_actnorm=True), (B, H, W, 1)),
    "1d feats": (jdisc.NLayerDiscriminator1dFeats, tdisc.NLayerDiscriminator1dFeats,
                 dict(input_nc=64, n_layers=3), (B, 64, 64)),
    "1d specs": (jdisc.NLayerDiscriminator1dSpecs, tdisc.NLayerDiscriminator1dSpecs,
                 dict(input_nc=H, ndf=8, n_layers=2), (B, 64, H)),
    "1d specs, codec layout": (jdisc.NLayerDiscriminator1dSpecs, tdisc.NLayerDiscriminator1dSpecs,
                               dict(input_nc=H, ndf=8, n_layers=2), (B, H, 64, 1)),
}


@pytest.mark.parametrize("name", list(DISCS))
def test_discriminator_matches_jax(name):
    """Train-mode logits and running statistics after two forwards, then the
    eval-mode logits; the port's names are the reference's ``main.N``."""
    jcls, tcls, kw, shape = DISCS[name]
    rng = np.random.default_rng(5)
    x1, x2 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jd = jcls(**kw)
    variables = _np(jd.init(jax.random.PRNGKey(3), jnp.asarray(x1)))
    if "batch_stats" in variables:     # stats off their init, so the eval path reads them
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32),
            variables["batch_stats"])
    if "actnorm" in name:              # loc / scale off their init
        variables["params"] = {k: ({kk: vv + rng.uniform(0.1, 0.5, vv.shape).astype(np.float32)
                                    for kk, vv in v.items()} if k.startswith("norm") else v)
                               for k, v in variables["params"].items()}
    disc = from_jax.load_discriminator(tcls(**kw), variables)
    assert all(k.startswith("main.") for k in disc.state_dict())
    v = variables
    for x in (x1, x2):
        want, mut = jd.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        v = {**v, **_np(mut)}
        got = disc.train()(_t(x))
        _close(got, want, what=f"{name} train")
    sd = disc.state_dict()
    for k, w in from_jax.discriminator_state_dict(v).items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), w, rtol=0, atol=1e-6, err_msg=k)
    want = jd.apply(v, jnp.asarray(x1), train=False)
    _close(disc.eval()(_t(x1)), want, what=f"{name} eval")
    if "batch" in name:
        assert int(sd["main.3.num_batches_tracked"]) == 2
        # inside frozen_batch_stats a forward uses the batch's statistics and keeps the running ones
        before = {k: t.clone() for k, t in disc.state_dict().items()}
        with tdisc.frozen_batch_stats(disc):
            _close(disc.train()(_t(x1)), jd.apply(v, jnp.asarray(x1), train=True,
                                                   mutable=["batch_stats"])[0])
        assert all(torch.equal(before[k], t) for k, t in disc.state_dict().items())


def test_discriminator_init_from_scratch():
    d = tdisc.init_discriminator_(tdisc.NLayerDiscriminator(1, 8, 2, use_actnorm=True),
                                  torch.Generator().manual_seed(0))
    sd = d.state_dict()
    assert float(sd["main.3.loc"].abs().max()) == 0 and bool((sd["main.3.scale"] == 1).all())
    d = tdisc.init_discriminator_(tdisc.NLayerDiscriminator(1, 8, 2),
                                  torch.Generator().manual_seed(0))
    sd = d.state_dict()
    assert bool((sd["main.3.running_var"] == 1).all()) and "main.2.bias" not in sd
    assert "main.0.bias" in sd and "main.8.bias" in sd     # the first and last convs keep theirs


# -- VGGishish and LPAPS ----------------------------------------------------------------------

def test_vggishish_features_and_logits_match_jax():
    """The five taps of the VGG16 stack on a 16 x 32 mel, and the classifier
    head's logits on a narrower stack (the head's fc1 is 4096 x width x 50)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, H, W)).astype(np.float32)
    jv = JVGG()
    params = _np(jv.init(jax.random.PRNGKey(4), jnp.asarray(x), return_features=True))
    want = jv.apply(params, jnp.asarray(x), return_features=True)
    net = from_jax.load_vggishish(VGGishish(num_classes=309), dict(
        params["params"], **{k: {"kernel": np.zeros((w, 4096) if k == "fc1" else (4096, c)),
                                 "bias": np.zeros(c)}
                             for k, w, c in (("fc1", 512 * 50, 4096), ("fc2", 4096, 4096),
                                             ("fc3", 4096, 309))}))
    got = net(_t(x), return_features=True)
    assert len(got) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g.permute(0, 2, 3, 1), w, what=f"tap {i}")
    layers = (8, "MP", 16, "MP", 16)
    jv = JVGG(conv_layers=layers, num_classes=7)
    params = _np(jv.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    net = from_jax.load_vggishish(VGGishish(layers, num_classes=7), params, layers)
    _close(net(_t(x)), jv.apply(params, jnp.asarray(x)), what="logits")


@lru_cache(maxsize=None)
def jax_lpaps():
    """LPAPS over 16 bins with its shift, scale and heads off their init."""
    lp = JLPAPS(n_mels=H)
    params = _np(lp.init(jax.random.PRNGKey(6), jnp.zeros((1, H, W, 1)), jnp.zeros((1, H, W, 1))))
    rng = np.random.default_rng(7)
    p = dict(params["params"])
    p["shift"] = rng.uniform(-0.2, 0.2, H).astype(np.float32)
    p["scale"] = rng.uniform(0.5, 1.5, H).astype(np.float32)
    for i in range(5):
        p[f"lin{i}"] = rng.uniform(0, 1, p[f"lin{i}"].shape).astype(np.float32)
    return lp, {"params": p}


def port_lpaps():
    return from_jax.load_lpaps(LPAPS(n_mels=H), jax_lpaps()[1])


def test_lpaps_matches_jax_and_is_frozen():
    """Distances and their gradient to the reconstruction; no parameter
    takes a gradient; identical inputs are 0 apart."""
    lp, params = jax_lpaps()
    a, b = _mel(8), _mel(9)
    want, vjp = jax.vjp(lambda r: lp.apply(params, jnp.asarray(a), r), jnp.asarray(b))
    (want_g,) = vjp(jnp.ones_like(want))
    net = port_lpaps()
    bt = _t(b).requires_grad_()
    got = net(_t(a), bt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    got.sum().backward()
    _close(bt.grad, want_g, what="d recon")
    assert all(not p.requires_grad and p.grad is None for p in net.parameters())
    assert float(net(_t(a), _t(a)).abs().max()) == 0.0
    fresh = LPAPS(n_mels=H).init_heads_()
    assert bool((fresh.scaling_layer.scale == 1).all())
    assert bool((fresh.lin4.model[1].weight == 1).all())


# -- the steps ---------------------------------------------------------------------------------

DISC_KW = dict(input_nc=1, ndf=8, n_layers=2)
STEP_CH = 64     # two and four channels a GroupNorm group (module docstring)


def _state_dicts(state):
    """The port's codec and discriminator weights and statistics, by name."""
    out = {f"codec.{k}": v for k, v in state.codec.state_dict().items()}
    if state.disc is not None:
        out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
    return out


def _jax_state_dicts(jstate):
    out = {f"codec.{k}": v for k, v in from_jax.vqgan_state_dict(_np(jstate.ae_params)).items()}
    if jstate.disc_vars:
        out.update({f"disc.{k}": v
                    for k, v in from_jax.discriminator_state_dict(_np(jstate.disc_vars)).items()})
    return out


def _close_weights(got, want, step, noisy):
    for k, w in want.items():
        d = np.abs(got[k].numpy().astype(np.float32) - w)
        if "num_batches_tracked" in k:
            continue
        if "running" in k:
            assert float(d.max()) <= 1e-4, (step, k, float(d.max()))
            continue
        assert float(d.max()) <= 2 * LR * step + 1e-6, (step, k, float(d.max()))
        beyond = int((d[~noisy[k].numpy()] > 5e-4).sum())
        assert beyond <= max(2, 1e-3 * d.size), (step, k, beyond, d.size)


def _close_metrics(got, want, names, step):
    for k in names:
        g, w = float(got[k]), float(want[k])
        assert abs(g - w) <= max(2e-3 * abs(w), 2e-4), (step, k, g, w)


METRICS = ("total_loss", "nll_loss", "p_loss", "g_loss", "quant_loss", "perplexity", "d_weight",
           "disc_factor", "disc_loss", "logits_real", "logits_fake")


def _step_pair(kind):
    """(JAX step, its state, the port's state, the port's step, the step's
    input at a seed) for ``kind``: the adversarial step with a constant or an
    adaptive weight and disc_start 1 (the discriminator off at the first
    step, on at the next two), the no-disc step, the segmentation step."""
    if kind in ("constant", "adaptive"):
        codec, cparams, _, _ = jax_codec(ch=STEP_CH)
        jd = jdisc.NLayerDiscriminator(**DISC_KW)
        dvars = _np(jd.init(jax.random.PRNGKey(7), jnp.zeros((1, H, W, 1))))
        lp, lparams = jax_lpaps()
        cfg = dict(disc_start=1, **({"min_adapt_weight": 0.0, "max_adapt_weight": 1e4}
                                    if kind == "adaptive" else {}))
        tx_ae, tx_d = jvs.build_gan_optimizer(LR), jvs.build_gan_optimizer(LR)
        jstep = jvs.make_vqgan_train_step(codec, lp, jd, tx_ae, tx_d, jvs.VQGANLossConfig(**cfg),
                                          donate=False)
        jstate = jvs.VQGANTrainState.create(cparams, dvars, tx_ae, tx_d)
        state = tvs.VQGANTrainState.create(port_codec(ch=STEP_CH), from_jax.load_discriminator(
            tdisc.NLayerDiscriminator(**DISC_KW), dvars), LR)
        step = tvs.make_vqgan_train_step(port_lpaps(), tvs.VQGANLossConfig(**cfg))
        return (lambda js, x: jstep(js, lparams, x, LR)), jstate, state, step, _mel
    n = 3 if kind == "segmentation" else None
    codec, cparams, _, _ = jax_codec("VQSegmentationModel" if n else "VQNoDiscModel", n, STEP_CH)
    tx = jvs.build_gan_optimizer(LR)
    if n:
        jstep, lparams = jvs.make_vqgan_segmentation_train_step(codec, tx, donate=False), None
        step = tvs.make_vqgan_segmentation_train_step()

        def inputs(seed):
            labels = np.random.default_rng(seed).integers(0, n, (B, H, W))
            return np.eye(n, dtype=np.float32)[labels]
    else:
        lp, lparams = jax_lpaps()
        jstep = jvs.make_vqgan_nodisc_train_step(codec, lp, tx, donate=False)
        step, inputs = tvs.make_vqgan_nodisc_train_step(port_lpaps()), _mel
    jstate = jvs.VQGANTrainState.create(cparams, {"params": {}}, tx, tx)
    jstate = jstate.replace(disc_vars={}, disc_opt=None)
    state = tvs.VQGANTrainState.create(
        port_codec("VQSegmentationModel" if n else "VQNoDiscModel", n, STEP_CH), None, LR)
    return (lambda js, x: jstep(js, lparams, x, LR)), jstate, state, step, inputs


@pytest.mark.parametrize("adaptive", [False, True], ids=["constant", "adaptive"])
def test_vqgan_train_step_matches_jax(adaptive):
    """Three adversarial steps with LPAPS, disc_start 1 (the discriminator
    off at the first step, on at the next two): the metrics, every weight of
    both networks and the BatchNorm statistics after each step."""
    jstep, jstate, state, step, _ = _step_pair("adaptive" if adaptive else "constant")
    noisy = {}
    for i in range(3):
        mel = _mel(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(mel))
        state, m = step(state, _t(mel), LR)
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_array_equal(m["indices"].numpy(), np.asarray(jm["indices"]))
        _close_metrics(m, jm, METRICS, i + 1)
        assert float(m["disc_factor"]) == (0.0 if i == 0 else 1.0)
        _close_weights(_state_dicts(state), _jax_state_dicts(jstate), i + 1,
                       mark_zero_grads({"codec": state.codec, "disc": state.disc}, noisy))
        assert int(state.disc.state_dict()["main.3.num_batches_tracked"]) == 2 * (i + 1)
    if adaptive:
        assert 0.0 < float(m["d_weight"]) < 0.8 * 1e4
    else:
        assert float(m["d_weight"]) == pytest.approx(0.8)


def test_vqgan_nodisc_train_step_matches_jax():
    jstep, jstate, state, step, _ = _step_pair("nodisc")
    noisy = {}
    for i in range(3):
        mel = _mel(20 + i)
        jstate, jm = jstep(jstate, jnp.asarray(mel))
        state, m = step(state, _t(mel), LR)
        _close_metrics(m, jm, ("total_loss", "nll_loss", "p_loss", "quant_loss", "perplexity"), i)
        _close_weights(_state_dicts(state), _jax_state_dicts(jstate), i + 1,
                       mark_zero_grads({"codec": state.codec, "disc": state.disc}, noisy))


def test_vqgan_segmentation_train_step_matches_jax():
    jstep, jstate, state, step, inputs = _step_pair("segmentation")
    noisy = {}
    for i in range(3):
        x = inputs(30 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, _t(x), LR)
        assert m["nll_loss"].dtype == torch.float32
        _close_metrics(m, jm, ("total_loss", "nll_loss", "quant_loss", "perplexity"), i)
        _close_weights(_state_dicts(state), _jax_state_dicts(jstate), i + 1,
                       mark_zero_grads({"codec": state.codec, "disc": state.disc}, noisy))


def _adam_by_name(opt_state, to_state_dict, module, **extra):
    """(count, mu, nu) of an ``inject_hyperparams(optax.adam)`` state, the
    moments under the port's names and layouts."""
    s = opt_state.inner_state[0]
    names = {n for n, _ in module.named_parameters()}

    def by_name(tree):
        return {k: v for k, v in to_state_dict({"params": _np(tree), **extra}).items()
                if k in names}
    return int(s.count), by_name(s.mu), by_name(s.nu)


@pytest.mark.parametrize("kind", ["constant", "adaptive", "nodisc", "segmentation"])
def test_vqgan_step_gradients_match_jax(kind):
    """Three steps, each taken from the JAX step's state: its weights,
    BatchNorm statistics, both Adams' moments and its step counter are
    loaded into the port's before the step, so the two sides start each step
    equal. After it, the gradients the port's Adams took (``.grad``) against
    the ones JAX's took, read off optax's first moment: the codec's from the
    AE phase (the nll, d_weight, disc_factor and the codebook loss, through
    the discriminator before its update) and the discriminator's from the D
    phase (on the updated codec's fresh reconstruction). Tolerance:
    ``assert_grads_close``. The trajectories of free-running steps are the
    tests above."""
    jstep, jstate, state, step, inputs = _step_pair(kind)
    for i in range(3):
        from_jax.load_vqgan(state.codec, _np(jstate.ae_params))
        nets = [(state.codec, state.ae_opt, jstate.ae_opt, from_jax.vqgan_state_dict, {})]
        if state.disc is not None:
            dvars = _np(jstate.disc_vars)
            from_jax.load_discriminator(state.disc, dvars)
            nets.append((state.disc, state.disc_opt, jstate.disc_opt,
                         from_jax.discriminator_state_dict, {"batch_stats": dvars["batch_stats"]}))
        before = []
        for module, opt, jopt, to_sd, extra in nets:
            count, mu, nu = _adam_by_name(jopt, to_sd, module, **extra)
            set_adam_state(opt, dict(module.named_parameters()), mu, nu, count)
            before.append(mu)
        state.step = int(jstate.step)
        x = inputs(40 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x))
        state, m = step(state, _t(x), LR)
        np.testing.assert_array_equal(m["indices"].numpy(), np.asarray(jm["indices"]))
        jopts = [jstate.ae_opt, jstate.disc_opt]
        for (module, _, _, to_sd, extra), jopt, mu0 in zip(nets, jopts, before):
            _, mu, _ = _adam_by_name(jopt, to_sd, module, **extra)
            assert_grads_close(module, adam_grads(mu, mu0, 0.5), f"step {i + 1}")
        if kind in ("constant", "adaptive"):
            assert float(m["disc_factor"]) == (0.0 if i == 0 else 1.0)
            _close_metrics(m, jm, ("d_weight",), i + 1)


# -- the reference's names: the JAX package's converters read the port's state dicts -------------

def _round_trip(convert, module, params, *extra):
    """``convert`` (a ``torch_to_jax`` converter) fed the port's state dict
    gives back ``params``, leaf for leaf."""
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    got = convert(sd, params, *extra)
    want_leaves, tree = jax.tree_util.tree_flatten(params)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", ["2d batchnorm", "2d actnorm", "1d feats", "melgan",
                                  "vggishish", "lpaps"])
def test_jax_converters_read_the_port_state_dicts(name):
    from text_to_sound_synthesis_tpu.convert import torch_to_jax as t2j
    from text_to_sound_synthesis_tpu.models.melgan import MelGANDiscriminator as JMelD
    from text_to_sound_synthesis_torch.models.melgan import MelGANDiscriminator

    rng = np.random.default_rng(13)
    noisy = lambda tree: jax.tree_util.tree_map(   # off the init, so a mix-up shows
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a)).astype(np.float32), tree)
    if name in DISCS:
        jcls, tcls, kw, shape = DISCS[name]
        variables = noisy(_np(jcls(**kw).init(jax.random.PRNGKey(3), jnp.zeros(shape))))
        _round_trip(t2j.convert_discriminator, from_jax.load_discriminator(tcls(**kw), variables),
                    variables, "main.")
    elif name == "melgan":
        kw = dict(num_D=2, ndf=4, n_layers=2)
        params = noisy(_np(JMelD(**kw).init(jax.random.PRNGKey(4), jnp.zeros((1, 256, 1)))))
        _round_trip(t2j.convert_melgan_discriminator,
                    from_jax.load_melgan_discriminator(MelGANDiscriminator(**kw), params), params)
    elif name == "vggishish":
        # the VGG16 stack's convs (the JAX converter's feature indices) and a head of 7
        params = noisy(_np(JVGG(num_classes=7).init(jax.random.PRNGKey(6), jnp.zeros((1, H, W)),
                                                  return_features=True)))
        head = {k: {"kernel": np.zeros(shape, np.float32), "bias": np.zeros(shape[1], np.float32)}
                for k, shape in (("fc1", (512 * 50, 4096)), ("fc2", (4096, 4096)),
                                 ("fc3", (4096, 7)))}
        net = from_jax.load_vggishish(VGGishish(num_classes=7), dict(params["params"], **head))
        _round_trip(t2j.convert_vggishish, net, params)
    else:
        _round_trip(t2j.convert_lpaps, port_lpaps(), jax_lpaps()[1])
