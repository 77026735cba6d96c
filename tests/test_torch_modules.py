"""Each ported module against its JAX counterpart, and the reference-name
round trip.

A JAX module is initialised from a PRNG key; ``convert/from_jax.py`` loads its
parameters into the port's module; the same numpy input goes through both and
the outputs are compared in float32. The round trip passes the port's
``state_dict()`` through the JAX package's own ``convert/torch_to_jax.py``
converters and requires the JAX tree back exactly: the port uses the
reference's parameter names and layouts.
"""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.convert import torch_to_jax as t2j
from text_to_sound_synthesis_tpu.models.clip.text_model import CLIPTextEmbedding as JClip
from text_to_sound_synthesis_tpu.models.diffusion.embeddings import ContentEmbedding as JContentEmb
from text_to_sound_synthesis_tpu.models.diffusion.process import DiscreteDiffusion as JDiffusion
from text_to_sound_synthesis_tpu.models.melgan.generator import MelGANGenerator as JMelGAN
from text_to_sound_synthesis_tpu.models.melgan.interface import Vocoder as JVocoder
from text_to_sound_synthesis_tpu.models.vqgan.model import VQModel as JVQModel
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models.clip.text_model import CLIPTextEmbedding
from text_to_sound_synthesis_torch.models.diffusion.embeddings import ContentEmbedding
from text_to_sound_synthesis_torch.models.diffusion.process import DiscreteDiffusion
from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator, Vocoder
from text_to_sound_synthesis_torch.models.vqgan.model import VQModel

torch.set_num_threads(1)

# float32 on both sides; a few layers of matmuls, norms and softmaxes whose
# sums run in another order on each side
ATOL = 1e-4


def _apply(jm, params, *args, **kwargs):
    """``jm.apply`` under jit: one XLA program per call, not one per op."""
    return jax.jit(partial(jm.apply, **kwargs))(params, *args)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_equal(got, want):
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def _port_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


# -- CLIP text tower -----------------------------------------------------------

CLIP_SMALL = dict(num_embed=64, width=32, layers=2, heads=4, context_length=12)
CLIP_VARIANTS = {
    "diffsound": dict(embed_dim=32),
    "unnormalized": dict(embed_dim=32, normalize=False),
    "pick_last": dict(embed_dim=16, pick_last_embedding=True, keep_seq_len_dim=True),
    "additional_last": dict(embed_dim=16, additional_last_embedding=True),
    "embed_dim_1024": dict(embed_dim=1024),
}


@lru_cache(maxsize=None)  # one JAX init (and compile) per module config
def _clip_pair(variant):
    cfg = {**CLIP_SMALL, **CLIP_VARIANTS[variant]}
    jm = JClip(**cfg)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 12), jnp.int32)))
    port = from_jax.load_clip_text(CLIPTextEmbedding(**cfg), params)
    return jm, params, port


def _clip_tokens():
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 60, (2, 12)).astype(np.int32)
    toks[:, 0], toks[0, 5], toks[0, 6:] = 62, 63, -1   # SOT, EOT, negative pad ids
    toks[1, 9], toks[1, 10:] = 63, 0
    return toks


@pytest.mark.parametrize("variant", list(CLIP_VARIANTS))
def test_clip_text_matches_jax(variant):
    jm, params, port = _clip_pair(variant)
    toks = _clip_tokens()
    want = _apply(jm, params, jnp.asarray(toks))
    with torch.no_grad():
        got = port(torch.from_numpy(toks))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    else:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# -- content embedding and denoiser ---------------------------------------------

def test_content_embedding_matches_jax():
    jm = JContentEmb(num_embed=10, spatial_size=(3, 4), embed_dim=16)
    toks = np.random.default_rng(1).integers(0, 11, (2, 12)).astype(np.int32)
    toks[0, 0] = -1                    # clamped to 0, as in the reference
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(toks)))
    sd = from_jax.diffusion_state_dict({"params": {"backbone": {"content_emb": params["params"]}}})
    port = ContentEmbedding(num_embed=10, spatial_size=(3, 4), embed_dim=16)
    port.load_state_dict({k[len("transformer.content_emb."):]: torch.tensor(v)
                          for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(_apply(jm, params, jnp.asarray(toks))),
                               atol=1e-6)


def _denoiser_cfg(activate="GELU2", timestep_type="adalayernorm"):
    return dict(
        n_layer=2, n_embd=32, n_head=4, content_seq_len=12, condition_dim=16,
        content_spatial_size=(3, 4), block_activate=activate, timestep_type=timestep_type,
        content_emb_config={"params": {"num_embed": 10, "embed_dim": 32, "spatial_size": (3, 4)}},
    )


@lru_cache(maxsize=None)  # one JAX init (and compile) per module config
def _diffusion_pair(activate="GELU2", timestep_type="adalayernorm"):
    cfg = {"params": _denoiser_cfg(activate, timestep_type)}
    jm = JDiffusion(transformer_config=cfg, diffusion_step=8)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((2, 12), jnp.int32),
                         jnp.zeros((2, 5, 16)), jnp.zeros((2,), jnp.int32)))
    port = from_jax.load_diffusion(DiscreteDiffusion(transformer_config=cfg, diffusion_step=8),
                                   params)
    return jm, params, port


@pytest.mark.parametrize("activate, timestep_type", [
    ("GELU2", "adalayernorm"), ("GELU", "adalayernorm"), ("GELU2", "adalayernorm_abs")])
def test_backbone_logits_matches_jax(activate, timestep_type):
    jm, params, port = _diffusion_pair(activate, timestep_type)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 11, (2, 12)).astype(np.int32)
    cond = rng.standard_normal((2, 5, 16)).astype(np.float32)
    t = np.asarray([0, 7], np.int32)
    want = _apply(jm, params, jnp.asarray(toks), jnp.asarray(cond), jnp.asarray(t),
                    method=jm.backbone_logits)
    with torch.no_grad():
        got = port.backbone_logits(torch.from_numpy(toks), torch.from_numpy(cond),
                                   torch.from_numpy(t).long())
    assert got.shape == (2, 12, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_hoisted_tables_and_kvs_match_jax():
    """ada_tables / cond_kvs, and the logits of a step that reads them."""
    jm, params, port = _diffusion_pair()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 11, (2, 12)).astype(np.int32)
    cond = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want_tables = _apply(jm, params, method=jm.ada_tables)
    want_kvs = _apply(jm, params, jnp.asarray(cond), method=jm.cond_kvs)
    with torch.no_grad():
        tables = port.ada_tables()
        kvs = port.cond_kvs(torch.from_numpy(cond))
        for (g1, g2), (w1, w2) in zip(tables, want_tables):
            np.testing.assert_allclose(g1.numpy(), np.asarray(w1), atol=ATOL)
            np.testing.assert_allclose(g2.numpy(), np.asarray(w2), atol=ATOL)
        for (gk, gv), (wk, wv) in zip(kvs, want_kvs):
            assert gk.shape == wk.shape == (2, 5, 4, 8)
            np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL)
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL)
        t = 3
        got = port.backbone_logits(
            torch.from_numpy(toks), torch.from_numpy(cond), torch.full((2,), t),
            mods=[(a[t:t + 1], b[t:t + 1]) for a, b in tables], cond_kvs=kvs)
    want = _apply(jm, params, jnp.asarray(toks), jnp.asarray(cond), jnp.full((2,), t),
                    mods=[(a[t][None], b[t][None]) for a, b in want_tables],
                    cond_kvs=want_kvs, method=jm.backbone_logits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# -- VQGAN -------------------------------------------------------------------------

VQ_DD = dict(double_z=False, z_channels=16, resolution=16, in_channels=1, out_ch=1, ch=8,
             ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], dropout=0.0)


@lru_cache(maxsize=None)  # one JAX init (and compile) per module config
def _vqgan_pair():
    jm = JVQModel(ddconfig=VQ_DD, n_embed=10, embed_dim=16)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((1, 4, 16, 1))))
    port = from_jax.load_vqgan(VQModel(ddconfig=VQ_DD, n_embed=10, embed_dim=16), params)
    return jm, params, port


def test_vqgan_decode_code_matches_jax():
    jm, params, port = _vqgan_pair()
    code = np.random.default_rng(4).integers(0, 10, (2, 2, 8)).astype(np.int32)
    want = _apply(jm, params, jnp.asarray(code), method=jm.decode_code)
    with torch.no_grad():
        got = port.decode_code(torch.from_numpy(code))
    assert got.shape == (2, 4, 16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vqgan_encode_indices_matches_jax():
    jm, params, port = _vqgan_pair()
    mel = np.random.default_rng(5).uniform(-1, 1, (2, 4, 16, 1)).astype(np.float32)
    want = _apply(jm, params, jnp.asarray(mel), method=jm.encode_indices)
    with torch.no_grad():
        got = port.encode_indices(torch.from_numpy(mel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- MelGAN ----------------------------------------------------------------------------

@lru_cache(maxsize=None)  # one JAX init (and compile) per module config
def _melgan_pair():
    jm = JMelGAN(input_size=8, ngf=4)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(5), jnp.zeros((1, 6, 8))))
    port = from_jax.load_melgan_generator(MelGANGenerator(input_size=8, ngf=4), params)
    return jm, params, port


def test_melgan_generator_matches_jax():
    jm, params, port = _melgan_pair()
    mel = np.random.default_rng(6).uniform(0, 1, (2, 8, 6)).astype(np.float32)  # (B, C, T)
    want = _apply(jm, params, jnp.asarray(mel.transpose(0, 2, 1)))                 # NWC
    with torch.no_grad():
        got = port(torch.from_numpy(mel))
    assert got.shape == (2, 1, 6 * 256)
    np.testing.assert_allclose(got.numpy()[:, 0], np.asarray(want)[..., 0], atol=ATOL)


def test_vocoder_matches_jax():
    jm, params, port = _melgan_pair()
    spec = np.random.default_rng(7).uniform(0, 1, (2, 8, 6)).astype(np.float32)
    want = JVocoder(jm, params)(spec)
    got = Vocoder(port)(torch.from_numpy(spec))
    assert got.shape == (2, 6 * 256)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# -- reference-name round trip -------------------------------------------------------------

def _roundtrip_clip():
    _, params, port = _clip_pair("pick_last")
    return t2j.convert_clip_text(_port_sd(port), params), params


def _roundtrip_diffusion():
    _, params, port = _diffusion_pair()
    return t2j.convert_diffusion(_port_sd(port), params, prefix=""), params


def _roundtrip_vqgan():
    _, params, port = _vqgan_pair()
    return t2j.convert_vqgan(_port_sd(port), params), params


def _roundtrip_melgan():
    _, params, port = _melgan_pair()
    return t2j.convert_melgan_generator(_port_sd(port), params), params


@pytest.mark.parametrize("make", [_roundtrip_clip, _roundtrip_diffusion, _roundtrip_vqgan,
                                  _roundtrip_melgan], ids=["clip", "diffusion", "vqgan", "melgan"])
def test_state_dict_roundtrips_through_reference_converters(make):
    got, want = make()
    _assert_trees_equal(got, want)
