"""The class-conditional and unconditional denoisers of the port against the
JAX package's (``Condition2SpecTransformer``, ``UnCondition2SpecTransformer``,
their ``selfcondition`` / ``self`` blocks, and ``ContentEmbedding`` with
``pos_emb_type="parameter"``): the same numpy inputs, the JAX init bridged
by ``convert.from_jax``, f32 both sides, outputs within ATOL. Sizes are
``tests/test_diffusion_model.py::test_class_conditional_and_unconditional_backbones``'s."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.models.diffusion import backbone as jbb
from text_to_sound_synthesis_tpu.models.diffusion.embeddings import \
    ContentEmbedding as JContentEmbedding
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models.diffusion import backbone as tbb
from text_to_sound_synthesis_torch.models.diffusion.embeddings import ContentEmbedding
from text_to_sound_synthesis_torch.utils.config import instantiate_from_config

torch.set_num_threads(1)

ATOL = 1e-5
# the sinusoidal timestep embedding ('abs') takes sin / cos of angles up to
# t / 8 * 4000 rad: an f32 ulp of exp's frequencies moves such an angle by
# ~1e-4 rad, and XLA and torch round them apart; a logit moves by ~2e-5
ABS_ATOL = 1e-4
HW = (3, 4)


def _emb_cfg(pos: str):
    return {"params": {"num_embed": 10, "embed_dim": 32, "spatial_size": HW,
                       "pos_emb_type": pos}}


def _perturb(tree, rng):
    """Every leaf plus seeded noise: zero-initialised leaves (biases, the
    'parameter' positions) must reach the output too."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), tree)


def _inputs(rng):
    tokens = rng.integers(0, 11, (2, 12)).astype(np.int32)
    tokens[0, 0] = -3                                # clamped to 0 by both
    return tokens, np.asarray([1, 5], np.int32)


@pytest.mark.parametrize("pos", ["embedding", "parameter"])
def test_content_embedding_matches_jax(pos):
    rng = np.random.default_rng(0)
    jm = JContentEmbedding(10, HW, 32, pos_emb_type=pos)
    tokens, _ = _inputs(rng)
    p = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens)), rng)
    port = ContentEmbedding(10, HW, 32, pos_emb_type=pos)
    sd = from_jax._denoiser_state_dict({"content_emb": p["params"]})
    port.load_state_dict({k[len("content_emb."):]: torch.tensor(v) for k, v in sd.items()})
    if pos == "parameter":
        assert isinstance(port.height_emb, torch.nn.Parameter) and port.width_emb.shape == (4, 32)
    want = np.asarray(jm.apply(p, jnp.asarray(tokens)))
    got = port(torch.from_numpy(tokens)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _condition(pos, act="GELU2", timestep_type="adalayernorm", class_type="adalayernorm"):
    kw = dict(class_number=7, n_layer=2, n_embd=32, n_head=4, content_seq_len=12,
              diffusion_step=8, content_spatial_size=HW, content_emb_config=_emb_cfg(pos),
              block_activate=act, timestep_type=timestep_type, class_type=class_type)
    return jbb.Condition2SpecTransformer(**kw), tbb.Condition2SpecTransformer(**kw)


@pytest.mark.parametrize("pos,act,timestep_type,class_type", [
    ("embedding", "GELU2", "adalayernorm", "adalayernorm"),
    ("parameter", "GELU2", "adalayernorm", "adalayernorm"),
    ("embedding", "GELU", "adalayernorm_abs", "adalayernorm"),
])
def test_condition_denoiser_matches_jax(pos, act, timestep_type, class_type):
    """Logits equal JAX's; a class id moves its own row's logits and no
    other's (``test_diffusion_model.py:199-201``)."""
    rng = np.random.default_rng(1)
    jm, port = _condition(pos, act, timestep_type, class_type)
    tokens, t = _inputs(rng)
    cls = np.asarray([2, 5], np.int32)
    p = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens), jnp.asarray(cls),
                         jnp.asarray(t)), rng)
    from_jax.load_denoiser(port, p)
    run_j = lambda c: np.asarray(jm.apply(p, jnp.asarray(tokens), jnp.asarray(c), jnp.asarray(t)))
    run_t = lambda c: port(torch.from_numpy(tokens), torch.from_numpy(c),
                           torch.from_numpy(t)).detach().numpy()
    atol = ABS_ATOL if "abs" in timestep_type else ATOL
    got = run_t(cls)
    assert got.shape == (2, 12, 10)
    np.testing.assert_allclose(got, run_j(cls), atol=atol)
    other = np.asarray([[3], [5]], np.int32)           # (B, 1) ids, as JAX reshapes them
    got2 = run_t(other)
    np.testing.assert_allclose(got2, run_j(other), atol=atol)
    assert not np.allclose(got[0], got2[0])
    np.testing.assert_allclose(got[1], got2[1], atol=1e-6)


@pytest.mark.parametrize("pos", ["embedding", "parameter"])
def test_uncondition_denoiser_matches_jax(pos):
    rng = np.random.default_rng(2)
    kw = dict(n_layer=2, n_embd=32, n_head=4, content_seq_len=12, diffusion_step=8,
              content_spatial_size=HW, content_emb_config=_emb_cfg(pos))
    jm, port = jbb.UnCondition2SpecTransformer(**kw), tbb.UnCondition2SpecTransformer(**kw)
    tokens, t = _inputs(rng)
    p = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens), None, jnp.asarray(t)), rng)
    from_jax.load_denoiser(port, p)
    want = np.asarray(jm.apply(p, jnp.asarray(tokens), None, jnp.asarray(t)))
    got = port(torch.from_numpy(tokens), None, torch.from_numpy(t)).detach().numpy()
    assert got.shape == (2, 12, 10)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("target,cls", [
    ("text_to_sound_synthesis_tpu.models.diffusion.Condition2SpecTransformer",
     tbb.Condition2SpecTransformer),
    ("sound_synthesis.modeling.transformers.transformer_utils.Condition2ImageTransformer",
     tbb.Condition2SpecTransformer),
    ("text_to_sound_synthesis_tpu.models.diffusion.UnCondition2SpecTransformer",
     tbb.UnCondition2SpecTransformer),
    ("sound_synthesis.modeling.transformers.transformer_utils.UnCondition2ImageTransformer",
     tbb.UnCondition2SpecTransformer),
])
def test_denoisers_registered_under_both_names(target, cls):
    """Both of the JAX package's names build the port's module; the
    defaults are JAX's (24 x d1024 x 1000 classes; 24 x d512 on 16 x 16)."""
    with torch.device("meta"):
        m = instantiate_from_config({"target": target})
    assert type(m) is cls and len(m.blocks) == 24
    if cls is tbb.Condition2SpecTransformer:
        assert m.blocks[0].ln2.emb.weight.shape == (1000, 1024)
        assert m.content_emb.spatial_size == (5, 53)
    else:
        assert m.to_logits[1].weight.shape == (256, 512)
        assert m.content_emb.spatial_size == (16, 16)
        assert isinstance(m.blocks[0].ln2, torch.nn.LayerNorm)
