"""The port's CLIP vision tower (``models/clip/vision_model.py``) against the
JAX package's ``ClipVisionEncoder``, both ways through the bridges: the JAX
init into the port (``convert.from_jax.load_clip_vision``), and the port's
seeded init into JAX through the JAX package's own converter
(``convert_clip_vision``), which takes the port's ``state_dict`` as it is.
Input 32, patch 8, width 64, 2 layers, 4 heads, output 32; f32 both sides,
outputs within 1e-5 (|y| ~ 1: the two libraries' matmul and LayerNorm
orders part at ~1e-6)."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.convert.torch_to_jax import convert_clip_vision
from text_to_sound_synthesis_tpu.models.clip.vision_model import ClipVisionEncoder as JVision
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models.clip import ClipVisionEncoder

torch.set_num_threads(1)

GEOM = dict(input_resolution=32, patch_size=8, width=64, layers=2, heads=4, output_dim=32)
ATOL = 1e-5


def _images(n=3):
    return np.random.default_rng(0).standard_normal((n, 32, 32, 3)).astype(np.float32)


def _jax():
    jm = JVision(**GEOM)
    return jm, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))


def test_jax_weights_into_the_port():
    jm, params = _jax()
    port = from_jax.load_clip_vision(ClipVisionEncoder(**GEOM), params)
    x = _images()
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    assert got.shape == (3, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_port_state_dict_through_convert_clip_vision():
    """The port's seeded ``state_dict`` goes through ``convert_clip_vision``
    unchanged (bare, and under a checkpoint's ``visual.`` prefix), comes back
    through ``clip_vision_state_dict`` bit for bit, and JAX's tower on it
    gives the port's outputs."""
    jm, params = _jax()
    port = ClipVisionEncoder(**GEOM).init_params(torch.Generator().manual_seed(3))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    converted = convert_clip_vision(sd, params, prefix="")
    prefixed = convert_clip_vision({f"visual.{k}": v for k, v in sd.items()}, params)
    back = from_jax.clip_vision_state_dict(converted)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    jax.tree_util.tree_map(np.testing.assert_array_equal, converted, prefixed)
    x = _images()
    want = np.asarray(jax.jit(jm.apply)(converted, jnp.asarray(x)))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_seeded_init_draws_like_flax():
    """The class token, positions and ``proj`` ~ N(0, 1 / width) as the JAX
    module's ``normal(width ** -0.5)``; the conv stem without a bias."""
    port = ClipVisionEncoder(input_resolution=224, width=768, layers=1, heads=12)
    port.init_params(torch.Generator().manual_seed(0))
    assert port.conv1.bias is None and port.positional_embedding.shape == (50, 768)
    for p in (port.positional_embedding, port.proj):
        assert abs(float(p.detach().std()) - 768 ** -0.5) < 2e-3
