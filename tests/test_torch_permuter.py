"""The port's token-grid permuters (``ops/permuter.py``) against the JAX
package's: the index tables, the forward and reverse calls on a seeded
(2, L) int array, the registered names and the errors on bad grids, at the
grids ``tests/test_composite.py`` uses them on; then the tiny port
``Diffsound`` and ``Net2NetTransformer`` built from a config naming each of
the eight permuters, under either registered name, their token paths
against the JAX package's on the same weights (f32 both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_to_sound_synthesis_tpu.models import gpt as jgpt
from text_to_sound_synthesis_tpu.models.diffsound import Diffsound as JDiffsound
from text_to_sound_synthesis_tpu.ops import permuter as jperm
from text_to_sound_synthesis_tpu.utils.config import instantiate_from_config as j_instantiate
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models import gpt as tgpt
from text_to_sound_synthesis_torch.ops import permuter as tperm
from text_to_sound_synthesis_torch.utils.config import GLOBAL_REGISTRY, instantiate_from_config

from tests.test_torch_gpt import _net2net, _net2net_cfg
from tests.test_torch_slice import ATOL, TINY_CFG, _jax_slice

torch.set_num_threads(1)

NEW = ("Subsample", "ZCurve", "SpiralOut", "SpiralIn", "Random", "AlternateParsing")
ALL = ("Identity", "ColumnMajor") + NEW
GRIDS = ((4, 4), (4, 8), (8, 8), (5, 53), (3, 3))
NAMES = ("text_to_sound_synthesis_tpu.ops.permuter.{}",
         "specvqgan.modules.transformer.permuter.{}")
# a grid of 16 cells, the tiny models' token count: square for the spirals
# and Subsample, the tiny codec's (2, 8) for the others
MODEL_HW = {"Subsample": (4, 4), "SpiralOut": (4, 4), "SpiralIn": (4, 4)}


@pytest.mark.parametrize("hw", GRIDS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("name", NEW)
def test_permuter_matches_jax(name, hw):
    """The tables and calls equal JAX's; a grid JAX refuses the port refuses
    with the same error type; both registered names resolve to the port's
    class."""
    for target in NAMES:
        assert GLOBAL_REGISTRY.resolve(target.format(name)) is getattr(tperm, name)
    try:
        want = getattr(jperm, name)(*hw)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(e)):
            getattr(tperm, name)(*hw)
        return
    got = getattr(tperm, name)(*hw)
    np.testing.assert_array_equal(got.forward_idx, np.asarray(want.forward_idx))
    np.testing.assert_array_equal(got.backward_idx, np.asarray(want.backward_idx))
    x = np.random.default_rng(hw[0] * 100 + hw[1]).integers(0, 1024, (2, hw[0] * hw[1]))
    fwd = got(torch.from_numpy(x))
    np.testing.assert_array_equal(fwd.numpy(), np.asarray(want(jnp.asarray(x))))
    np.testing.assert_array_equal(got(fwd, reverse=True).numpy(),
                                  np.asarray(want(jnp.asarray(fwd.numpy()), reverse=True)))
    np.testing.assert_array_equal(got(fwd, reverse=True).numpy(), x)


@pytest.mark.parametrize("name", NEW)
def test_permuter_other_lengths(name):
    """The base class's behaviour off L = H*W: a longer sequence keeps its
    first H*W positions, permuted, as JAX's ``jnp.take`` does; a shorter one
    raises ValueError (JAX fills the missing positions with INT_MIN)."""
    hw = MODEL_HW.get(name, (4, 8))
    L = hw[0] * hw[1]
    got, want = getattr(tperm, name)(*hw), getattr(jperm, name)(*hw)
    x = np.random.default_rng(7).integers(0, 1024, (2, L + 5))
    for reverse in (False, True):
        out = got(torch.from_numpy(x), reverse=reverse)
        assert out.shape == (2, L)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want(jnp.asarray(x), reverse=reverse)))
        with pytest.raises(ValueError):
            got(torch.from_numpy(x[:, :L - 1]), reverse=reverse)


def _permuter_cfg(name, pfx):
    H, W = MODEL_HW.get(name, (2, 8))
    return {"target": pfx.format(name), "params": {"H": H, "W": W}}


@pytest.mark.parametrize("pfx", NAMES, ids=("jax_name", "reference_name"))
@pytest.mark.parametrize("name", ALL)
def test_diffsound_builds_with_permuter(name, pfx):
    """The tiny port ``Diffsound`` built with the permuter: ``encode_content``
    equal to JAX's ``Diffsound.encode_content``, ``decode_tokens`` within the
    slice's ATOL of JAX's, on the same codec weights."""
    _, _, jds0, params, _ = _jax_slice()
    cfg = {**TINY_CFG, "params": {**TINY_CFG["params"],
                                  "first_stage_permuter_config": _permuter_cfg(name, pfx)}}
    model = from_jax.load_diffsound(build_model(cfg, device="cpu"), params)
    assert type(model.permuter) is getattr(tperm, name)
    jds = object.__new__(JDiffsound)
    jds.codec, jds.token_hw = jds0.codec, jds0.token_hw
    jds.permuter = j_instantiate(_permuter_cfg(name, NAMES[0]))
    mel = np.random.default_rng(3).uniform(-1, 1, (2, 4, 16, 1)).astype(np.float32)
    tokens = model.encode_content(torch.from_numpy(mel))
    want = np.asarray(jds.encode_content(params, jnp.asarray(mel)))
    np.testing.assert_array_equal(tokens.numpy(), want)
    got_mel = model.decode_tokens(tokens).numpy()
    np.testing.assert_allclose(got_mel, np.asarray(jds.decode_tokens(params, jnp.asarray(want))),
                               atol=ATOL)


@pytest.mark.parametrize("pfx", NAMES, ids=("jax_name", "reference_name"))
@pytest.mark.parametrize("name", ALL)
def test_net2net_builds_with_permuter(name, pfx):
    """The tiny port ``Net2NetTransformer`` built with the permuter:
    ``encode_to_z`` equal to JAX's, ``decode_to_img`` within 1e-4 of JAX's,
    on the same weights."""
    _, p, _ = _net2net()
    cfg = {**_net2net_cfg(), "first_stage_permuter_config": _permuter_cfg(name, pfx)}
    port = from_jax.load_net2net(tgpt.Net2NetTransformer(**cfg), p)
    assert type(port.permuter) is getattr(tperm, name)
    jm = jgpt.Net2NetTransformer(**{**cfg, "first_stage_permuter_config":
                                    _permuter_cfg(name, NAMES[0])})
    mel = np.random.default_rng(10).uniform(-1, 1, (2, 4, 16, 1)).astype(np.float32)
    z = port.encode_to_z(torch.from_numpy(mel))
    want = np.asarray(jm.encode_to_z(p, jnp.asarray(mel)))
    np.testing.assert_array_equal(z.numpy(), want)
    got = port.decode_to_img(z, (2, 8)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.decode_to_img(p, jnp.asarray(want), (2, 8))),
                               atol=1e-4)


def test_permuters_resolve_by_config():
    """``instantiate_from_config`` builds each of the eight under both names."""
    for name in ALL:
        for pfx in NAMES:
            obj = instantiate_from_config(_permuter_cfg(name, pfx))
            assert type(obj) is getattr(tperm, name)
    assert set(tperm.__all__) == set(ALL)
