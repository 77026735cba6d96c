"""``Diffsound.generate_long`` of the port against the JAX package's, and the
port's entry points' default device.

Long-form generation repeats each caption ``n`` times, makes all the
overlapping 848-frame segments in one sampler call (``generate``, or with an
engine ``generate_int8``), and cross-fades their mels. The cross-fade is held
to JAX's on the same fixed mels, both packages' generate functions patched to
return them; a tiny composite then runs it end to end on both engines.
"""

import inspect
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from text_to_sound_synthesis_tpu.models.diffsound import Diffsound as JDiffsound
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.utils.config import load_yaml_config

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N_MELS, SEG = 2, 80, 848
# f32 on both sides, the same operations in the same order
ATOL = 1e-6


def _flagship():
    """The flagship composite without storage: 848-frame segments (5 x 53
    tokens, a codec that upsamples time 16-fold)."""
    cfg = load_yaml_config(os.path.join(REPO, "configs", "diffsound_audiocaps.yaml"))
    return build_model(cfg, device="meta")


def _jax_flagship():
    """What the JAX ``generate_long`` reads of its object besides the
    generate functions: the codec's ``ch_mult`` and the token grid."""
    jd = object.__new__(JDiffsound)
    jd.codec = SimpleNamespace(ddconfig={"ch_mult": [1, 1, 2, 2, 4]})
    jd.token_hw = (5, 53)
    return jd


def _cond():
    return np.arange(B * 77, dtype=np.int32).reshape(B, 77) % 500


# (duration, overlap): three segments at the default overlap, overlaps past
# half a segment (three or more segments cover a frame), a one-frame
# overlap, and requests of one segment or less
CASES = [(2120, 160), (2120, 424), (2120, 500), (2120, 700), (1000, 1), (900, 847),
         (SEG, 160), (500, 160)]


@pytest.mark.parametrize("engine", [False, True])
@pytest.mark.parametrize("duration,overlap", CASES)
def test_crossfade_matches_jax_on_fixed_mels(monkeypatch, duration, overlap, engine):
    n = 1 if duration <= SEG else -(-(duration - SEG) // (SEG - overlap)) + 1
    fixed = np.random.default_rng(duration + overlap).uniform(
        -1, 1, (B * n, N_MELS, SEG, 1)).astype(np.float32)
    calls = {"jax": [], "port": []}

    def jax_gen(*args, **kw):
        c = args[-1]
        calls["jax"].append(np.asarray(c))
        return jnp.asarray(fixed[:c.shape[0]])

    def port_gen(*args, **kw):
        c = args[-1]
        calls["port"].append(c.numpy())
        return torch.from_numpy(fixed[:c.shape[0]])

    jd, model = _jax_flagship(), _flagship()
    name = "generate_int8" if engine else "generate"
    jd.__dict__[name] = jax_gen
    monkeypatch.setattr(model, name, port_gen)
    qp = object() if engine else None
    want = jd.generate_long(None, None, jnp.asarray(_cond()), duration_frames=duration,
                            overlap_frames=overlap, qp=qp)
    got = model.generate_long(torch.Generator(), torch.from_numpy(_cond()),
                              duration_frames=duration, overlap_frames=overlap, qp=qp)
    assert got.shape == (B, N_MELS, duration, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # one sampler call of B * n rows, each caption repeated n times in a row
    assert len(calls["port"]) == len(calls["jax"]) == 1
    np.testing.assert_array_equal(calls["port"][0], calls["jax"][0])
    np.testing.assert_array_equal(calls["port"][0], np.repeat(_cond(), n, axis=0))


@pytest.mark.parametrize("overlap", [0, -5, SEG, SEG + 1])
def test_overlap_outside_the_segment_raises(overlap):
    with pytest.raises(ValueError, match="overlap_frames"):
        _flagship().generate_long(torch.Generator(), torch.from_numpy(_cond()),
                                  duration_frames=2120, overlap_frames=overlap)


@pytest.fixture(scope="module")
def tiny():
    """The tiny composite of tests/test_torch_slice.py (16-frame segments)."""
    from test_torch_slice import TINY_CFG, _cond_tokens

    return build_model(TINY_CFG, device="cpu", seed=0), torch.from_numpy(_cond_tokens())


@pytest.mark.parametrize("engine", [None, 4, 8])
def test_generate_long_end_to_end(tiny, monkeypatch, engine):
    """28 frames at an overlap of 4 on the tiny composite: two 16-frame
    segments per caption from one sampler call, on the bf16 path and on the
    W4A8 and W8A8 engines."""
    model, cond = tiny
    qp = None if engine is None else model.quantize_for_serving(weight_bits=engine)
    name = "generate" if qp is None else "generate_int8"
    rows = []
    real = getattr(model, name)
    monkeypatch.setattr(model, name, lambda *a, **kw: rows.append(a[-1].shape[0]) or real(*a, **kw))
    mel = model.generate_long(torch.Generator().manual_seed(3), cond, duration_frames=28,
                              overlap_frames=4, qp=qp)
    assert rows == [2 * cond.shape[0]]
    assert mel.shape == (cond.shape[0], 4, 28, 1) and torch.isfinite(mel).all()
    short = model.generate_long(torch.Generator().manual_seed(3), cond, duration_frames=10,
                                overlap_frames=4, qp=qp)
    assert rows[-1] == cond.shape[0] and short.shape == (cond.shape[0], 4, 10, 1)


def test_entry_points_default_to_the_card():
    """``build_model`` and ``load_int8_engine`` put what they make on the card
    unless the caller asks for another device (read from the signatures:
    nothing is built here)."""
    for fn in (build_model, from_jax.load_int8_engine):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
