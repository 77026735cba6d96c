"""The port's checkpoint loaders, signal code and audio I/O against the JAX
package: the stage-1 codec ``.ckpt`` a config names, the MelGAN vocoder's
``args.yml`` + ``best_netG.pt``, ``wav_to_mel``, and the wav / artifact
helpers.

Every checkpoint is written here, into ``tmp_path``, in the reference's
layout (a Lightning ``{"state_dict": ...}`` with the training wrapper's
``loss.*`` entries, or a bare state dict; MelGAN's convs weight-normed as
``weight_g`` / ``weight_v``) from seeded weights, and both packages load the
same file.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_slice import ATOL, TINY_CFG, VQ_DD, _jax_slice
from text_to_sound_synthesis_tpu.models.diffsound import Diffsound as JDiffsound
from text_to_sound_synthesis_tpu.models.melgan import interface as jinterface
from text_to_sound_synthesis_tpu.models.vqgan.model import VQModel as JVQModel
from text_to_sound_synthesis_tpu.ops import signal as jsignal
from text_to_sound_synthesis_tpu.utils import artifacts as jartifacts
from text_to_sound_synthesis_tpu.utils import io as jio
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.convert.checkpoint import fold_weight_norm, load_torch_state_dict
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator, load_vocoder
from text_to_sound_synthesis_torch.models.melgan.generator import ResnetBlock
from text_to_sound_synthesis_torch.ops import signal as tsignal
from text_to_sound_synthesis_torch.utils import artifacts as tartifacts
from text_to_sound_synthesis_torch.utils import io as tio

torch.set_num_threads(1)

# the mel chain in f32 on both sides: FFTs and the filterbank product sum in
# another order; values in [0, 1] (log-mel: about [-5, 1])
MEL_ATOL = 2e-5
# a weight-norm fold in f32 on both sides, then the generator: as ATOL
WAV_ATOL = ATOL


def _codec_weights():
    """Codec weights other than the slice model's own: JAX params from
    another key, as the reference's state dict (torch tensors)."""
    jvq = JVQModel(ddconfig=VQ_DD, n_embed=10, embed_dim=16)
    params = jax.jit(jvq.init)(jax.random.PRNGKey(21), jnp.zeros((1, 4, 16, 1)))
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in from_jax.vqgan_state_dict(params).items()}
    return jvq, params, sd


def _write_codec(tmp_path, name: str, sd) -> str:
    path = str(tmp_path / name)
    if name.endswith(".ckpt"):       # the Lightning layout, with the GAN loss's weights
        torch.save({"state_dict": {**sd, "loss.discriminator.main.0.weight": torch.ones(4, 1, 3, 3),
                                   "loss.logvar": torch.zeros(())},
                    "epoch": 7, "global_step": 1234}, path)
    else:
        torch.save(sd, path)
    return path


def _cfg_with_codec(path: str) -> dict:
    cfg = copy.deepcopy(TINY_CFG)
    cfg["params"]["content_codec_config"]["params"]["ckpt_path"] = path
    return cfg


@pytest.mark.parametrize("name", ["codec.ckpt", "codec.pth", "codec.pt"])
def test_codec_checkpoint_loads_as_in_jax(tmp_path, name):
    jvq, params, sd = _codec_weights()
    path = _write_codec(tmp_path, name, sd)

    j = object.__new__(JDiffsound)     # its build_model needs the CLIP BPE table
    j.codec_ckpt_path = path
    _, _, _, slice_params, _ = _jax_slice()
    jparams = j._load_codec_params(slice_params["codec"])
    model = build_model(_cfg_with_codec(path), device="cpu", seed=3)
    for k, v in model.codec.state_dict().items():
        assert torch.equal(v, sd[k]), k
    code = np.random.default_rng(0).integers(0, 10, (2, 2, 8)).astype(np.int32)
    want = np.asarray(jvq.apply(jparams, jnp.asarray(code), method=jvq.decode_code))
    got = model.codec.decode_code(torch.from_numpy(code))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        want, np.asarray(jvq.apply(params, jnp.asarray(code), method=jvq.decode_code)), atol=0)

    unloaded = build_model(_cfg_with_codec(path), device="cpu", seed=3, load_codec=False)
    assert not torch.equal(unloaded.codec.decoder.conv_in.weight, sd["decoder.conv_in.weight"])


def test_codec_checkpoint_key_mismatch_raises(tmp_path):
    _, _, sd = _codec_weights()
    missing = dict(sd)
    del missing["decoder.conv_out.bias"]
    with pytest.raises(RuntimeError, match="decoder.conv_out.bias"):
        build_model(_cfg_with_codec(_write_codec(tmp_path, "missing.ckpt", missing)), device="cpu")
    stray = {**sd, "encoder.extra.weight": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="encoder.extra.weight"):
        build_model(_cfg_with_codec(_write_codec(tmp_path, "stray.pth", stray)), device="cpu")
    with pytest.raises(FileNotFoundError):
        build_model(_cfg_with_codec(str(tmp_path / "absent.ckpt")), device="cpu")


def test_codec_orbax_directory_raises(tmp_path):
    orbax = tmp_path / "codec_tree"
    orbax.mkdir()
    with pytest.raises(ValueError, match="orbax"):
        build_model(_cfg_with_codec(str(orbax)), device="cpu")


def test_load_torch_state_dict_unwraps_like_jax(tmp_path):
    from text_to_sound_synthesis_tpu.convert import torch_to_jax as t2j

    _, _, sd = _codec_weights()
    path = _write_codec(tmp_path, "codec.ckpt", sd)
    got, want = load_torch_state_dict(path), t2j.load_torch_state_dict(path)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    torch.save({"ema": sd, "model": {}}, str(tmp_path / "stage2.pth"))
    assert sorted(load_torch_state_dict(str(tmp_path / "stage2.pth"), key="ema")) == sorted(sd)


# -- the vocoder ------------------------------------------------------------------------

ARGS_PLAIN = "n_mel_channels: 4\nngf: 4\nn_residual_layers: 2\nseq_len: 8192\n"
# the reference's args.yml is a dumped argparse.Namespace: safe_load refuses
# its python tag, and the three fields are read line by line
ARGS_TAGGED = ("!!python/object:argparse.Namespace\nn_mel_channels: 4\nngf: 4\n"
               "n_residual_layers: 2\nsave_path: logs/x\n")


def _write_vocoder(root, args_text: str, seed: int = 0) -> dict:
    """A seeded generator in the reference's weight-norm layout: every conv's
    weight as a direction v and a per-output-channel scale g."""
    rng = np.random.default_rng(seed)
    gen = MelGANGenerator(input_size=4, ngf=4, n_residual_layers=2)
    sd = {}
    for k, v in gen.state_dict().items():
        if k.endswith(".weight"):
            g = rng.uniform(0.5, 2.0, (v.shape[0],) + (1,) * (v.dim() - 1)).astype(np.float32)
            sd[k[:-len("weight")] + "weight_g"] = torch.from_numpy(g)
            sd[k[:-len("weight")] + "weight_v"] = torch.from_numpy(
                rng.standard_normal(tuple(v.shape)).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32) * 0.1)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "args.yml"), "w") as f:
        f.write(args_text)
    torch.save(sd, os.path.join(root, "best_netG.pt"))
    return sd


@pytest.mark.parametrize("args_text", [ARGS_PLAIN, ARGS_TAGGED], ids=["plain", "python_tags"])
def test_load_vocoder_matches_jax(tmp_path, args_text):
    root = str(tmp_path / "vocoder")
    sd = _write_vocoder(root, args_text)
    want_voc = jinterface.load_vocoder(root)
    voc = load_vocoder(root, device="cpu")
    assert sum(isinstance(m, ResnetBlock) for m in voc.gen.model) == 4 * 2   # args.yml's 2 a stage
    assert want_voc.gen.n_residual_layers == 2
    np.testing.assert_array_equal(voc.gen.model[1].weight.detach().numpy(),
                                  fold_weight_norm(sd, "model.1").numpy())
    spec = np.random.default_rng(1).uniform(0, 1, (2, 4, 12)).astype(np.float32)
    want = want_voc(spec)
    got = voc(torch.from_numpy(spec))
    assert got.shape == (2, 12 * 256)
    np.testing.assert_allclose(got.numpy(), want, atol=WAV_ATOL)
    # wav -> mel on the vocoder, as JAX's Vocoder.wav2mel
    wav = np.random.default_rng(2).uniform(-0.5, 0.5, (2, 6000)).astype(np.float32)
    np.testing.assert_allclose(voc.wav2mel(wav).numpy(), want_voc.wav2mel(wav), atol=MEL_ATOL)


def test_fold_weight_norm_matches_jax():
    from text_to_sound_synthesis_tpu.convert import torch_to_jax as t2j

    rng = np.random.default_rng(4)
    sd = {"a.weight_g": rng.uniform(0.5, 2, (6, 1, 1)).astype(np.float32),
          "a.weight_v": rng.standard_normal((6, 5, 7)).astype(np.float32),
          "b.weight": rng.standard_normal((3, 2)).astype(np.float32)}
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    for base in ("a", "b"):
        np.testing.assert_allclose(fold_weight_norm(tsd, base).numpy(), t2j.fold_weight_norm(sd, base),
                                   rtol=1e-6, atol=0)


def test_load_vocoder_refuses(tmp_path):
    sd = _write_vocoder(str(tmp_path / "v1"), ARGS_PLAIN)
    del sd["model.1.weight_g"]
    torch.save(sd, str(tmp_path / "v1" / "best_netG.pt"))
    with pytest.raises(RuntimeError, match="model.1.weight"):
        load_vocoder(str(tmp_path / "v1"), device="cpu")
    (tmp_path / "v2" / "melgan_params").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        load_vocoder(str(tmp_path / "v2"), device="cpu")
    (tmp_path / "v3").mkdir()
    with pytest.raises(FileNotFoundError):
        load_vocoder(str(tmp_path / "v3"), device="cpu")


# -- signal, wav and artifact helpers ------------------------------------------------------

def _wav(n: int = 22050, batch: int = 2, seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 4000, (batch, 1)) * t)
    return (tone + 0.05 * rng.standard_normal((batch, n))).astype(np.float32)


@pytest.mark.parametrize("fn", ["wav_to_mel", "audio_to_logmel", "stft_magnitude"])
def test_signal_matches_jax(fn):
    y = _wav()
    want = np.asarray(getattr(jsignal, fn)(jnp.asarray(y)))
    got = getattr(tsignal, fn)(torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    tol = MEL_ATOL if fn != "stft_magnitude" else MEL_ATOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_signal_numpy_part_is_the_jax_one():
    """Copied unchanged: the filterbank bit for bit, the host mel chain too."""
    np.testing.assert_array_equal(tsignal.mel_filterbank(22050, 1024, 80, 125, 7600),
                                  jsignal.mel_filterbank(22050, 1024, 80, 125, 7600))
    y = _wav(8000, 1)[0]
    np.testing.assert_array_equal(tsignal.wav_to_mel_np(y), jsignal.wav_to_mel_np(y))
    assert tsignal.CANONICAL == tsignal.MelConfig() and hash(tsignal.CANONICAL) == hash(
        jsignal.CANONICAL)


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24"])
def test_wav_bytes_match_jax(tmp_path, subtype):
    y = _wav(5000, 1)[0] * 3.0             # past [-1, 1]: clipped on both sides
    data = tio.wav_bytes(22050, y, subtype)
    assert data == jio.wav_bytes(22050, y, subtype)
    path = str(tmp_path / "sub" / "a.wav")
    tio.write_wav(path, 22050, y, subtype)
    with open(path, "rb") as f:
        assert f.read() == data
    back, sr = tio.read_wav(path)
    want, _ = jio.read_wav(path)
    np.testing.assert_array_equal(back, want)
    # PCM_16 truncates y * 32767 and reads back / 32768: within two steps;
    # PCM_24 rounds y * 8388607: within one
    step = 2.0 / 32768.0 if subtype == "PCM_16" else 1.0 / 8388608.0
    assert sr == 22050 and np.abs(back - np.clip(y, -1, 1)).max() <= step


def test_read_wav_resamples_as_jax(tmp_path):
    path = str(tmp_path / "b.wav")
    tio.write_wav(path, 16000, _wav(4000, 1)[0], "PCM_16")
    got, sr = tio.read_wav(path, target_sr=22050)
    want, _ = jio.read_wav(path, target_sr=22050)
    assert sr == 22050 and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_artifacts_match_jax(tmp_path):
    (tmp_path / "vocoder").mkdir()
    for f in ("best_netG.pt", "args.yml"):
        (tmp_path / "vocoder" / f).write_bytes(b"x")
    (tmp_path / "lpaps.pt").write_bytes(b"not the release")
    (tmp_path / "diffsound_audiocaps.pth").write_bytes(b"y")
    assert tartifacts.ARTIFACTS == jartifacts.ARTIFACTS
    assert tartifacts.verify(str(tmp_path)) == [tuple(s) for s in jartifacts.verify(str(tmp_path))]
    assert tartifacts.md5sum(str(tmp_path / "lpaps.pt")) == jartifacts.md5sum(str(tmp_path / "lpaps.pt"))
    assert tartifacts.locate(str(tmp_path), "vocoder") == str(tmp_path / "vocoder")
