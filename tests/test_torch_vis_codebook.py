"""The port's ``vis_codebook`` CLI against the JAX package's codec: a seeded
wav through a small codec (80 mel bins, 16 frames, a 40 x 8 grid of 10
codes) written as a Lightning ``.ckpt`` from the JAX init
(``convert.from_jax.vqgan_state_dict``). ``tokens.npy`` equals JAX's
``VQModel.encode`` indices on the same mel (the JAX package's own
``wav_to_mel_np``), ``reconstruction.npy`` is within 1e-5 of JAX's decode
(clipped to [0, 1]; f32 both sides, |mel| <= 1), and the report prints the
bitrate; with a tiny MelGAN directory the two wavs are written."""

import math
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.models.vqgan import VQModel as JVQModel
from text_to_sound_synthesis_tpu.ops.signal import wav_to_mel_np as j_wav_to_mel
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.engine.checkpoint import save_checkpoint
from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator
from text_to_sound_synthesis_torch.tools import vis_codebook
from text_to_sound_synthesis_torch.utils.io import write_wav

torch.set_num_threads(1)

CODEC = {"embed_dim": 16, "n_embed": 10,
         "ddconfig": dict(double_z=False, z_channels=16, resolution=16, in_channels=1, out_ch=1,
                          ch=8, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8],
                          dropout=0.0)}


def test_vis_codebook_matches_jax_codec(tmp_path, capsys):
    jm = JVQModel(ddconfig=CODEC["ddconfig"], n_embed=10, embed_dim=16)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 80, 16, 1)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(     # nonzero biases: the codes spread
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), params)
    ckpt = tmp_path / "codec.ckpt"
    save_checkpoint(str(ckpt), {"state_dict": {
        k: torch.from_numpy(np.asarray(v)) for k, v in from_jax.vqgan_state_dict(params).items()}})
    cfg = tmp_path / "codec.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"params": {"content_codec_config": {
        "target": "text_to_sound_synthesis_tpu.models.vqgan.VQModel", "params": CODEC}}}}))
    wav = (np.random.default_rng(2).standard_normal(22050 * 3) * 0.1).astype(np.float32)
    write_wav(str(tmp_path / "clip.wav"), 22050, wav)
    voc = tmp_path / "voc"
    voc.mkdir()
    (voc / "args.yml").write_text("n_mel_channels: 80\nngf: 4\nn_residual_layers: 1\n")
    torch.save(MelGANGenerator(input_size=80, ngf=4, n_residual_layers=1).state_dict(),
               voc / "best_netG.pt")

    out = tmp_path / "vis"
    capsys.readouterr()
    assert vis_codebook.main(["--wav", str(tmp_path / "clip.wav"), "--config", str(cfg),
                              "--ckpt", str(ckpt), "--outdir", str(out), "--vocoder", str(voc),
                              "--device", "cpu"]) == 0
    report = capsys.readouterr().out

    from text_to_sound_synthesis_torch.utils.io import read_wav
    y = np.zeros(22050 * 10, np.float32)
    w, _ = read_wav(str(tmp_path / "clip.wav"), 22050)
    y[: len(w)] = w
    spec = j_wav_to_mel(y)[:, :16]
    quant, vq = jm.apply(params, jnp.asarray(2 * spec - 1)[None, :, :, None], method=jm.encode)
    want_tokens = np.asarray(vq.indices)[0]
    want_rec = np.clip((np.asarray(jm.apply(params, quant, method=jm.decode))[0, :, :, 0] + 1) / 2,
                       0, 1)
    tokens = np.load(out / "tokens.npy")
    assert tokens.shape == (40, 8) and len(np.unique(tokens)) > 1
    np.testing.assert_array_equal(tokens, want_tokens)
    np.testing.assert_allclose(np.load(out / "reconstruction.npy"), want_rec, rtol=0, atol=1e-5)
    bitrate = 320 * math.log2(10) / (16 * 256 / 22050)
    assert f"codebook bitrate: {bitrate:.1f} bit/s (320 tokens x log2(10) / 0.19s)" in report
    assert report.startswith("token grid (5 x 53):\n")
    assert sorted(os.listdir(out)) == ["original.wav", "reconstruction.npy",
                                       "reconstruction.wav", "tokens.npy"]


def test_vis_codebook_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        vis_codebook.main(["--wav", "unused.wav", "--ckpt", "unused.ckpt"])
