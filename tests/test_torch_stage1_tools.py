"""The port's Stage-1 and vocoder tools on the CPU: the trainers, their
checkpoints read back by the port's loaders, resume, feature extraction, the
bench's refusal without a card, and the Stage-1 step data parallel over a
two-process gloo group (``tests/_torch_mp_worker.py``, fresh interpreters,
no JAX).

The data-parallel step against one process on the whole batch (f32, the
sums in another order): the metrics within rtol 1e-5 (the perplexity of
the summed code counts equal); every weight within 2 lr a step, and within
1e-5 but for the values whose gradient in the one-process step lies below
1e-6 of its network's largest (zero in exact arithmetic: Adam steps each
side's rounding there) and at most 2 others a tensor (a gradient crossing
zero); the BatchNorm running statistics within 1e-5, where the statistics
of one rank's half alone lie more than 1e-3 off.
"""

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tests._torch_tiny import (S1_B, S1_DD, TRAIN_CFG, mark_zero_grads, stage1_batches,
                               stage1_state)
from tests._torch_mp_worker import S1_LOSS
from text_to_sound_synthesis_torch.engine.vqgan_solver import (VQGANLossConfig,
                                                               make_vqgan_train_step)
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator, load_vocoder
from text_to_sound_synthesis_torch.models.vqgan import VQModel
from text_to_sound_synthesis_torch.tools import prepare_data, train_vocoder, train_vqgan
from text_to_sound_synthesis_torch.utils.io import read_wav, write_wav

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wav(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 4000) * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


# -- train_vqgan ------------------------------------------------------------------------------

def _vqgan_config(tmp_path):
    """A config of the tiny codec over 12 mels of 16 x 40 in ``tmp_path`` (10
    for training, 2 for validation)."""
    spec_dir = tmp_path / "features" / "melspec"
    spec_dir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(12):
        np.save(spec_dir / f"clip{i}_mel.npy", rng.uniform(0, 1, (16, 40)).astype(np.float32))
    ds = {"target": "text_to_sound_synthesis_tpu.data.SpecsDataset",
          "params": {"spec_dir_path": str(spec_dir), "mel_num": 16, "spec_len": 40,
                     "spec_crop_len": 32, "random_crop": False}}
    cfg = {"model": {"base_learning_rate": 1e-5,
                     "target": "text_to_sound_synthesis_tpu.models.vqgan.VQModel",
                     "params": {"embed_dim": 16, "n_embed": 8, "ddconfig": dict(S1_DD, ch=16),
                                "lossconfig": {"params": {"disc_in_channels": 1,
                                                          "disc_start": 2, "disc_ndf": 8,
                                                          "disc_num_layers": 2}}}},
           "dataloader": {"batch_size": 2,
                          "train_datasets": [{**ds, "params": {**ds["params"], "split": "train"}}],
                          "validation_datasets": [{**ds, "params": {**ds["params"],
                                                                    "split": "valid"}}]}}
    path = tmp_path / "vqgan.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg


def _run_vqgan(path, out, *extra):
    return train_vqgan.main(["-b", path, "--output", str(out), "--name", "run", "--device", "cpu",
                             "--log_every", "2", *extra])


def test_train_vqgan_checkpoint_loads_into_the_codec_loader(tmp_path):
    """Five steps (one epoch of 10 mels at batch 2, the discriminator on from
    step 3) write ``auto_b.ckpt`` and ``last.ckpt``; a Diffsound whose codec
    config names the last loads it with ``build_model(load_codec=True)``:
    every codec tensor and ``decode_code`` bit for bit the trained codec's."""
    path, cfg = _vqgan_config(tmp_path)
    assert _run_vqgan(path, tmp_path / "out", "--max_steps", "5") == 0
    ckpt_dir = tmp_path / "out" / "run" / "checkpoint"
    assert sorted(os.listdir(ckpt_dir)) == ["auto_b.ckpt", "last.ckpt"]
    payload = torch.load(ckpt_dir / "last.ckpt", weights_only=False)
    assert payload["global_step"] == 5 and payload["epoch"] == 1
    assert len(payload["optimizer_states"]) == 2
    sd = payload["state_dict"]
    assert any(k.startswith("loss.discriminator.main.") for k in sd)
    log = (tmp_path / "out" / "run" / "log.txt").read_text()
    assert "lr = 1 x 2 x 1e-05" in log and "codebook usage" in log and "it4 total" in log

    mp = cfg["model"]["params"]
    dcfg = {**TRAIN_CFG, "params": {**TRAIN_CFG["params"], "content_codec_config": {
        "target": cfg["model"]["target"],
        "params": {"embed_dim": mp["embed_dim"], "n_embed": mp["n_embed"],
                   "ddconfig": mp["ddconfig"], "ckpt_path": str(ckpt_dir / "last.ckpt")}}}}
    model = build_model(dcfg, device="cpu", seed=5)
    got = model.codec.state_dict()
    assert sorted(got) == sorted(k for k in sd if not k.startswith("loss."))
    assert all(torch.equal(got[k], sd[k]) for k in got)
    codec = VQModel(mp["ddconfig"], n_embed=mp["n_embed"], embed_dim=mp["embed_dim"])
    codec.load_state_dict({k: v for k, v in sd.items() if not k.startswith("loss.")})
    code = torch.from_numpy(np.random.default_rng(4).integers(0, 8, (2, 8, 16)))
    with torch.no_grad():
        assert torch.equal(model.codec.decode_code(code), codec.decode_code(code))


def test_train_vqgan_auto_resume_is_bit_for_bit(tmp_path):
    """Two epochs in one run against one epoch, then ``--auto_resume`` for
    the second: the same weights, Adam moments, running statistics and step."""
    path, _ = _vqgan_config(tmp_path)
    assert _run_vqgan(path, tmp_path / "a", "--max_steps", "10") == 0
    assert _run_vqgan(path, tmp_path / "b", "--max_steps", "5") == 0
    assert _run_vqgan(path, tmp_path / "b", "--max_steps", "10", "--auto_resume") == 0
    a, b = (torch.load(tmp_path / r / "run" / "checkpoint" / "last.ckpt", weights_only=False)
            for r in ("a", "b"))
    assert a["global_step"] == b["global_step"] == 10 and a["epoch"] == b["epoch"] == 2
    assert sorted(a["state_dict"]) == sorted(b["state_dict"])
    assert all(torch.equal(a["state_dict"][k], b["state_dict"][k]) for k in a["state_dict"])
    for oa, ob in zip(a["optimizer_states"], b["optimizer_states"]):
        for i, sa in oa["state"].items():
            assert all(torch.equal(sa[k], ob["state"][i][k]) for k in sa)
    assert "resumed" in (tmp_path / "b" / "run" / "log.txt").read_text()


def test_trainers_refuse_a_missing_card(tmp_path):
    path, _ = _vqgan_config(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_vqgan.main(["-b", path, "--output", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_vocoder.main(["--save_path", str(tmp_path / "v"), "--data_path", str(tmp_path)])


# -- train_vocoder -------------------------------------------------------------------------------

def test_train_vocoder_writes_what_load_vocoder_reads(tmp_path):
    """A tiny run writes ``args.yml`` + ``best_netG.pt`` (and the reference's
    net / opt files); ``load_vocoder`` reads them back: the generator's
    tensors and its wav bit for bit those of the trained generator."""
    data = tmp_path / "data"
    for i in range(3):
        write_wav(str(data / f"w{i}.wav"), 22050, _wav(6000, i), "PCM_16")
    (data / "train_files.txt").write_text("".join(f"w{i}.wav\n" for i in range(3)))
    args = ["--save_path", str(tmp_path / "out"), "--data_path", str(data), "--ngf", "4",
            "--n_residual_layers", "1", "--ndf", "4", "--n_layers_D", "2", "--num_D", "2",
            "--batch_size", "2", "--seq_len", "4096", "--epochs", "2", "--log_interval", "1",
            "--save_interval", "1", "--device", "cpu"]
    assert train_vocoder.main(args) == 0
    run = tmp_path / "out" / "melgan"
    assert {"args.yml", "best_netG.pt", "netG.pt", "netD.pt", "optG.pt", "optD.pt"} <= set(
        os.listdir(run))
    voc = load_vocoder(str(run), device="cpu")
    gen = MelGANGenerator(80, 4, 1)
    gen.load_state_dict(torch.load(run / "best_netG.pt"))
    assert all(torch.equal(a, b) for a, b in zip(voc.gen.state_dict().values(),
                                                 gen.state_dict().values()))
    mel = torch.rand(2, 80, 10)
    with torch.no_grad():
        assert torch.equal(voc(mel), gen(mel)[:, 0])
    assert "mel_reconstruction" in (run / "log.txt").read_text()


def test_wav_crop_dataset_draws_seeded_crops(tmp_path):
    write_wav(str(tmp_path / "a.wav"), 22050, _wav(5000, 1), "PCM_16")
    write_wav(str(tmp_path / "b.wav"), 22050, _wav(300, 2), "PCM_16")   # shorter than a crop
    (tmp_path / "list.txt").write_text("a.wav\nb.wav\n")
    ds = train_vocoder.WavCropDataset(str(tmp_path / "list.txt"), 1000)
    x = ds.sample_batch(np.random.default_rng(0), 6)
    y = ds.sample_batch(np.random.default_rng(0), 6)
    assert x.shape == (6, 1000) and np.array_equal(x, y) and len(ds) == 2
    assert any(np.all(row[300:] == 0) for row in x)          # b's crop, zero-padded


# -- prepare_data -------------------------------------------------------------------------------

def test_prepare_data_matches_the_jax_tool(tmp_path):
    """The port's ``<name>_mel.npy`` is bit for bit the JAX tool's (the same
    host numpy chain), at a length that pads and one that cuts."""
    import importlib.util

    src = tmp_path / "wavs" / "sub"
    write_wav(str(src / "clip.wav"), 22050, _wav(30000, 5), "PCM_16")
    spec = importlib.util.spec_from_file_location("jax_prepare_data",
                                                  os.path.join(REPO, "tools", "prepare_data.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    for length in (22050, 44100):
        out = tmp_path / f"out{length}"
        assert prepare_data.main(["-i", str(tmp_path / "wavs"), "-o", str(out), "-l", str(length),
                                  "-n", "1"]) == 0
        got = np.load(out / "clip_mel.npy")
        want_path = jtool.process_one(str(src / "clip.wav"), str(tmp_path), length)
        np.testing.assert_array_equal(got, np.load(want_path))
        assert got.shape == (80, length // 256 + 1) and got.min() >= 0 and got.max() <= 1
    y, sr = read_wav(str(src / "clip.wav"))
    assert sr == 22050 and len(y) == 30000


def test_bench_train_stage1_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = subprocess.run([sys.executable, "-m",
                        "text_to_sound_synthesis_torch.tools.bench_train_stage1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "needs a CUDA card" in r.stderr and r.stdout == ""


def test_bench_bf16_request_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    r = subprocess.run([sys.executable, "-m",
                        "text_to_sound_synthesis_torch.tools.bench_bf16_request"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "needs a CUDA card" in r.stderr and r.stdout == ""


# -- the step, data parallel -----------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_process(mels, rows=slice(None)):
    """The two steps in one process on ``rows`` of each global batch, with
    the values whose gradient is zero in exact arithmetic after each step."""
    state = stage1_state()
    step = make_vqgan_train_step(None, VQGANLossConfig(**S1_LOSS))
    out, noisy = [], {}
    for mel in mels:
        state, m = step(state, mel[rows], 1e-4)
        mark_zero_grads({"codec": state.codec, "disc": state.disc}, noisy)
        out.append({"codec": {k: v.clone() for k, v in state.codec.state_dict().items()},
                    "disc": {k: v.clone() for k, v in state.disc.state_dict().items()},
                    "metrics": m, "noisy": dict(noisy)})
    return out


def test_stage1_step_data_parallel_over_two_processes(tmp_path):
    port, out = _free_port(), str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_mp_worker.py"),
                               str(port), str(r), "2", out, "stage1"], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    reps = [torch.load(f"{out}.{r}.pt", weights_only=False) for r in range(2)]
    mels = stage1_batches()
    want = _one_process(mels)
    half = _one_process(mels, slice(0, S1_B // 2))
    for i, (got, w, h) in enumerate(zip(reps[0], want, half)):
        for k, v in w["metrics"].items():
            if k != "indices":
                torch.testing.assert_close(got["metrics"][k], v.float(), rtol=1e-5, atol=1e-7,
                                           msg=f"step {i + 1} {k}")
        for net in ("codec", "disc"):
            for k, v in w[net].items():
                d = (got[net][k].float() - v.float()).abs()
                if "running" in k:
                    assert float(d.max()) <= 1e-5, (i, k, float(d.max()))
                    # one rank's half alone: its own statistics lie far off
                    assert float((h[net][k] - v).abs().max()) > 1e-3, (i, k)
                elif d.dtype.is_floating_point and "num_batches" not in k:
                    assert float(d.max()) <= 2e-4 * (i + 1) + 1e-6, (i, k, float(d.max()))
                    beyond = int((d[~w["noisy"][f"{net}.{k}"]] > 1e-5).sum())
                    assert beyond <= 2, (i, k, beyond)
        # both ranks hold the same weights and statistics
        for net in ("codec", "disc"):
            assert all(torch.equal(reps[1][i][net][k], t) for k, t in got[net].items())
    assert int(reps[0][-1]["disc"]["main.3.num_batches_tracked"]) == 4
    digest = hashlib.sha256(reps[0][-1]["disc"]["main.3.running_var"].numpy().tobytes())
    assert digest.hexdigest() == hashlib.sha256(
        reps[1][-1]["disc"]["main.3.running_var"].numpy().tobytes()).hexdigest()
