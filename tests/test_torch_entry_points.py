"""The port's user-facing entry points against the JAX package, on the CPU:
captions to the condition, the generate CLI and its checkpoint loader,
``extract_text_features``, ``check_artifacts`` and the ``Solver``'s
vocoded samples.

Captions are tokenized on ``chip_smoke.py``'s synthetic merge table (the
released one is not in the repository); the composite is the tiny one of
``tests/test_composite.py`` (a 49 408-row CLIP, so the ids fit).
"""

import argparse
import os
import sys
import wave

import jax
import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from text_to_sound_synthesis_torch.convert import from_jax  # noqa: E402
from text_to_sound_synthesis_torch.engine import checkpoint as ck  # noqa: E402
from text_to_sound_synthesis_torch.engine.optimizers import build_optimizer  # noqa: E402
from text_to_sound_synthesis_torch.engine.solver import Solver  # noqa: E402
from text_to_sound_synthesis_torch.engine.train_state import DiffusionTrainState  # noqa: E402
from text_to_sound_synthesis_torch.models import build_model  # noqa: E402
from text_to_sound_synthesis_torch.models.clip import CLIPTextEmbedding  # noqa: E402
from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator  # noqa: E402
from text_to_sound_synthesis_torch.models.melgan.interface import load_vocoder  # noqa: E402
from text_to_sound_synthesis_torch.tools import check_artifacts as port_check  # noqa: E402
from text_to_sound_synthesis_torch.tools import extract_text_features as port_extract  # noqa: E402
from text_to_sound_synthesis_torch.tools import generate as port_generate  # noqa: E402
from text_to_sound_synthesis_torch.utils.init import init_random_  # noqa: E402

from tests._torch_tiny import OPT_CFG, T, TRAIN_CFG  # noqa: E402
from tests.test_cli import _plain  # noqa: E402
from tests.test_composite import TINY_MODEL_CFG  # noqa: E402
from tests.test_torch_modules import ATOL  # noqa: E402
from tests.test_torch_train_ckpt import SOLVER_CFG, loaders  # noqa: E402

torch.set_num_threads(1)

CAPTIONS = ["the dog barks in the rain", "a café with naïve jazz", "straße",
            "tom&#39;s  dog &amp; cat barks twice"]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    """$T2S_CLIP_BPE set to the synthetic table for the module."""
    path = chip_smoke.write_merge_table(str(tmp_path_factory.mktemp("bpe") / "merges.txt"))
    old = os.environ.get("T2S_CLIP_BPE")
    os.environ["T2S_CLIP_BPE"] = path
    yield path
    if old is None:
        os.environ.pop("T2S_CLIP_BPE")
    else:
        os.environ["T2S_CLIP_BPE"] = old


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cfg") / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"model": _plain(TINY_MODEL_CFG)}, f)
    return path


def _melgan_dir(root, n_mels=4):
    """A MelGAN directory (args.yml + best_netG.pt) of torch's default init."""
    root.mkdir(exist_ok=True)
    (root / "args.yml").write_text(f"n_mel_channels: {n_mels}\nngf: 4\nn_residual_layers: 1\n")
    torch.manual_seed(5)
    torch.save(MelGANGenerator(input_size=n_mels, ngf=4, n_residual_layers=1).state_dict(),
               root / "best_netG.pt")
    return str(root)


# -- captions to the condition -------------------------------------------------------------

def test_condition_from_captions(bpe):
    """JAX's ``text_to_tokens`` + ``embed_condition`` and the port's, the
    weights carried by ``convert/from_jax.py``: equal ids, features within
    the CLIP ATOL."""
    import jax.numpy as jnp

    from text_to_sound_synthesis_tpu.models.diffsound import build_model as jax_build

    jmodel = jax_build(TINY_MODEL_CFG)
    cond = jax.jit(jmodel.cond.init)(jax.random.PRNGKey(0), jnp.zeros((1, 12), jnp.int32))
    params = {"cond": jax.tree_util.tree_map(np.asarray, cond)}
    model = build_model(TINY_MODEL_CFG, device="cpu")
    from_jax.load_clip_text(model.cond, params["cond"])
    want_ids = jmodel.text_to_tokens(CAPTIONS)
    got_ids = model.text_to_tokens(CAPTIONS)
    np.testing.assert_array_equal(got_ids["token"], want_ids["token"])
    np.testing.assert_array_equal(got_ids["mask"], want_ids["mask"])
    assert got_ids["token"].shape == (len(CAPTIONS), 12) and got_ids["token"].max() == 531
    want = np.asarray(jmodel.embed_condition(params, want_ids["token"]))
    got = model.embed_condition(torch.from_numpy(got_ids["token"])).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# -- the generate CLI ----------------------------------------------------------------------

def test_generate_cli_files_and_mels(bpe, tiny_cfg, tmp_path):
    """File names (a counter a name), shapes, finite values, one MelGAN wav a
    sample; the mels are ``Diffsound.generate``'s under the same generator,
    batch after batch."""
    csv_path = tmp_path / "caps.csv"
    csv_path.write_text("clipA,the dog barks\nclipB,rain falls\nclipC,a café\n")
    out = tmp_path / "out"
    voc = _melgan_dir(tmp_path / "voc")
    assert port_generate.main(["--config_file", tiny_cfg, "--ckpt", "random", "--csv",
                               str(csv_path), "--outdir", str(out), "--replicate", "2",
                               "--batch", "2", "--vocoder", voc, "--seed", "3",
                               "--device", "cpu"]) == 0
    names = [f"clip{c}_sample_{i}" for c in "ABC" for i in range(2)]
    assert sorted(os.listdir(out)) == sorted(n + e for n in names for e in (".npy", ".wav"))

    model = port_generate.load_model(yaml.safe_load(open(tiny_cfg)), "random", 3, "cpu")
    vocoder = load_vocoder(voc, device="cpu")
    g = torch.Generator().manual_seed(3)
    for caps, batch_names in ((["the dog barks"] * 2 + ["rain falls"] * 2, names[:4]),
                              (["a café"] * 2, names[4:])):
        toks = torch.from_numpy(model.text_to_tokens(caps)["token"])
        want = port_generate.to_spec(model.generate(g, toks)).numpy()
        for i, name in enumerate(batch_names):
            spec = np.load(out / f"{name}.npy")
            assert spec.shape == (4, 16) and spec.dtype == np.float32
            assert np.isfinite(spec).all()
            np.testing.assert_array_equal(spec, want[i])
            with wave.open(str(out / f"{name}.wav")) as w:
                assert (w.getframerate(), w.getsampwidth(), w.getnframes()) == (22050, 3, 16 * 256)
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.uint8).reshape(-1, 3)
            wav = vocoder(torch.from_numpy(spec[None]))[0].numpy()
            ints = np.round(np.clip(wav.astype(np.float64), -1, 1) * 8388607).astype("<i4")
            np.testing.assert_array_equal(pcm, ints.reshape(-1, 1).view(np.uint8)[:, :3])


def test_generate_cli_long_form(bpe, tiny_cfg, tmp_path):
    """``--duration_frames 40 --overlap_frames 4``: one (4, 40) mel and a wav
    of 40 x 256 frames beyond the 16-frame window; the same through the
    int8 engine (``--int8``); each equal to ``generate_long`` on the same
    generator."""
    voc = _melgan_dir(tmp_path / "voc")
    model = port_generate.load_model(yaml.safe_load(open(tiny_cfg)), "random", 0, "cpu")
    toks = torch.from_numpy(model.text_to_tokens(["rolling thunder"])["token"])
    for extra, qp in (([], None), (["--int8"], model.quantize_for_serving(weight_bits=4))):
        out = tmp_path / f"long{len(extra)}"
        assert port_generate.main(["--config_file", tiny_cfg, "--ckpt", "random", "--caption",
                                   "rolling thunder", "--outdir", str(out), "--replicate", "1",
                                   "--batch", "1", "--vocoder", voc, "--duration_frames", "40",
                                   "--overlap_frames", "4", "--device", "cpu", *extra]) == 0
        spec = np.load(out / "caption0_sample_0.npy")
        assert spec.shape == (4, 40) and np.isfinite(spec).all()
        with wave.open(str(out / "caption0_sample_0.wav")) as w:
            assert w.getframerate() == 22050 and w.getnframes() == 40 * 256
        want = model.generate_long(torch.Generator().manual_seed(0), toks, duration_frames=40,
                                   overlap_frames=4, qp=qp)
        np.testing.assert_array_equal(spec, port_generate.to_spec(want).numpy()[0])


def test_generate_cli_int8_duration_seconds(bpe, tiny_cfg, tmp_path):
    """``--int8 --weight_bits 8 --duration`` in seconds: round(d * 22050 /
    256) frames of ``generate_long`` on the W8 engine."""
    out = tmp_path / "out"
    assert port_generate.main(["--config_file", tiny_cfg, "--ckpt", "random", "--caption", "wind",
                               "--outdir", str(out), "--replicate", "1", "--batch", "1",
                               "--int8", "--weight_bits", "8", "--duration", "0.3",
                               "--overlap_frames", "4", "--device", "cpu"]) == 0
    assert np.load(out / "caption0_sample_0.npy").shape == (4, round(0.3 * 22050 / 256))


def _fresh_state(seed):
    model = build_model(TRAIN_CFG, device="cpu", seed=seed)
    den = model.diffusion.transformer
    return model, DiffusionTrainState.create(den, build_optimizer(OPT_CFG, den, 1e-3), T)


def test_load_model_checkpoints(tmp_path):
    """``load_model`` reads a ``Solver`` checkpoint and a reference-layout
    ``.pth`` with its ``ema``, the EMA weights preferred; an orbax-looking
    directory is refused with the formats the port reads."""
    model, state = _fresh_state(0)
    with torch.no_grad():
        for e in state.ema_params:
            e.add_(1.0)
    solver_ckpt = ck.save_checkpoint(str(tmp_path / "solver.pth"),
                                     ck.train_payload(model, state, last_epoch=0))
    ema = {f"transformer.{n}": e.clone() for (n, _), e in zip(state.named_params(),
                                                                state.ema_params)}
    ref = tmp_path / "diffsound.pth"
    torch.save({"model": model.state_dict(), "ema": ema, "last_epoch": 3}, ref)
    for path in (solver_ckpt, str(ref)):
        got = port_generate.load_model(TRAIN_CFG, path, seed=7, device="cpu")
        for (n, p), e in zip(got.diffusion.transformer.named_parameters(), state.ema_params):
            assert torch.equal(p, e), n
        want = model.state_dict()
        for k, v in got.state_dict().items():
            if not k.startswith("transformer.transformer."):
                assert torch.equal(v, want[k]), k
    orbax = tmp_path / "converted" / "diffsound"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match=r"\.pth / \.ckpt / \.pt.*orbax"):
        port_generate.load_model(TRAIN_CFG, str(orbax), seed=0, device="cpu")


# -- extract_text_features -----------------------------------------------------------------

def test_extract_clip_equals_jax(bpe, tmp_path):
    """The port's seeded CLIP text weights as a state dict: JAX's
    ``extract_clip`` (the full 12-layer tower) and the port's tool on two
    captions, vectors within the CLIP ATOL."""
    import extract_text_features as jax_extract   # tools/extract_text_features.py

    with torch.device("meta"):
        emb = CLIPTextEmbedding(normalize=True, pick_last_embedding=True, embed_dim=512)
    emb = init_random_(emb.to_empty(device="cpu"), torch.Generator().manual_seed(11))
    ckpt = tmp_path / "clip.pt"
    torch.save(emb.state_dict(), ckpt)
    rows = [("clip_a", "the dog barks in the rain"), ("clip_b", "a café with naïve jazz")]
    caps = tmp_path / "caps.csv"
    caps.write_text("".join(f"{n},{c}\n" for n, c in rows))
    want = jax_extract.extract_clip(rows, argparse.Namespace(clip_ckpt=str(ckpt), batch=32))
    out = tmp_path / "feats"
    assert port_extract.main(["--captions", str(caps), "--outdir", str(out), "--clip_ckpt",
                              str(ckpt), "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["clip_a.txt", "clip_b.txt"]
    got = np.stack([np.loadtxt(out / f"{n}.txt") for n, _ in rows])
    assert got.shape == (2, 512)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_clip_state_dict_reads_torchscript(tmp_path):
    """A TorchScript archive (the released CLIP's form) gives the state dict
    of the module it holds; a pickled state dict is read as it is."""
    emb = CLIPTextEmbedding(normalize=True, pick_last_embedding=True, embed_dim=8, width=8,
                            layers=1, heads=2, context_length=12)
    init_random_(emb, torch.Generator().manual_seed(1))
    torch.jit.save(torch.jit.trace(emb.eval(), torch.zeros((1, 12), dtype=torch.long)),
                   str(tmp_path / "clip_ts.pt"))
    torch.save(emb.state_dict(), tmp_path / "clip_sd.pt")
    for name in ("clip_ts.pt", "clip_sd.pt"):
        got = port_extract.clip_state_dict(str(tmp_path / name))
        assert got.keys() == emb.state_dict().keys()
        assert all(torch.equal(got[k], v) for k, v in emb.state_dict().items())


def test_extract_bert_needs_transformers(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)      # import fails
    with pytest.raises(RuntimeError, match="needs the transformers package"):
        port_extract.extract_bert([("a", "b")], argparse.Namespace(bert_path="x", batch=1))


@pytest.mark.parametrize("tool", ["generate", "extract_text_features"])
def test_tools_refuse_a_missing_card(tool, tmp_path, monkeypatch):
    """On the card by default: without one the tool raises before any work."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"text_to_sound_synthesis_torch.tools.{tool}")
    caps = tmp_path / "caps.csv"
    caps.write_text("a,a dog\n")
    argv = (["--config_file", "none.yaml", "--ckpt", "random"] if tool == "generate"
            else ["--captions", str(caps), "--outdir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main(argv)


# -- check_artifacts -----------------------------------------------------------------------

def test_check_artifacts_equals_jax(tmp_path, capsys):
    """JAX's and the port's ``main`` on one root, empty, then with a file of
    a wrong MD5, an unpinned file and a directory: the same lines and exit
    codes, with and without ``--need``."""
    import check_artifacts as jax_check   # tools/check_artifacts.py

    root = tmp_path / "artifacts"
    root.mkdir()
    argvs = [[str(root)], [str(root), "--need", "lpaps"], [str(tmp_path / "nowhere")]]

    def both(argv):
        got = port_check.main(argv), capsys.readouterr()
        want = jax_check.main(argv), capsys.readouterr()
        assert got == want, argv
        return got[0], got[1].out

    for argv in argvs:
        assert both(argv)[0] == 1
    (root / "lpaps.pt").write_bytes(b"not the release")              # pinned: a bad MD5
    (root / "diffsound_audiocaps.pth").write_bytes(b"a checkpoint")  # no published pin
    (root / "gt_mels").mkdir()
    voc = root / "bundle" / "melgan_logs"
    voc.mkdir(parents=True)
    (voc / "best_netG.pt").write_bytes(b"g")
    (voc / "args.yml").write_text("ngf: 32\n")
    for argv in argvs + [[str(root), "--need", "diffsound_ckpt", "gt_mels", "vocoder"],
                         [str(root), "--need", "lpaps", "diffsound_ckpt"]]:
        both(argv)
    code, out = both([str(root), "--need", "diffsound_ckpt", "gt_mels", "vocoder"])
    assert code == 0 and out.count("UNPINNED") == 3 and "melgan_logs" in out
    code, out = both([str(root), "--need", "lpaps", "diffsound_ckpt"])
    assert code == 1 and "BAD MD5" in out
    argv = [str(root), "--need", "nonsense"]
    with pytest.raises(SystemExit) as e_port:
        port_check.main(argv)
    port_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as e_jax:
        jax_check.main(argv)
    assert (e_port.value.code, port_err) == (e_jax.value.code, capsys.readouterr().err)
    assert e_port.value.code == 2 and "unknown artifact names ['nonsense']" in port_err


# -- the Solver's vocoded samples ----------------------------------------------------------

class _Log:
    """The ``Logger`` surface ``Solver`` reads here (the real one imports
    TensorBoard, seconds of import)."""

    is_primary = True

    def __init__(self, root, name):
        self.run_dir = os.path.join(root, name)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoint")
        self.lines = []

    def log_info(self, msg, check_primary=True):
        self.lines.append(msg)


def _solver(tmp_path, name, vocoder_path):
    import copy

    cfg = copy.deepcopy(SOLVER_CFG)
    cfg["solver"]["vocoder_path"] = vocoder_path
    solver = Solver(cfg, build_model(TRAIN_CFG, device="cpu", seed=0), loaders(),
                    _Log(str(tmp_path), name), seed=0)
    solver._sample_batch = {"condition_token": torch.randint(0, 64, (2, 12),
                                                             generator=torch.Generator()
                                                             .manual_seed(0))}
    return solver


def test_solver_samples_are_vocoded(tmp_path):
    """With ``vocoder_path`` a MelGAN directory, each sample's ``.wav`` is
    ``load_vocoder(dir)`` of its ``.npy``; with a bad path the attach is
    logged and the samples stay spectrograms."""
    voc = _melgan_dir(tmp_path / "voc")
    solver = _solver(tmp_path, "voiced", voc)
    solver.sample()
    d = os.path.join(solver.logger.run_dir, "samples")
    assert {f for f in os.listdir(d) if not f.endswith(".png")} == {
        f"it0_{b}.{e}" for b in range(2) for e in ("npy", "wav")}
    vocoder = load_vocoder(voc, device="cpu")
    for b in range(2):
        spec = np.load(os.path.join(d, f"it0_{b}.npy"))
        with wave.open(os.path.join(d, f"it0_{b}.wav")) as w:
            assert w.getframerate() == 22050 and w.getsampwidth() == 3
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.uint8).reshape(-1, 3)
        wav = vocoder(torch.from_numpy(spec[None]))[0].numpy()
        ints = np.round(np.clip(wav.astype(np.float64), -1, 1) * 8388607).astype("<i4")
        np.testing.assert_array_equal(pcm, ints.reshape(-1, 1).view(np.uint8)[:, :3])

    solver = _solver(tmp_path, "silent", str(tmp_path / "no_vocoder"))
    assert solver.logger.lines[0].startswith("vocoder attach failed (FileNotFoundError(")
    assert solver.logger.lines[0].endswith("); samples stay spec-only")
    assert solver.vocoder is None
    solver.sample()
    files = os.listdir(os.path.join(solver.logger.run_dir, "samples"))
    assert sorted(f for f in files if not f.endswith(".png")) == ["it0_0.npy", "it0_1.npy"]
