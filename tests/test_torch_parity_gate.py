"""The port's one-command parity gate (``tools/run_parity_gate.py``) on the
CPU, on a proxy ``.pth`` in the reference's ``{'model', 'ema'}`` layout
written from the port's seeded ``TINY_MODEL_CFG`` composite (a distinct
EMA copy of the denoiser), with the synthetic merge table at
``$T2S_CLIP_BPE`` (``chip_smoke.write_merge_table``):

- smoke mode: the steps and their SKIP reasons in ``PARITY_GATE.md``, the
  reference's sources named; no FAIL; the samples written and bit for bit
  ``tools/generate.py``'s under the same seed;
- ``--real`` on a root that lacks artifacts fails and names them, as JAX's
  ``test_run_parity_gate_real_mode_discovery``;
- the load step's codec decodes codes to JAX's mel on the same file (JAX's
  ``convert_diffsound_checkpoint``) within 1e-5, f32 both sides, and the
  denoiser holds the file's EMA weights.
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import chip_smoke
from text_to_sound_synthesis_tpu.convert.torch_to_jax import convert_diffsound_checkpoint
from text_to_sound_synthesis_torch.models.diffsound import build_model
from text_to_sound_synthesis_torch.tools import generate, run_parity_gate as gate
from text_to_sound_synthesis_torch.utils.config import load_yaml_config

from tests.test_cli import _plain
from tests.test_composite import TINY_MODEL_CFG

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def proxy(tmp_path_factory):
    """(config path, proxy .pth path, the EMA weights in it)."""
    root = tmp_path_factory.mktemp("proxy")
    old = os.environ.get("T2S_CLIP_BPE")
    os.environ["T2S_CLIP_BPE"] = chip_smoke.write_merge_table(str(root / "merges.txt"))
    cfg = root / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({"model": _plain(TINY_MODEL_CFG)}))
    model = build_model(TINY_MODEL_CFG, device="cpu", seed=7)
    sd = model.state_dict()
    g = torch.Generator().manual_seed(8)
    ema = {k[len("transformer."):]: v + 0.01 * torch.randn(v.shape, generator=g)
           for k, v in sd.items()
           if k.startswith("transformer.transformer.") and v.is_floating_point()}
    path = root / "diffsound_proxy.pth"
    torch.save({"model": sd, "ema": ema, "epoch": 3}, path)
    yield str(cfg), str(path), ema
    if old is None:
        os.environ.pop("T2S_CLIP_BPE")
    else:
        os.environ["T2S_CLIP_BPE"] = old


def test_smoke_mode(proxy, tmp_path, monkeypatch):
    cfg, path, _ = proxy
    monkeypatch.setattr(gate, "REF", str(tmp_path / "no_reference"))
    out = tmp_path / "gate"
    rc = gate.main(["--config_file", cfg, "--ckpt", path, "--caption", "a dog barks",
                    "--caption", "rain falls", "--replicate", "2", "--batch", "2",
                    "--outdir", str(out), "--device", "cpu"])
    report = (out / "PARITY_GATE.md").read_text()
    assert rc == 0, report
    rows = {line.split(" | ")[0][2:]: line.split(" | ")[1] for line in report.splitlines()
            if line.startswith("| ") and not line.startswith("| step")}
    assert rows == {"load": "PASS", "roundtrip": "SKIP", "logit_parity": "SKIP",
                    "generate": "PASS", "metrics": "SKIP"}
    assert "EMA-preferred" in report
    assert report.count(f"$T2S_REFERENCE={tmp_path / 'no_reference'}") == 2
    assert "needs --gt_mels and --melception" in report and "FAIL" not in report.split("**")[0]
    assert "**Gate: PARTIAL** (2 pass / 3 skip / 0 fail)" in report
    samples = sorted(os.listdir(out / "samples"))
    assert samples == [f"caption{i}_sample_{j}.npy" for i in range(2) for j in range(2)]

    direct = tmp_path / "direct"
    assert generate.main(["--config_file", cfg, "--ckpt", path, "--caption", "a dog barks",
                          "--caption", "rain falls", "--replicate", "2", "--batch", "2",
                          "--outdir", str(direct), "--device", "cpu"]) == 0
    for name in samples:
        assert np.array_equal(np.load(out / "samples" / name), np.load(direct / name)), name


def test_real_mode_fails_on_missing_artifacts(proxy, tmp_path):
    import shutil

    cfg, path, _ = proxy
    root = tmp_path / "artifacts"
    (root / "gt_mels").mkdir(parents=True)
    np.save(root / "gt_mels" / "clip0_mel.npy", np.zeros((80, 64), np.float32))
    shutil.copy(path, root / "diffsound_audiocaps_proxy.pth")
    (root / "audiocaps_val.csv").write_text("clip0,a dog barks\n")
    out = tmp_path / "gate_real"
    rc = gate.main(["--real", str(root), "--config_file", cfg, "--outdir", str(out),
                    "--device", "cpu"])
    assert rc == 1
    report = (out / "PARITY_GATE.md").read_text()
    assert "melception MISSING" in report and "vocoder MISSING" in report
    assert "diffsound_ckpt" in report and "diffsound_audiocaps_proxy.pth" in report
    assert "| load |" not in report          # the gate stops before it


def test_load_step_matches_jax_converter(proxy):
    """The port's load step and JAX's ``convert_diffsound_checkpoint`` on the
    same file: the codec decodes the same codes to the same mel, and the
    denoiser's weights are the file's EMA copy."""
    from text_to_sound_synthesis_tpu.models.diffsound import build_model as jax_build

    cfg, path, ema = proxy
    model, has_ema = gate.load_released(load_yaml_config(cfg), path, torch.device("cpu"))
    assert has_ema
    for k, v in ema.items():
        assert torch.equal(model.state_dict()[f"transformer.{k}"], v), k
    jm = jax_build(TINY_MODEL_CFG)
    template = jm.init_params(jax.random.PRNGKey(0), mel_shape=(1, 4, 16, 1))
    jp = convert_diffsound_checkpoint(path, jm, template)
    codes = np.random.default_rng(3).integers(0, 10, (2, 2, 8))
    want = np.asarray(jm.codec.apply(jp["codec"], jnp.asarray(codes, jnp.int32),
                                     method=jm.codec.decode_code))
    got = model.codec.decode_code(torch.from_numpy(codes)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gate_refuses_a_missing_card(proxy):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cfg, path, _ = proxy
    with pytest.raises(RuntimeError):
        gate.main(["--config_file", cfg, "--ckpt", path, "--outdir", "unused"])
