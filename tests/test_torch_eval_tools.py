"""The port's evaluation tools on the CPU, and ``extract_features`` over a
2-process gloo group (fresh interpreters running the port alone, no JAX).

* ``tools/evaluate.py``: the JAX tool's ``key=value`` CLI, seeded by
  ``config=configs/eval_melception_audiocaps.yaml`` and overridden by the
  command line; its numbers are ``evaluate_folders``'s.
* ``extract_features(multihost=True)`` over two ranks with an odd file
  count: rank p takes files p, p + 2, ...; the gathered set is the JAX
  package's ``process_allgather`` order (rank 0's rows, then rank 1's) with
  the padding dropped, and its rows are one process's rows for those files
  (within 1e-6: the ranks' batches hold other files).
* ``tools/eval_int8_drift.py`` on a small composite whose 24 x 32 mel
  Melception can take (two clips a set): the JAX tool's keys, a finite
  ratio, the sets drawn with TF32 off; ``sample_set`` gives the same mels
  twice at one seed.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import threadpoolctl
import torch
import yaml

from text_to_sound_synthesis_torch.evaluation import features as F
from text_to_sound_synthesis_torch.models.melception import Melception
from text_to_sound_synthesis_torch.utils.init import init_random_

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = (24, 32)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """scipy's ``sqrtm`` of a 2048-d FID gains little from BLAS threads and
    starves the suite's other workers of cores: one thread here."""
    with threadpoolctl.threadpool_limits(1):
        yield


def _melception(num_classes=4):
    return init_random_(Melception(num_classes=num_classes), torch.Generator().manual_seed(0))


def _write_mels(root, names, seed):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for n in names:
        np.save(root / f"{n}.npy", rng.random(SMALL).astype(np.float32))
    return str(root)


# ---------------------------------------------------------------------------
# tools/evaluate.py
# ---------------------------------------------------------------------------

def test_evaluate_cli_config_seeding_and_overrides(tmp_path, capsys):
    from text_to_sound_synthesis_torch.tools import evaluate

    cfg = evaluate.parse_cli(["config=" + os.path.join(REPO, "configs",
                                                       "eval_melception_audiocaps.yaml"),
                              "batch=3", "have_kid=false"])
    assert cfg["batch"] == 3 and cfg["have_kid"] is False and cfg["num_classes"] == 309
    assert cfg["dataset"] == "caps" and cfg["kid_subset_size"] == 1000 and cfg["device"] == "cuda"
    with pytest.raises(SystemExit, match="unknown key"):
        evaluate.parse_cli(["bogus=1"])
    with pytest.raises(SystemExit, match="key=value"):
        evaluate.parse_cli(["batch"])

    gen = _write_mels(tmp_path / "gen", [f"c{i}_sample_{s}" for i in range(3) for s in range(2)], 1)
    ref = _write_mels(tmp_path / "ref", [f"c{i}_mel" for i in range(3)], 2)
    stats = tmp_path / "stats.txt"
    np.savetxt(stats, np.stack([np.full(SMALL[0], 0.4), np.full(SMALL[0], 0.8)], 1))
    out = evaluate.main([f"input1.path={gen}", f"input2.path={ref}", "num_classes=5",
                         "have_fid=false", "batch=4", "kid_subset_size=3", f"stats={stats}",
                         "device=cpu"])
    assert sorted(out) == ["inception_score_mean", "inception_score_std",
                           "kernel_inception_distance_mean", "kernel_inception_distance_std",
                           "kullback_leibler_divergence"]
    printed = capsys.readouterr().out
    assert f"kullback_leibler_divergence: {out['kullback_leibler_divergence']:.6f}" in printed
    model = init_random_(Melception(num_classes=5), torch.Generator().manual_seed(0))
    want = F.evaluate_folders(model, gen, ref, batch_size=4, have_fid=False, kid_subset_size=3,
                              means=np.full(SMALL[0], 0.4, np.float32),
                              stds=np.full(SMALL[0], 0.8, np.float32))
    assert out == want


def test_evaluate_loads_a_released_melception(tmp_path):
    from text_to_sound_synthesis_torch.tools import evaluate

    src = init_random_(Melception(num_classes=5), torch.Generator().manual_seed(9))
    torch.save({"model": src.state_dict()}, tmp_path / "melception.pt")
    gen = _write_mels(tmp_path / "gen", ["a_sample_0", "a_sample_1", "b_sample_0"], 3)
    ref = _write_mels(tmp_path / "ref", ["a_mel", "b_mel"], 4)
    out = evaluate.main([f"input1.path={gen}", f"input2.path={ref}", "num_classes=5",
                         f"melception_ckpt={tmp_path / 'melception.pt'}", "have_fid=false",
                         "have_kid=false", "device=cpu"])
    want = F.evaluate_folders(src, gen, ref, have_fid=False, have_kid=False)
    assert out == want


# ---------------------------------------------------------------------------
# extract_features over a 2-process gloo group
# ---------------------------------------------------------------------------

def _rank_main(port, rank, world, folder, out):
    """One rank: join the group, extract the folder's features sharded."""
    import torch.distributed as dist

    from text_to_sound_synthesis_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("cpu", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    res = F.extract_features(_melception(), F.FakesFolder(folder), batch_size=2, multihost=True)
    torch.save(res, f"{out}.{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_multihost_gather_over_two_gloo_ranks(tmp_path):
    folder = _write_mels(tmp_path / "mels", [f"s{i}" for i in range(5)], 5)
    port, out = _free_port(), str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    code = ("from tests.test_torch_eval_tools import _rank_main; "
            f"_rank_main({port}, {{rank}}, 2, {folder!r}, {out!r})")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(rank=r)], cwd=REPO, env=env,
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
        assert "jax" not in log
    reps = [torch.load(f"{out}.{r}.pt", weights_only=False) for r in range(2)]
    whole = F.extract_features(_melception(), F.FakesFolder(folder), batch_size=5)
    order = [0, 2, 4, 1, 3]
    for rep in reps:                                   # every rank holds the whole set
        assert rep["file_path_"] == [whole["file_path_"][i] for i in order]
        for k in ("2048", "logits", "logits_unbiased"):
            assert rep[k].shape == whole[k].shape
            np.testing.assert_allclose(rep[k], whole[k][order], rtol=0, atol=1e-6, err_msg=k)


def test_multihost_refuses_more_ranks_than_files(tmp_path, monkeypatch):
    import text_to_sound_synthesis_torch.evaluation.features as feats

    monkeypatch.setattr(feats, "get_world_size", lambda: 4)
    folder = _write_mels(tmp_path / "mels", ["a", "b", "c"], 6)
    with pytest.raises(ValueError, match="3 files cannot be sharded over 4 ranks"):
        F.extract_features(_melception(), F.FakesFolder(folder), multihost=True)


# ---------------------------------------------------------------------------
# tools/eval_int8_drift.py
# ---------------------------------------------------------------------------

def drift_config():
    """A small composite: a 2-layer d64 denoiser over a 3 x 4 token grid, a
    codec of three downsamplings (mel 24 x 32), a 1-layer CLIP over the BPE
    vocabulary (49 408 ids, 77 positions) so the tool's seeded ids fit."""
    dd = dict(double_z=False, z_channels=16, resolution=32, in_channels=1, out_ch=1, ch=8,
              ch_mult=[1, 1, 1, 1], num_res_blocks=1, attn_resolutions=[], dropout=0.0)
    pkg = "text_to_sound_synthesis_tpu.models"
    return {"model": {"target": f"{pkg}.Diffsound", "params": {
        "content_codec_config": {"target": f"{pkg}.vqgan.VQModel",
                                 "params": {"embed_dim": 16, "n_embed": 10, "ddconfig": dd}},
        "first_stage_permuter_config": {"target": "text_to_sound_synthesis_tpu.ops.permuter.ColumnMajor",
                                        "params": {"H": 3, "W": 4}},
        "condition_codec_config": {"target": f"{pkg}.clip.Tokenize",
                                   "params": {"context_length": 77}},
        "diffusion_config": {"target": f"{pkg}.diffusion.DiscreteDiffusion", "params": {
            "diffusion_step": 4,
            "transformer_config": {"target": f"{pkg}.diffusion.Text2SpecTransformer", "params": dict(
                n_layer=2, n_embd=64, n_head=2, content_seq_len=12, condition_dim=8,
                content_spatial_size=[3, 4])},
            "condition_emb_config": {"target": f"{pkg}.clip.CLIPTextEmbedding", "params": dict(
                num_embed=49408, embed_dim=8, width=8, layers=1, heads=2, context_length=77)},
            "content_emb_config": {"target": f"{pkg}.diffusion.ContentEmbedding", "params": dict(
                num_embed=10, embed_dim=64, spatial_size=[3, 4])}}}}}}


@pytest.fixture(scope="module")
def drift_yaml(tmp_path_factory):
    path = tmp_path_factory.mktemp("drift") / "drift.yaml"
    path.write_text(yaml.safe_dump(drift_config()))
    return str(path)


def test_drift_tool_reports_the_jax_keys(drift_yaml, capsys, monkeypatch):
    """The JAX tool's keys, and the protocol in full f32 whatever TF32 flags
    the caller left set (restored after), so a seed reads the same alone and
    inside a larger program."""
    from text_to_sound_synthesis_torch.tools import eval_int8_drift

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen, sample_set = [], eval_int8_drift.sample_set
    monkeypatch.setattr(eval_int8_drift, "sample_set",
                        lambda *a, **k: seen.append(flags()) or sample_set(*a, **k))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    out = eval_int8_drift.main(["--config_file", drift_yaml, "--clips", "2", "--batch", "2",
                                "--static", "--w4", "--train_steps", "1", "--device", "cpu"])
    assert seen == [(False, False)] * 3 and flags() == (True, True)
    assert sorted(out) == ["clips_per_set", "drift_ratio", "fid_bf16_seed_floor",
                           "fid_bf16_vs_int8", "isc_bf16", "isc_int8"]
    assert out["clips_per_set"] == 2
    assert all(np.isfinite(v) for v in out.values())
    assert out["drift_ratio"] == out["fid_bf16_vs_int8"] / max(out["fid_bf16_seed_floor"], 1e-9)
    assert '"drift_ratio"' in capsys.readouterr().out


def test_drift_sample_set_is_seeded(drift_yaml):
    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.tools.eval_int8_drift import caption_ids, sample_set
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config

    model = build_model(load_yaml_config(drift_yaml), device="cpu", seed=0)
    model.dtype = torch.bfloat16
    ids = caption_ids(np.random.default_rng(0), 3)
    assert ids.shape == (3, 77) and (ids[:, 0] == 49406).all()
    qp = model.quantize_for_serving(weight_bits=4)
    for engine in (None, qp):
        a = sample_set(model, ids, 3, 2, 100, qp=engine)
        b = sample_set(model, ids, 3, 2, 100, qp=engine)
        assert len(a) == 3 and a[0].shape == SMALL and a[0].dtype == np.float32
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        assert all(np.isfinite(x).all() for x in a)


def test_drift_captions_need_the_bpe_table(drift_yaml, tmp_path, monkeypatch):
    from text_to_sound_synthesis_torch.tools import eval_int8_drift

    monkeypatch.setenv("T2S_CLIP_BPE", str(tmp_path / "absent.txt.gz"))
    caps = tmp_path / "caps.txt"
    caps.write_text("a dog barks\n")
    if os.path.isfile(os.path.join(REPO, "artifacts", "bpe_simple_vocab_16e6.txt.gz")):
        pytest.skip("the BPE merge table is in the repository")
    with pytest.raises(FileNotFoundError, match="BPE merge table"):
        eval_int8_drift.main(["--config_file", drift_yaml, "--captions", str(caps),
                              "--clips", "1", "--batch", "1", "--device", "cpu"])
