"""The port's AR tools, ``train_ar`` -> ``generate_ar``, end to end on the
CPU at ``tests/test_cli.py``'s AR size (a 4 x 16 mel, a 2 x 8 token grid,
8-d features), and held against the JAX package: the train step
(``train_ar.train_step``: the loss, its gradients and the AdamW update with
the minGPT decay split) against the JAX tool's step (``Net2NetTransformer.loss``
under ``optax.adamw(b1 0.9, b2 0.95, weight decay 0.01, mask=decay_mask)``)
from the same bridged weights on the same batch, and ``generate_ar``'s greedy
samples against JAX's ``Net2NetTransformer.sample`` on those weights."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from text_to_sound_synthesis_tpu.engine.optimizers import decay_mask
from text_to_sound_synthesis_tpu.utils.config import instantiate_from_config as j_instantiate
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.engine.checkpoint import save_checkpoint
from text_to_sound_synthesis_torch.models.melgan import MelGANGenerator
from text_to_sound_synthesis_torch.tools import generate_ar, train_ar
from text_to_sound_synthesis_torch.utils.config import instantiate_from_config

from tests._torch_tiny import AR_BS, AR_MODEL, ar_batches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_data(tmp_path, rng, n_cls=2, n_per=4, mel=4, frames=40):
    """<root>/feats/<cls>/<vid>_mel.npy, <root>/tok/<cls>/<vid>.txt (8-d
    features) and a train split; returns the config's path."""
    for c in range(n_cls):
        (tmp_path / "feats" / f"cls{c}").mkdir(parents=True)
        (tmp_path / "tok" / f"cls{c}").mkdir(parents=True)
        for i in range(n_per):
            np.save(tmp_path / "feats" / f"cls{c}" / f"v{i}_mel.npy",
                    rng.random((mel, frames)).astype(np.float32))
            np.savetxt(tmp_path / "tok" / f"cls{c}" / f"v{i}.txt", rng.random(8).astype(np.float32))
    split = tmp_path / "split_train.txt"
    split.write_text("\n".join(f"cls{c}/v{i}" for c in range(n_cls) for i in range(n_per)) + "\n")
    cfg = {"model": AR_MODEL,
           "dataloader": {"batch_size": 2, "train_datasets": [{
               "target": "text_to_sound_synthesis_tpu.data.SpecsDataset",
               "params": {"split": "train", "spec_dir_path": str(tmp_path / "feats" / "*"),
                          "split_path": str(split), "mel_num": 4, "spec_crop_len": 16,
                          "cls_token_dir_path": str(tmp_path / "tok" / "*"), "feat_dim": 8}}]}}
    path = tmp_path / "ar.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _jax_params(seed=0):
    jm = j_instantiate(AR_MODEL)
    init = jax.jit(jm.init_params, static_argnames=("mel_shape", "cond_shape"))
    p = init(jax.random.PRNGKey(seed), mel_shape=(1, 4, 16, 1), cond_shape=(1, 8, 1))
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(                # nonzero pos_emb and biases
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), p)
    return jm, p


def _port(p):
    model = from_jax.load_net2net(instantiate_from_config(AR_MODEL), p)
    model.codec.requires_grad_(False).eval()
    return model


def test_train_step_matches_jax_tool_step():
    """Two steps from the same weights on the same batches: the losses, the
    gradients of the first, and the GPT's weights after each AdamW step,
    decayed (the Linear and Conv kernels) and not (embeddings, norms,
    biases) alike; the codec does not move. Adam moves a weight by about lr
    sign(g) whatever g's size, so where a gradient is zero in exact
    arithmetic (the attention keys' biases: the softmax does not see a shift
    all keys share; below 1e-6 of the largest in the port's step) each side
    steps by its own rounding, and those weights are held to 2 lr alone."""
    jm, p = _jax_params()
    model = _port(p)
    lr = 2 * 1e-4
    opt = train_ar.build_optimizer(model, lr)
    tx = optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.01, mask=decay_mask)
    gp = p["gpt"]
    state = tx.init(gp["params"])
    codec_before = {k: v.clone() for k, v in model.codec.state_dict().items()}
    rng = np.random.default_rng(1)

    @jax.jit
    def value_and_grad(g, mel, cond):
        return jax.value_and_grad(lambda g: jm.loss({"codec": p["codec"], "gpt": g}, mel,
                                                    cond)[0])(g)

    tiny = {}
    for step in range(2):
        mel = rng.uniform(-1, 1, (2, 4, 16, 1)).astype(np.float32)
        cond = rng.standard_normal((2, 8, 1)).astype(np.float32)
        want, grads = value_and_grad(gp, jnp.asarray(mel), jnp.asarray(cond))
        updates, state = tx.update(grads["params"], state, gp["params"])
        gp = dict(gp, params=optax.apply_updates(gp["params"], updates))
        got = train_ar.train_step(model, opt, torch.from_numpy(mel), torch.from_numpy(cond))
        np.testing.assert_allclose(float(got), float(want), rtol=2e-6)
        if step == 0:
            g_want = from_jax.gpt_state_dict(jax.tree_util.tree_map(np.asarray, grads))
            for name, prm in model.gpt.named_parameters():
                np.testing.assert_allclose(prm.grad.numpy(), g_want[name], atol=2e-6,
                                           err_msg=name)
        g_max = max(float(prm.grad.abs().max()) for prm in model.gpt.parameters())
        w_want = from_jax.gpt_state_dict(jax.tree_util.tree_map(np.asarray, gp))
        for name, prm in model.gpt.named_parameters():
            tiny[name] = tiny.get(name, False) | (prm.grad.abs() < 1e-6 * g_max).numpy()
            d = np.abs(prm.detach().numpy() - w_want[name])
            assert (d[~tiny[name]] <= lr * 1e-3).all(), f"step {step}: {name} {d.max()}"
            assert (d <= 2 * lr).all(), f"step {step}: {name}"
    for k, v in model.codec.state_dict().items():
        assert torch.equal(v, codec_before[k]), k


def test_train_ar_then_generate_ar(tmp_path):
    """``train_ar`` two steps into a Lightning-layout checkpoint;
    ``generate_ar`` from it writes one finite (4, 16) spectrogram and wav a
    clip; from a checkpoint of the JAX weights, its greedy samples equal
    JAX's ``sample``."""
    cfg_path = _write_data(tmp_path, np.random.default_rng(0))
    out = tmp_path / "out"
    assert train_ar.main(["-b", str(cfg_path), "--output", str(out), "--max_steps", "2",
                          "--device", "cpu", "--log_every", "1"]) == 0
    ckpt = out / "ar_gpt" / "checkpoint" / "last.ckpt"
    payload = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert payload["global_step"] == 2 and payload["epoch"] == 1
    keys = payload["state_dict"].keys()
    assert any(k.startswith("first_stage_model.") for k in keys)
    assert "transformer.pos_emb" in keys and "transformer.embedder.weight" in keys

    voc = tmp_path / "voc"
    voc.mkdir()
    (voc / "args.yml").write_text("n_mel_channels: 4\nngf: 4\nn_residual_layers: 1\n")
    torch.save(MelGANGenerator(input_size=4, ngf=4, n_residual_layers=1).state_dict(),
               voc / "best_netG.pt")
    samples = tmp_path / "samples"
    common = ["--config", str(cfg_path), "--feats_dir", str(tmp_path / "tok" / "cls0"),
              "--samples_per_video", "1", "--batch", "4", "--device", "cpu"]
    assert generate_ar.main(common + ["--ckpt", str(ckpt), "--outdir", str(samples),
                                      "--top_k", "3", "--vocoder", str(voc)]) == 0
    files = sorted(os.listdir(samples))
    assert files == sorted([f"v{i}_sample_0.{e}" for i in range(4) for e in ("npy", "wav")])
    spec = np.load(samples / "v0_sample_0.npy")
    assert spec.shape == (4, 16) and np.isfinite(spec).all()

    jm, p = _jax_params(seed=3)
    jckpt = tmp_path / "jax.ckpt"
    save_checkpoint(str(jckpt), {"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in
                                                from_jax.net2net_state_dict(p).items()}})
    greedy = tmp_path / "greedy"
    assert generate_ar.main(common + ["--ckpt", str(jckpt), "--outdir", str(greedy),
                                      "--top_k", "1"]) == 0
    feats = np.stack([np.loadtxt(tmp_path / "tok" / "cls0" / f"v{i}.txt", dtype=np.float32)
                      for i in range(4)])[:, :, None]
    sample = jax.jit(lambda p, k, f: jm.sample(p, k, f, (2, 8), top_k=1))
    want = (np.asarray(sample(p, jax.random.PRNGKey(0), jnp.asarray(feats)))[..., 0] + 1.0) / 2.0
    for i in range(4):
        np.testing.assert_allclose(np.load(greedy / f"v{i}_sample_0.npy"), want[i], atol=1e-4)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_ar_data_parallel_over_two_processes(tmp_path):
    """``train_ar`` on a 2-process gloo group (fresh interpreters,
    ``tests/_torch_mp_worker.py ... ar``): the config's batch is the global
    batch, as in the JAX tool (the ranks form its data mesh,
    ``make_data_mesh_for_batch``), so each rank takes half of each global
    batch with the GPT under DDP over the data group, at lr = 2 x bs x
    base_lr (JAX's ``jax.device_count()`` rule); two steps against one
    process on the whole batch at the same lr. The ranks' mean loss within rtol 1e-6, the
    averaged gradients within 1e-6 of the largest, the weights within 1e-6
    but where a gradient is zero in exact arithmetic (below 1e-6 of the
    largest: the attention keys' biases), where each side's AdamW steps by
    its own rounding, held to 2 lr as in the step test above. The CLI then
    takes a step on the group and logs the rule's lr."""
    cfg_path = _write_data(tmp_path, np.random.default_rng(0))
    port, out = _free_port(), str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("RANK", None)
    port2 = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_mp_worker.py"),
                               str(port), str(r), "2", out, "ar", str(cfg_path), str(port2)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
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

    lr = 2 * AR_BS * AR_MODEL["base_learning_rate"]
    model = train_ar.build_model({"model": AR_MODEL}, torch.device("cpu"), 0)
    model.gpt.train()
    opt = train_ar.build_optimizer(model, lr)
    tiny = {}
    for i, (mel, cond) in enumerate(ar_batches()):
        loss = train_ar.train_step(model, opt, mel, cond)
        np.testing.assert_allclose((reps[0][i]["loss"] + reps[1][i]["loss"]) / 2, float(loss),
                                   rtol=1e-6)
        g_max = max(float(p.grad.abs().max()) for p in model.gpt.parameters())
        for k, p in model.gpt.named_parameters():
            assert float((reps[0][i]["grads"][k] - p.grad).abs().max()) <= 1e-6 * g_max, (i, k)
            tiny[k] = tiny.get(k, False) | (p.grad.abs() < 1e-6 * g_max)
            d = (reps[0][i]["gpt"][k] - p.detach()).abs()
            assert float(torch.where(tiny[k], 0.0, d).max()) <= 1e-6, (i, k, float(d.max()))
            assert float(d.max()) <= 2 * lr, (i, k)
            assert torch.equal(reps[1][i]["gpt"][k], reps[0][i]["gpt"][k]), (i, k)
    log = (tmp_path / "ar_gpt" / "log.txt").read_text()
    assert f"lr = 2 x 2 x 0.0001 = {2 * 2 * 1e-4:.2e} on cpu, 1 samples a rank" in log
    assert (tmp_path / "ar_gpt" / "checkpoint" / "last.ckpt").exists()


def test_tools_refuse_a_missing_card():
    """The entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        train_ar.main(["-b", "unused.yaml", "--output", "unused"])
    with pytest.raises(RuntimeError):
        generate_ar.main(["--config", "unused.yaml", "--ckpt", "x", "--feats_dir", "x"])
