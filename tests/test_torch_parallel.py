"""The port's data parallelism on the CPU: the sharded samplers (two shards
on one device, bit for bit equal to the per-shard runs with the folded
seeds, as ``tests/test_parallel_generation.py`` pins for JAX) and a real
2-process gloo group (fresh interpreters, ``tests/_torch_mp_worker.py``):
DDP's averaged gradients and a whole DDP train step against one process on
the whole batch, the loader's shards, the sampler over the group.

Tolerances: the averaged gradients within 1e-6 of the largest gradient of
all (each rank's f32 sums cover half the batch, the average adds the halves
in another order); after the step the parameters within 2e-6 but for at
most 1e-3 of a tensor's values and the attention keys' biases, held to 2 lr
as in ``tests/test_torch_train.py`` (AdamW's eps amplification there); the
timestep state and the timesteps exactly, the loss within rtol 1e-6.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from text_to_sound_synthesis_torch.engine.clip_grad import ClipGradNorm
from text_to_sound_synthesis_torch.engine.optimizers import build_optimizer
from text_to_sound_synthesis_torch.engine.train_state import (DiffusionTrainState, TrainDraws,
                                                              make_train_step)
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.diffusion import int8_runtime as trt
from text_to_sound_synthesis_torch.models.diffusion.process import (
    DiscreteDiffusion, TimestepDraws, sample_tokens_fused, sample_tokens_fused_sharded)
from text_to_sound_synthesis_torch.parallel import fold_seed, run_sharded

from tests._torch_mp_worker import global_batch, global_draws
from tests._torch_tiny import B, OPT_CFG, T, TRAIN_CFG

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the int8 engine's geometry of tests/test_torch_int8_runtime.py
TS, LS, NE, D, HEADS, CD, S = 10, 15, 16, 128, 4, 64, 7
TCFG = {"params": dict(n_layer=2, n_embd=D, n_head=HEADS, content_seq_len=LS, condition_dim=CD,
                       content_spatial_size=(3, 5), block_activate="GELU2")}
ECFG = {"params": dict(num_embed=NE, embed_dim=D, spatial_size=(3, 5))}


def _denoiser():
    torch.manual_seed(0)
    return DiscreteDiffusion(transformer_config=TCFG, content_emb_config=ECFG, diffusion_step=TS)


def _cond(n=8):
    c = np.random.default_rng(3).standard_normal((n, S, CD)).astype(np.float32)
    return torch.from_numpy(c / np.linalg.norm(c, axis=-1, keepdims=True))


def _per_shard(sample_one, cond, n, seed):
    Bs = cond.shape[0] // n
    return torch.cat([sample_one(cond[i * Bs:(i + 1) * Bs],
                                 torch.Generator().manual_seed(fold_seed(seed, i)))
                      for i in range(n)])


@pytest.mark.parametrize("n,skip", [(2, 0), (4, 3)])
def test_fused_sampler_sharded_matches_per_shard(n, skip):
    model, cond = _denoiser(), _cond()
    got = sample_tokens_fused_sharded(model, cond, seed=11, devices=["cpu"] * n,
                                      truncation_r=0.85, skip_step=skip)
    want = _per_shard(lambda c, g: sample_tokens_fused(model, c, generator=g, truncation_r=0.85,
                                                       skip_step=skip), cond, n, 11)
    assert got.shape == (8, LS) and bool((got != NE).all())
    assert torch.equal(got, want)
    # the shards draw apart: not one sample repeated
    assert not torch.equal(got[:4], got[4:])


@pytest.mark.parametrize("bits,skip", [(8, 0), (4, 4)])
def test_int8_sampler_sharded_matches_per_shard(bits, skip):
    model, cond = _denoiser(), _cond()
    qp = trt.quantize_denoiser(model, n_head=HEADS, seq_len=LS, num_timesteps=TS,
                               weight_bits=bits)
    sched = model.schedule()
    got = trt.sample_tokens_int8_sharded(qp, sched, cond, seed=13, devices=["cpu", "cpu"],
                                         truncation_r=0.85, skip_step=skip)
    want = _per_shard(lambda c, g: trt.sample_tokens_int8(qp, sched, c, generator=g,
                                                          truncation_r=0.85, skip_step=skip),
                      cond, 2, 13)
    assert got.shape == (8, LS) and bool((got != NE).all())
    assert torch.equal(got, want)


def test_sharded_runner_checks_its_shards():
    with pytest.raises(ValueError, match="multiple of the shard count"):
        run_sharded(lambda x, g: x, torch.zeros(5, 2), seed=0, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="devices or a process group"):
        run_sharded(lambda x, g: x, torch.zeros(4, 2), seed=0)
    assert len({fold_seed(0, i) for i in range(64)} | {fold_seed(1, 0)}) == 65
    assert all(0 <= fold_seed(s, i) < 2 ** 63 for s in (0, 2 ** 62) for i in (0, 7))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _close(got, want, what, lr=1e-3):
    d = (got - want).abs()
    assert float(d.max()) <= 2 * lr, (what, float(d.max()))
    if not what.endswith("key.bias"):
        assert float((d > 2e-6).float().mean()) <= 1e-3, (what, int((d > 2e-6).sum()))


def test_two_process_gloo_matches_one_process(tmp_path):
    port, out = _free_port(), str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_mp_worker.py"),
                               str(port), str(r), "2", out], cwd=REPO, env=env,
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
    rep = reps[0]

    gb = global_batch()
    g_imp, unif, gumbel = global_draws()
    # 1. one process, the whole batch
    model = build_model(TRAIN_CFG, device="cpu", seed=0)
    den = model.diffusion.transformer
    loss = model.loss(gb["image"], gb["condition_token"], unif.long(),
                      torch.full((2 * B,), 1.0 / T), gumbel=gumbel)
    loss.loss.backward()
    top = max(float(p.grad.abs().max()) for p in den.parameters())
    for n, p in den.named_parameters():
        torch.testing.assert_close(rep["grads"][n], p.grad, rtol=0, atol=1e-6 * top, msg=n)

    # 2. the train step
    model = build_model(TRAIN_CFG, device="cpu", seed=0)
    den = model.diffusion.transformer
    state = DiffusionTrainState.create(den, build_optimizer(OPT_CFG, den, 1e-3), T)
    step = make_train_step(model, ClipGradNorm(0, 5000, 0.5), 0.9, 1)
    state, m = step(state, gb, 1e-3, draws=TrainDraws(TimestepDraws(g_imp, unif), gumbel))
    for n, p in den.named_parameters():
        _close(rep["params"][n], p.detach(), n)
    assert torch.equal(rep["lt"][1], state.lt.Lt_count)
    torch.testing.assert_close(rep["lt"][0], state.lt.Lt_history, rtol=1e-5, atol=0)
    assert torch.equal(rep["metrics"]["t"], m.t)
    torch.testing.assert_close(rep["metrics"]["loss"], m.loss, rtol=1e-6, atol=0)
    torch.testing.assert_close(rep["metrics"]["grad_norm"], m.grad_norm, rtol=1e-5, atol=0)

    # both ranks hold the same weights and timestep state after the step
    for n in rep["params"]:
        assert torch.equal(reps[1]["params"][n], rep["params"][n]), n
    assert all(torch.equal(a, b) for a, b in zip(reps[1]["lt"], rep["lt"]))

    # 3. the loader: each rank its shard of the group, disjoint, equal in length
    (s0, i0, ids0), (s1, i1, ids1) = reps[0]["loader"], reps[1]["loader"]
    assert (s0, i0, s1, i1) == (2, 0, 2, 1)
    assert len(ids0) == len(ids1) == 4 and not set(ids0) & set(ids1)

    # 4. the sampler over the group: the per-shard runs with the folded seeds
    cond = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 12, 8)).astype(np.float32))
    fresh = build_model(TRAIN_CFG, device="cpu", seed=0)
    want = _per_shard(lambda c, g: sample_tokens_fused(fresh.diffusion, c, generator=g,
                                                       truncation_r=0.85), cond, 2, 77)
    assert torch.equal(rep["tokens"], want) and torch.equal(reps[1]["tokens"], want)

    # 5. the Solver under DDP: 2 iterations on each rank's shard, the ranks in
    # step; the primary wrote the checkpoints, each with both ranks' generators
    s0, s1 = reps[0]["solver"], reps[1]["solver"]
    assert s0["step"] == s1["step"] == 2 and s0["acc"] == s1["acc"]
    assert all(torch.equal(a, b) for a, b in zip(s0["params"], s1["params"]))
    from text_to_sound_synthesis_torch.engine import checkpoint as ck

    ckpt_dir = os.path.join(out + "_run", "run", "checkpoint")
    assert ck.latest_checkpoint(ckpt_dir) == "last"
    payload = ck.load_checkpoint(ck.checkpoint_path(ckpt_dir, "last"))
    assert payload["last_iter"] == 2 and len(payload["generator"]) == 2
    assert any(n.startswith("best_e0_") for n in os.listdir(ckpt_dir))
