"""Worker of the port's two-process gloo tests (tests/test_torch_parallel.py,
tests/test_torch_stage1_tools.py): one rank of a 2-process gloo group on the
CPU, a fresh interpreter running the port alone (no JAX).

    python tests/_torch_mp_worker.py <port> <rank> <world> <out> [stage1 | ar CONFIG PORT2]

Each rank joins ``tcp://localhost:<port>``. With ``stage1`` it runs two
adversarial SpecVQGAN steps on its half of each global batch, data parallel
over the group (``main_stage1``); with ``ar`` two ``train_ar`` steps on its
share of each global AR batch with the GPT under DDP, then the ``train_ar``
CLI on CONFIG for one step in a group at PORT2 (``main_ar``); otherwise:
1. the tiny model's training loss on its half of one global batch, with the
   draws supplied (the global draws, sliced), backward through the denoiser
   under DDP: the averaged gradients;
2. one whole train step (clip, AdamW, EMA, the timestep state) under DDP:
   the parameters, the timestep state and the metrics after it;
3. the ``ShardedLoader`` ids of its shard (the shard from the group);
4. ``sample_tokens_fused_sharded`` over the group (its tokens gathered);
5. the ``Solver`` under DDP: one epoch on its shard of an in-memory dataset,
   with validation, the checkpoints the primary writes, and the gathered
   generator states.
It writes what it saw to ``<out>.<rank>.pt``.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tests._torch_tiny import (AR_BS, AR_MODEL, B, OPT_CFG, S1_B, T, TRAIN_CFG,  # noqa: E402
                               ar_batches, batch, stage1_batches, stage1_state, tbatch)
from text_to_sound_synthesis_torch.data.loader import ShardedLoader  # noqa: E402
from text_to_sound_synthesis_torch.engine.clip_grad import ClipGradNorm  # noqa: E402
from text_to_sound_synthesis_torch.engine.optimizers import build_optimizer  # noqa: E402
from text_to_sound_synthesis_torch.engine.train_state import (  # noqa: E402
    DiffusionTrainState, TrainDraws, make_train_step)
from text_to_sound_synthesis_torch.models import build_model  # noqa: E402
from text_to_sound_synthesis_torch.models.diffusion.process import (  # noqa: E402
    TimestepDraws, sample_tokens_fused_sharded)
from text_to_sound_synthesis_torch.parallel import init_distributed, wrap_ddp  # noqa: E402

torch.set_num_threads(1)


def global_draws(n=2 * B):
    """One global batch's draws (the parent process makes the same ones)."""
    rng = np.random.default_rng(11)
    return (torch.from_numpy(rng.gumbel(size=(n, T)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, T, n)),
            torch.from_numpy(rng.gumbel(size=(n, 16, 11)).astype(np.float32)))


def global_batch():
    a, b = tbatch(batch(21)), tbatch(batch(22))
    return {k: torch.cat([a[k], b[k]]) for k in a}


class TokenDataset:
    def __init__(self, n=8):
        rng = np.random.default_rng(31)
        self.image = rng.uniform(-1, 1, (n, 1, 4, 16)).astype(np.float32)
        self.token = rng.integers(0, 64, (n, 12))

    def __len__(self):
        return len(self.image)

    def __getitem__(self, i):
        return {"image": self.image[i], "condition_token": self.token[i]}


SOLVER_CFG = {
    "solver": {"base_lr": 1e-3, "max_epochs": 1, "save_epochs": 1, "validation_epochs": 1,
               "sample_iterations": 0, "ema": {"decay": 0.9, "update_interval": 1},
               "optimizers_and_schedulers": [{"name": "none", "optimizer": OPT_CFG}]},
    "dataloader": {"batch_size": 2},
}


class IdDataset:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"id": i}


#: the Stage-1 steps' loss: the discriminator on from the first step, the adaptive weight on
S1_LOSS = dict(disc_start=0, min_adapt_weight=0.0, max_adapt_weight=1e4, perceptual_weight=0.0)


def main_stage1(rank, world, out):
    """Two data-parallel Stage-1 steps: the weights, the BatchNorm running
    statistics and the metrics after each."""
    from text_to_sound_synthesis_torch.engine.vqgan_solver import (VQGANLossConfig,
                                                                   make_vqgan_train_step)

    state = stage1_state()
    step = make_vqgan_train_step(None, VQGANLossConfig(**S1_LOSS), group=dist.group.WORLD)
    n = S1_B // world
    report = []
    for mel in stage1_batches():
        state, m = step(state, mel[rank * n:(rank + 1) * n], 1e-4)
        report.append({"codec": {k: v.clone() for k, v in state.codec.state_dict().items()},
                       "disc": {k: v.clone() for k, v in state.disc.state_dict().items()},
                       "metrics": {k: v.clone() for k, v in m.items() if k != "indices"}})
    torch.save(report, f"{out}.{rank}.pt")


def main_ar(rank, world, out, config, port2):
    """Two ``train_ar`` steps at lr = world x AR_BS x base_lr on this rank's
    rows of each global batch, the GPT under DDP: the loss, the gradients
    and the GPT's weights after each. Then the ``train_ar`` CLI for one step
    on ``config`` (its own group, from torchrun's variables)."""
    from text_to_sound_synthesis_torch.tools import train_ar

    model = train_ar.build_model({"model": AR_MODEL}, torch.device("cpu"), 0)
    model.gpt.train()
    gpt = wrap_ddp(model.gpt, "cpu")
    opt = train_ar.build_optimizer(model, world * AR_BS * AR_MODEL["base_learning_rate"])
    n = AR_BS // world
    report = []
    for mel, cond in ar_batches():
        loss = train_ar.train_step(model, opt, mel[rank * n:(rank + 1) * n],
                                   cond[rank * n:(rank + 1) * n], None, gpt)
        report.append({"loss": float(loss),
                       "grads": {k: p.grad.clone() for k, p in model.gpt.named_parameters()},
                       "gpt": {k: v.clone() for k, v in model.gpt.state_dict().items()}})
    torch.save(report, f"{out}.{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=port2)
    train_ar.main(["-b", config, "--output", os.path.dirname(out), "--max_steps", "1",
                   "--log_every", "1", "--device", "cpu"])


def main():
    port, rank, world, out = sys.argv[1:5]
    rank, world = int(rank), int(world)
    init_distributed("cpu", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    if sys.argv[5:6] == ["ar"]:
        main_ar(rank, world, out, *sys.argv[6:8])
        return
    if sys.argv[5:] == ["stage1"]:
        main_stage1(rank, world, out)
        dist.barrier()
        dist.destroy_process_group()
        return
    sl = slice(rank * B, (rank + 1) * B)
    gb = {k: v[sl] for k, v in global_batch().items()}
    g_imp, unif, gumbel = (x[sl] for x in global_draws())
    report = {}

    # 1. the averaged gradients
    model = build_model(TRAIN_CFG, device="cpu", seed=0)
    den = model.diffusion.transformer
    ddp = wrap_ddp(den, "cpu")
    t = unif.long()
    pt = torch.full((B,), 1.0 / T)
    out_loss = model.loss(gb["image"], gb["condition_token"], t, pt, gumbel=gumbel, denoiser=ddp)
    out_loss.loss.backward()
    report["grads"] = {n: p.grad.clone() for n, p in den.named_parameters()}

    # 2. one train step under DDP
    model = build_model(TRAIN_CFG, device="cpu", seed=0)
    den = model.diffusion.transformer
    ddp = wrap_ddp(den, "cpu")
    state = DiffusionTrainState.create(den, build_optimizer(OPT_CFG, den, 1e-3), T)
    step = make_train_step(model, ClipGradNorm(0, 5000, 0.5), 0.9, 1, ddp=ddp)
    state, m = step(state, gb, 1e-3, draws=TrainDraws(TimestepDraws(g_imp, unif), gumbel))
    report["params"] = {n: p.detach().clone() for n, p in den.named_parameters()}
    report["lt"] = (state.lt.Lt_history.clone(), state.lt.Lt_count.clone())
    report["metrics"] = {k: v.clone() for k, v in m._asdict().items()}

    # 3. the loader's shard, taken from the group
    ld = ShardedLoader(IdDataset(), 2, seed=0)
    report["loader"] = (ld.num_shards, ld.shard_index, [int(i) for b in ld for i in b["id"]])

    # 4. the sharded sampler over the group
    cond = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 12, 8)).astype(np.float32))
    fresh = build_model(TRAIN_CFG, device="cpu", seed=0)
    report["tokens"] = sample_tokens_fused_sharded(fresh.diffusion, cond, seed=77,
                                                   truncation_r=0.85)
    # 5. the Solver under DDP
    from text_to_sound_synthesis_torch.engine.logger import Logger
    from text_to_sound_synthesis_torch.engine.solver import Solver

    ds = TokenDataset()
    loaders = {"train_loader": ShardedLoader(ds, 2, seed=0), "train_iterations": 2,
               "validation_loader": ShardedLoader(ds, 2, seed=0, shuffle=False)}
    solver = Solver(SOLVER_CFG, build_model(TRAIN_CFG, device="cpu", seed=0), loaders,
                    Logger(out + "_run", "run"), seed=0)
    solver.train()
    report["solver"] = {"step": solver.state.step,
                        "params": [p.detach().clone() for p in solver.model.parameters()],
                        "acc": solver.diffusion_acc_list}
    torch.save(report, f"{out}.{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
