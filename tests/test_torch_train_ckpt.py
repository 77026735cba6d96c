"""The port's Stage-2 training on its own: checkpoints (save -> resume ->
continue bit for bit equal to an uninterrupted run; a reference-layout
``.pth`` resumed with no converter; names, ordering, atomic writes), the
``Solver`` and the training CLI, on the CPU at the tiny size of
``tests/test_torch_train.py``."""

import copy
import os

import numpy as np
import pytest
import torch

from text_to_sound_synthesis_torch.data.loader import ShardedLoader
from text_to_sound_synthesis_torch.engine import checkpoint as ck
from text_to_sound_synthesis_torch.engine.clip_grad import ClipGradNorm
from text_to_sound_synthesis_torch.engine.logger import Logger
from text_to_sound_synthesis_torch.engine.optimizers import build_optimizer
from text_to_sound_synthesis_torch.engine.schedulers import ReduceLROnPlateauWithWarmup
from text_to_sound_synthesis_torch.engine.solver import Solver
from text_to_sound_synthesis_torch.engine.train_state import DiffusionTrainState, make_train_step
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.parallel import local_device

from tests._torch_tiny import CTX, OPT_CFG, T, TRAIN_CFG, VOCAB, batch, tbatch

torch.set_num_threads(1)

SOLVER_CFG = {
    "solver": {
        "base_lr": 1e-3, "adjust_lr": "none", "max_epochs": 2, "save_epochs": 1,
        "validation_epochs": 1, "sample_iterations": 2,
        "ema": {"decay": 0.9, "update_interval": 2},
        "clip_grad_norm": {"target": "text_to_sound_synthesis_tpu.engine.ClipGradNorm",
                           "params": {"start_iteration": 0, "end_iteration": 5000,
                                      "max_norm": 0.5}},
        "optimizers_and_schedulers": [{
            "name": "none",
            "optimizer": OPT_CFG,
            "scheduler": {"step_iteration": 1,
                          "target": "text_to_sound_synthesis_tpu.engine.ReduceLROnPlateauWithWarmup",
                          "params": {"factor": 0.5, "patience": 100, "min_lr": 1e-6,
                                     "warmup_lr": 2e-3, "warmup": 2}},
        }],
    },
    "dataloader": {"batch_size": 4},
}


class TokenDataset:
    """In-memory items carrying BPE ids (``condition_token``): no BPE table needed."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.image = rng.uniform(-1, 1, (n, 1, 4, 16)).astype(np.float32)
        self.token = rng.integers(0, VOCAB, (n, CTX)).astype(np.int64)

    def __len__(self):
        return len(self.image)

    def __getitem__(self, i):
        return {"image": self.image[i], "condition_token": self.token[i]}


def loaders(n=8):
    ds = TokenDataset(n)
    train = ShardedLoader(ds, 4, seed=0, num_shards=1, shard_index=0)
    return {"train_loader": train, "train_iterations": len(train),
            "validation_loader": ShardedLoader(ds, 4, seed=0, num_shards=1, shard_index=0,
                                               shuffle=False)}


def fresh(seed=0):
    model = build_model(TRAIN_CFG, device="cpu", seed=seed)
    den = model.diffusion.transformer
    state = DiffusionTrainState.create(den, build_optimizer(OPT_CFG, den, 1e-3), T)
    return model, state


def run(model, state, n, gen, sched):
    step = make_train_step(model, ClipGradNorm(0, 5000, 0.5), 0.9, 3)
    tb = tbatch(batch(3))
    losses = []
    for _ in range(n):
        state, m = step(state, tb, sched.lr, generator=gen)
        sched.step(m.loss.item())
        losses.append(m.loss.item())
    return losses


def snapshot(model, state):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            [e.clone() for e in state.ema_params], state.lt.Lt_history.clone(),
            state.lt.Lt_count.clone(), copy.deepcopy(state.optimizer.state_dict()))


def assert_same(a, b):
    (ma, ea, ha, ca, oa), (mb, eb, hb, cb, ob) = a, b
    assert ma.keys() == mb.keys() and all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for x, y in zip(ea, eb))
    assert torch.equal(ha, hb) and torch.equal(ca, cb)
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_resume_continues_bit_for_bit(tmp_path):
    """10 steps, save, restore into a fresh state, 5 more steps: equal, bit for
    bit, to 15 steps uninterrupted (params, EMA, moments, timestep state,
    losses)."""
    sched_kw = dict(base_lr=1e-3, factor=0.5, patience=2, warmup_lr=2e-3, warmup=3)
    model, state = fresh()
    gen, sched = torch.Generator().manual_seed(7), ReduceLROnPlateauWithWarmup(**sched_kw)
    run(model, state, 10, gen, sched)
    path = ck.save_checkpoint(str(tmp_path / "last.pth"), ck.train_payload(
        model, state, last_epoch=0, scheduler=sched, acc_lists=([0.5] * T, [0.25] * T),
        generator_states=[gen.get_state()]))
    assert os.listdir(tmp_path) == ["last.pth"]          # the temporary file is gone
    want_losses = run(model, state, 5, gen, sched)
    want = snapshot(model, state)

    model2, state2 = fresh(seed=9)                        # other random weights
    sched2 = ReduceLROnPlateauWithWarmup(**sched_kw)
    host = ck.restore_train_state(ck.load_checkpoint(path), model2, state2, scheduler=sched2)
    assert host["last_iter"] == state2.step == 10 and host["last_epoch"] == 0
    assert host["acc_lists"] == [[0.5] * T, [0.25] * T]
    gen2 = torch.Generator().set_state(host["generator_states"][0])
    assert run(model2, state2, 5, gen2, sched2) == want_losses
    assert_same(snapshot(model2, state2), want)
    assert sched2.state_dict() == sched.state_dict()


def _reference_file(model, state, sched, path):
    """The reference solver's layout (solver_spec.py:336-447), written by hand:
    its model dict keeps the schedule buffers, its EMA the frozen text tower,
    its scheduler its own state, the learning rate on the optimizer."""
    sd = dict(model.state_dict())
    sched_sd = model.diffusion.schedule()
    for name, v in zip(("log_at", "log_bt", "log_ct", "log_1_min_ct", "log_cumprod_at",
                        "log_cumprod_bt", "log_cumprod_ct", "log_1_min_cumprod_ct"), sched_sd):
        sd[f"transformer.{name}"] = v
    sd["transformer.Lt_history"] = state.lt.Lt_history
    sd["transformer.Lt_count"] = state.lt.Lt_count
    ema = {f"transformer.{n}": e for (n, _), e in zip(state.named_params(), state.ema_params)}
    ema.update({f"condition_emb.{k}": v for k, v in model.cond.state_dict().items()})
    ema.update({"Lt_history": state.lt.Lt_history, "Lt_count": state.lt.Lt_count})
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    for g in opt_sd["param_groups"]:
        g["lr"] = sched.lr          # the reference's scheduler writes its rate there
    torch.save({
        "last_epoch": 3, "last_iter": state.step, "model": sd, "ema": ema,
        "clip_grad_norm": {"start_iteration": 0, "end_iteration": 5000, "max_norm": 0.5},
        "optimizer_and_scheduler": {"none": {
            "optimizer": {"module": opt_sd, "step_iteration": 1},
            "scheduler": {"module": {"factor": sched.factor, "best": sched.best,
                                     "num_bad_epochs": sched.num_bad,
                                     "last_epoch": sched.last_epoch,
                                     "cooldown_counter": sched.cooldown_counter,
                                     "min_lrs": [sched.min_lr]},
                          "step_iteration": 1},
            "start_epoch": 0, "end_epoch": 400, "start_iteration": 0, "end_iteration": -1}},
    }, path)


def test_reference_layout_resumes(tmp_path):
    model, state = fresh()
    gen, sched = torch.Generator().manual_seed(1), ReduceLROnPlateauWithWarmup(
        base_lr=1e-3, warmup_lr=2e-3, warmup=5)
    run(model, state, 4, gen, sched)
    path = str(tmp_path / "released.pth")
    _reference_file(model, state, sched, path)
    want = snapshot(model, state)

    model2, state2 = fresh(seed=3)
    sched2 = ReduceLROnPlateauWithWarmup(base_lr=1e-3, warmup_lr=2e-3, warmup=5)
    host = ck.restore_train_state(ck.load_checkpoint(path), model2, state2, scheduler=sched2)
    assert (host["last_epoch"], host["last_iter"], host["acc_lists"]) == (3, 4, None)
    assert_same(snapshot(model2, state2), want)
    assert (sched2.last_epoch, sched2.num_bad, sched2.lr) == (4, sched.num_bad, sched.lr)
    # and training goes on from it
    run(model2, state2, 2, gen, sched2)
    assert state2.step == 6
    # a key that fits nowhere raises
    bad = ck.load_checkpoint(path)
    bad["model"]["transformer.unknown"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="unknown"):
        ck.restore_train_state(bad, *fresh())


def test_warm_start_prefers_the_ema(tmp_path):
    model, state = fresh()
    with torch.no_grad():
        for e in state.ema_params:
            e.add_(1.0)
    path = ck.save_checkpoint(str(tmp_path / "w.pth"),
                              ck.train_payload(model, state, last_epoch=0))
    model2, _ = fresh(seed=4)
    ck.load_weights(model2, ck.load_checkpoint(path))
    for (n, p), e in zip(model2.diffusion.transformer.named_parameters(), state.ema_params):
        assert torch.equal(p, e), n
    assert torch.equal(model2.codec.encoder.conv_in.weight, model.codec.encoder.conv_in.weight)


def test_latest_checkpoint_orders_by_stored_iteration(tmp_path):
    model, state = fresh()
    d = str(tmp_path)
    assert ck.latest_checkpoint(d) is None
    for name, it in (("auto_a", 8), ("auto_b", 6), ("1e_4iter", 4), ("last", 8),
                     ("best_e0_1.0", 99)):
        state.step = it
        ck.save_checkpoint(ck.checkpoint_path(d, name), ck.train_payload(model, state,
                                                                         last_epoch=0))
    assert ck.latest_checkpoint(d) == "last"              # 'last' wins the tie at 8
    os.remove(ck.checkpoint_path(d, "last"))
    assert ck.latest_checkpoint(d) == "auto_a"            # by iteration, not by name
    open(os.path.join(d, "auto_b.pth.tmp123"), "wb").close()   # an unfinished write
    assert ck.latest_checkpoint(d) == "auto_a"


def _train_params(solver):
    return [p.detach().clone() for p in solver.model.diffusion.transformer.parameters()]


def test_solver_trains_saves_and_resumes_bit_for_bit(tmp_path):
    """Two epochs in one run against one epoch, a fresh Solver resumed from
    its slot, and the second epoch: the same weights, EMA, scheduler and
    accuracy lists, bit for bit."""
    cfg = copy.deepcopy(SOLVER_CFG)
    whole = Solver(cfg, build_model(TRAIN_CFG, device="cpu", seed=0), loaders(),
                   Logger(str(tmp_path), "whole"), seed=0)
    whole.train()
    assert whole.state.step == 4
    names = sorted(os.listdir(whole.logger.ckpt_dir))
    assert {"auto_a.pth", "auto_b.pth", "last.pth", "0e_2iter.pth", "1e_4iter.pth"} <= set(names)
    assert any(n.startswith("best_e") for n in names)
    assert os.listdir(os.path.join(whole.logger.run_dir, "samples"))

    cfg1 = copy.deepcopy(SOLVER_CFG)
    cfg1["solver"]["max_epochs"] = 1
    first = Solver(cfg1, build_model(TRAIN_CFG, device="cpu", seed=0), loaders(),
                   Logger(str(tmp_path), "split"), seed=0)
    first.train()
    second = Solver(cfg, build_model(TRAIN_CFG, device="cpu", seed=5), loaders(),
                    Logger(str(tmp_path), "split"), seed=0)
    assert second.resume("auto_a")
    assert second.last_epoch == 0 and second.state.step == 2
    second.train()
    assert second.state.step == 4
    assert all(torch.equal(a, b) for a, b in zip(_train_params(second), _train_params(whole)))
    assert all(torch.equal(a, b) for a, b in zip(second.state.ema_params, whole.state.ema_params))
    assert second.scheduler.state_dict() == whole.scheduler.state_dict()
    assert second.diffusion_acc_list == whole.diffusion_acc_list
    assert torch.equal(second.state.lt.Lt_count, whole.state.lt.Lt_count)


def test_training_cli_runs_and_resumes(tmp_path, monkeypatch):
    """``tools.train_diffsound`` on the CPU with an in-memory dataset of BPE
    ids (the captioned datasets need the BPE table): a run, then
    ``--auto_resume`` of it with one more epoch."""
    import yaml

    from text_to_sound_synthesis_torch.tools import train_diffsound as cli

    cfg = copy.deepcopy(SOLVER_CFG)
    cfg["model"] = TRAIN_CFG
    cfg["solver"]["max_epochs"] = 1
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setattr("text_to_sound_synthesis_torch.data.loader.build_dataloader",
                        lambda config, seed=0: loaders())
    args = ["--config_file", str(path), "--output", str(tmp_path), "--name", "cli",
            "--device", "cpu"]
    assert cli.main(args) == 0
    ckpt = tmp_path / "cli" / "checkpoint"
    assert ck.load_checkpoint(str(ckpt / "last.pth"))["last_iter"] == 2
    assert cli.main(args + ["--auto_resume", "solver.max_epochs", "2"]) == 0
    assert ck.load_checkpoint(str(ckpt / "last.pth"))["last_iter"] == 4
    assert (tmp_path / "cli" / "configs" / "config.yaml").exists()


def test_training_refuses_a_missing_card():
    """The entry points default to the card; without one they raise unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        local_device("cuda")
    from text_to_sound_synthesis_torch.tools import train_diffsound as cli

    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--config_file", "unused.yaml"])
    assert local_device("cpu") == torch.device("cpu")


def test_dropout_acts_only_in_the_training_loss():
    """With resid_pdrop > 0 the training loss draws dropout masks (two runs
    differ); without training (and in the samplers, the model being in eval
    mode from build_model) it is deterministic."""
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["params"]["diffusion_config"]["params"]["transformer_config"]["params"]["resid_pdrop"] = 0.5
    model = build_model(cfg, device="cpu", seed=0)
    assert not model.training
    tb = tbatch(batch())
    t, pt = torch.tensor([0, 1, 2, 3]), torch.full((4,), 0.25)
    g = torch.zeros(4, 16, 11)
    loss = lambda train: model.loss(tb["image"], tb["condition_token"], t, pt, gumbel=g,
                                    is_train=train).loss.item()
    assert loss(True) != loss(True)
    assert loss(False) == loss(False)
    assert not model.diffusion.transformer.training


def test_captioned_dataset_training_needs_the_bpe_table(tmp_path):
    """The CLI's captioned datasets tokenize captions, which needs the CLIP
    BPE table (absent here: skipped, as the JAX package's solver test)."""
    from text_to_sound_synthesis_torch.models.clip.tokenizer import find_default_bpe

    try:
        find_default_bpe()
    except FileNotFoundError:
        pytest.skip("BPE artifact unavailable")
    model = build_model(TRAIN_CFG, device="cpu", seed=0)
    solver = Solver(SOLVER_CFG, model, loaders(), Logger(str(tmp_path), "bpe"), seed=0)
    b = solver._to_model_batch({"image": np.zeros((2, 1, 4, 16), np.float32),
                                "text": ["a dog barks", "rain"]})
    assert b["condition_token"].shape == (2, CTX)
