"""The port's (data, model) mesh and Megatron model axis on the CPU
(``parallel/mesh.py``, ``parallel/sharding.py``), against the JAX package's
(``parallel/mesh.py``, ``parallel/sharding.py``, ``tests/test_parallel.py``
on its eight virtual devices), plus ``utils/misc.py``, the Solver's
``profile_dir`` hook and the trainers' global-batch rule.

The model axis runs in gloo groups of fresh interpreters
(``tests/_torch_mp_worker.py ... tp``), at the dry run's small geometry: 2
layers of d128, 2 heads of 64, a condition of 64 (``tools/dryrun.py``).

Tolerances: the split forward within 1e-4 of JAX's ``predict_start`` (the
port's denoiser parity test, ``tests/test_torch_onehot_sampler.py``). The
(2, 2) step against one process on the same global batch, draws and
weights: the loss and the gradient norm within rtol 1e-5, the gathered
gradients within 1e-5 of the largest (looser than DDP's 1e-6: the
row-parallel sums split a reduction; 50x tighter than
``tests/test_parallel.py``'s 5e-4), the updated weights as
``tests/test_torch_ar_tools.py::test_train_ar_data_parallel_over_two_processes``
holds them (within 1e-6, or 2 lr where a gradient is within the gradients'
tolerance of zero: there AdamW's first step, about lr g / (|g| + eps), turns
each side's rounding into a step of its own; that test's mask sits at its
own gradient tolerance, 1e-6, this one at 1e-5), the timestep state exactly
in its counts.
"""

import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from text_to_sound_synthesis_tpu.models.diffusion import DiscreteDiffusion as JDiffusion
from text_to_sound_synthesis_tpu.parallel import mesh as jmesh
from text_to_sound_synthesis_tpu.parallel.sharding import megatron_param_shardings
from text_to_sound_synthesis_tpu.utils import misc as jmisc
from text_to_sound_synthesis_torch.convert import from_jax
from text_to_sound_synthesis_torch.data.loader import build_dataloader
from text_to_sound_synthesis_torch.engine.clip_grad import ClipGradNorm
from text_to_sound_synthesis_torch.engine.optimizers import build_optimizer
from text_to_sound_synthesis_torch.engine.solver import Solver, base_learning_rate
from text_to_sound_synthesis_torch.engine.train_state import DiffusionTrainState, make_train_step
from text_to_sound_synthesis_torch.models import build_model
from text_to_sound_synthesis_torch.models.diffusion.backbone import (Condition2SpecTransformer,
                                                                     Text2SpecTransformer)
from text_to_sound_synthesis_torch.parallel.mesh import (batch_ranks, make_data_mesh_for_batch,
                                                         make_mesh, mesh_shape, shard_batch)
from text_to_sound_synthesis_torch.parallel.sharding import (gather_state_dict,
                                                             megatron_denoiser,
                                                             megatron_placement, shard_dims,
                                                             shard_state_dict)
from text_to_sound_synthesis_torch.tools import train_ar, train_vqgan
from text_to_sound_synthesis_torch.tools.dryrun import TINY, TINY_COND, TINY_EMB, TINY_STEPS
from text_to_sound_synthesis_torch.utils import misc
from text_to_sound_synthesis_torch.utils.config import register

from tests._torch_tiny import OPT_CFG, TP_B, TP_LR, TRAIN_CFG, tp_diffusion, tp_draws, tp_inputs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_diffusion(n_embd=128, n_head=2):
    return JDiffusion(transformer_config={"params": dict(TINY, n_embd=n_embd, n_head=n_head)},
                      content_emb_config={"params": dict(TINY_EMB, embed_dim=n_embd)},
                      diffusion_step=TINY_STEPS, auxiliary_loss_weight=5e-4)


def _init_args():
    return (jnp.zeros((1, TINY["content_seq_len"]), jnp.int32),
            jnp.zeros((1, TINY_COND, TINY["condition_dim"]), jnp.float32),
            jnp.zeros((1,), jnp.int32))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(world, tmp_path, *args):
    port, out = _free_port(), str(tmp_path / "rank")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests", "_torch_mp_worker.py"),
                               str(port), str(r), str(world), out, "tp", *args], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
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
    return [torch.load(f"{out}.{r}.pt", weights_only=False) for r in range(world)]


# -- (a) the placement against JAX's megatron_param_shardings ----------------------------------

@pytest.mark.parametrize("n_embd, model", [(128, 2), (130, 4)])
def test_placement_matches_jax(n_embd, model):
    """Each tensor's split dim (torch layout) is JAX's split axis of the same
    leaf, the (in, out) kernels transposed. At d130 over 4 the d-wide
    tensors do not divide and fall back to replicated, the MLP's 520 does."""
    jm = _jax_diffusion(n_embd)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *_init_args())
    with_path, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    # each leaf marked with its index, so the converter's names can be traced back
    markers = treedef.unflatten([np.full(s.shape, i, np.float32)
                                 for i, (_, s) in enumerate(with_path)])
    shardings = megatron_param_shardings(markers, jmesh.make_mesh(model=model))
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    paths = [jax.tree_util.keystr(kp) for kp, _ in with_path]
    sd = {k[len("transformer."):]: v for k, v in from_jax.diffusion_state_dict(markers).items()}
    port = Text2SpecTransformer(**dict(TINY, n_embd=n_embd), diffusion_step=TINY_STEPS,
                                content_emb_config={"params": dict(TINY_EMB, embed_dim=n_embd)})
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in sd.items()}
    got = megatron_placement({k: v.shape for k, v in sd.items()}, model)
    for name, arr in sd.items():
        i = int(arr.flat[0])
        axes = [a for a, s in enumerate(specs[i].spec) if s == "model"]
        want = None
        if axes:
            want = arr.ndim - 1 - axes[0] if paths[i].endswith("['kernel']") else axes[0]
        assert got[name] == want, (name, paths[i], specs[i].spec)
    split = {k for k, d in got.items() if d is not None}
    if model == 2:
        assert {"blocks.0.attn1.query.weight", "blocks.0.attn2.key.weight",
                "blocks.1.attn1.proj.weight", "blocks.0.mlp.0.weight", "blocks.0.mlp.2.weight",
                "content_emb.emb.weight", "content_emb.width_emb.weight",
                "blocks.0.ln1.emb.weight"} <= split
        assert got["blocks.0.attn1.proj.weight"] == 1 and got["blocks.0.mlp.0.weight"] == 0
    else:
        assert split == {f"blocks.{i}.mlp.{j}.weight" for i in range(2) for j in (0, 2)}
    # the storage: the placement's, plus the column-parallel biases' slices
    dims = shard_dims({k: v.shape for k, v in sd.items()}, model)
    extra = {k for k in dims if k not in split}
    assert extra == {k[:-len("weight")] + "bias" for k in split
                     if got[k] == 0 and not k.endswith("emb.weight")}
    assert all(dims[k] == 0 for k in extra)


def test_only_text2spec_splits():
    mesh = make_mesh(model=2, world_size=2, rank=0)        # a layout, no processes
    cond = Condition2SpecTransformer(class_number=4, n_layer=1, n_embd=32, n_head=2,
                                     content_seq_len=16, diffusion_step=4,
                                     content_spatial_size=(2, 8),
                                     content_emb_config={"params": dict(num_embed=8,
                                                                        embed_dim=32)})
    with pytest.raises(ValueError, match="only Text2SpecTransformer"):
        megatron_denoiser(cond, mesh)
    odd = Text2SpecTransformer(n_layer=1, n_embd=48, n_head=3, content_seq_len=16,
                               condition_dim=8, diffusion_step=4, content_spatial_size=(2, 8),
                               content_emb_config={"params": dict(num_embed=8, embed_dim=48)})
    with pytest.raises(ValueError, match="does not split 3 heads"):
        megatron_denoiser(odd, mesh)
    assert megatron_denoiser(cond, make_mesh()) is cond       # model axis 1: itself


# -- (b) the shards' round trip -------------------------------------------------------------------

def test_shards_cover_the_state_dict():
    """Without processes: the model ranks' shards, joined on their dims,
    are the whole tensors bit for bit; a gather outside a group returns
    what it is given."""
    sd = tp_diffusion().transformer.state_dict()
    dims = shard_dims({k: v.shape for k, v in sd.items()}, 2)
    parts = [shard_state_dict(sd, 2, i) for i in range(2)]
    for k, v in sd.items():
        if k in dims:
            assert parts[0][k].shape[dims[k]] * 2 == v.shape[dims[k]]
            assert torch.equal(torch.cat([p[k] for p in parts], dim=dims[k]), v), k
        else:
            assert parts[0][k] is v and parts[1][k] is v, k
    assert gather_state_dict(parts[0], dims) == parts[0]


# -- (c) the split forward on a (1, 2) group against JAX --------------------------------------

def test_split_forward_matches_jax(tmp_path):
    """log p(x0 | x_t) from JAX's weights on two gloo ranks at (1, 2),
    against JAX's ``predict_start``; the ranks' outputs bit for bit equal;
    the shards gathered back bit for bit (``shard_state_dict`` ->
    ``gather_state_dict``, and the split module's ``full_state_dict``)."""
    jm = _jax_diffusion()
    params = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(4), *_init_args()))
    sd = {k[len("transformer."):]: torch.from_numpy(np.array(v))
          for k, v in from_jax.diffusion_state_dict(params).items()}
    weights = tmp_path / "weights.pt"
    torch.save(sd, weights)
    toks, cond, t = tp_inputs()
    want = np.asarray(jax.jit(lambda p, *a: jm.apply(p, *a, method=jm.predict_start))(
        params, jnp.asarray(toks, jnp.int32), jnp.asarray(cond), jnp.asarray(t, jnp.int32)))
    reps = _run_workers(2, tmp_path, "forward", str(weights))
    assert [r["coords"] for r in reps] == [(0, 0), (0, 1)]
    for r in reps:
        assert r["round_trip"] and r["full"]
        np.testing.assert_allclose(r["logp"].numpy(), want, atol=1e-4, rtol=0)
    assert torch.equal(reps[0]["logp"], reps[1]["logp"])
    # each rank holds one head of two: the q / k / v rows, the proj columns, half of D
    sizes = reps[0]["sizes"]
    assert sizes["blocks.0.attn1.query.weight"] == (64, 128)
    assert sizes["blocks.0.attn2.key.weight"] == (64, 64)
    assert sizes["blocks.0.attn1.proj.weight"] == (128, 64)
    assert sizes["blocks.0.attn1.proj.bias"] == (128,)
    assert sizes["blocks.0.attn1.query.bias"] == (64,)
    assert sizes["content_emb.emb.weight"] == (17, 64) and sizes["to_logits.1.weight"] == (16, 128)
    # the forward's collectives: g after each proj and fc2, a gather per embedding lookup
    counts = reps[0]["counts"]
    assert counts["all_reduce"] == 3 * TINY["n_layer"]
    assert counts["all_gather"] == 1 + 2 * TINY["n_layer"]


# -- (d) one (2, 2) step against one process ---------------------------------------------------

def test_tp_dp_step_matches_one_process(tmp_path):
    """Four gloo processes at (2, 2), the denoiser split over the model axis
    and under DDP over the data axis, each data row on its rows of the
    global batch with the global draws sliced, against one process on the
    whole batch (the module docstring's tolerances); ``Lt_count`` sums to
    the global batch, not to model x it. A second step on generators seeded
    by the data index keeps each model group's draws, replicated gradients
    and weights bit for bit together."""
    reps = _run_workers(4, tmp_path, "step")
    assert [r["coords"] for r in reps] == [(0, 0), (0, 1), (1, 0), (1, 1)]

    model = tp_diffusion()
    den = model.transformer
    state = DiffusionTrainState.create(den, build_optimizer(OPT_CFG, den, TP_LR), TINY_STEPS,
                                       with_ema=False)
    step = make_train_step(model, ClipGradNorm(0, 5000, 0.5))
    toks, cond, _ = (torch.from_numpy(a) for a in tp_inputs())
    state, m = step(state, {"x0": toks.clamp(max=15), "cond": cond}, TP_LR, draws=tp_draws())

    g_max = max(float(p.grad.abs().max()) for p in den.parameters())
    for r in reps:
        np.testing.assert_allclose(float(r["loss"]), float(m.loss), rtol=1e-5)
        np.testing.assert_allclose(float(r["grad_norm"]), float(m.grad_norm), rtol=1e-5)
        assert torch.equal(r["t"], m.t)
        assert torch.equal(r["lt"][1], state.lt.Lt_count) and int(r["lt"][1].sum()) == TP_B
        torch.testing.assert_close(r["lt"][0], state.lt.Lt_history, rtol=1e-4, atol=0)
        for n, p in den.named_parameters():
            assert float((r["grads"][n] - p.grad).abs().max()) <= 1e-5 * g_max, n
            tiny = p.grad.abs() < 1e-5 * g_max     # within the gradients' own tolerance of 0
            d = (r["params"][n] - p.detach()).abs()
            assert float(torch.where(tiny, 0.0, d).max()) <= 1e-6, (n, float(d.max()))
            assert float(d.max()) <= 2 * TP_LR, n
    # a model group's replicated gradients agree, and its ranks stay in step on
    # their own draws (a generator seeded by the data index)
    for a, b in ((0, 1), (2, 3)):
        for n, g in reps[a]["rep_grads"].items():
            assert torch.equal(g, reps[b]["rep_grads"][n]), n
        assert torch.equal(reps[a]["t2"], reps[b]["t2"])
        assert all(torch.equal(v, reps[b]["rep2"][n]) for n, v in reps[a]["rep2"].items())
    assert torch.equal(reps[0]["loss2"], reps[3]["loss2"])


# -- (e) the grid's arithmetic against JAX's ----------------------------------------------------

def _jax_outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e).replace("devices", "ranks"))


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax(n):
    devices = jax.devices()[:n]
    for data in (None, 1, 2, 4):
        for model in (1, 2, 3, 4):
            want = _jax_outcome(lambda: jmesh.make_mesh(devices, data=data, model=model))
            got = _jax_outcome(lambda: mesh_shape(n, data, model))
            if isinstance(want, tuple) and want[0] == "ValueError":
                assert got == want, (n, data, model)
                with pytest.raises(ValueError):
                    make_mesh(data, model, world_size=n, rank=0)
                continue
            assert got == tuple(want.devices.shape), (n, data, model)
            for r in range(n):
                mesh = make_mesh(data, model, world_size=n, rank=r)
                where = tuple(int(i) for i in np.argwhere(want.devices == devices[r])[0])
                assert mesh.coords == where and mesh.shape == got


@pytest.mark.parametrize("n", range(1, 9))
def test_data_mesh_for_batch_matches_jax(n):
    devices = jax.devices()[:n]
    for bs in (1, 2, 3, 4, 6, 8, 12, 20):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            want = jmesh.make_data_mesh_for_batch(bs, devices).devices.size
        for r in range(n):
            with warnings.catch_warnings(record=True) as pw:
                warnings.simplefilter("always")
                mesh = make_data_mesh_for_batch(bs, world_size=n, rank=r)
            assert mesh.shape == (want, 1) and batch_ranks(bs, n) == want
            assert mesh.active == (r < want) and mesh.local_batch(bs) == bs // want
            assert [str(w.message) for w in pw] == [
                str(w.message).replace("device", "rank").replace("chip", "card") for w in jw]


def test_shard_batch_keeps_rank0_leaves():
    """A rank's rows by its data index; rank-0 leaves as they are (JAX's
    ``test_shard_batch_handles_scalar_and_rank0_leaves``)."""
    batch = {"mel": np.arange(32, dtype=np.float32).reshape(8, 4), "step": np.float32(3.0),
             "flag": 7, "t": torch.tensor(2), "x": torch.arange(8)}
    for r in range(8):
        mesh = make_mesh(data=4, model=2, world_size=8, rank=r)
        out = shard_batch(batch, mesh)
        d = r // 2
        np.testing.assert_array_equal(out["mel"], batch["mel"][2 * d:2 * d + 2])
        assert torch.equal(out["x"], torch.arange(2 * d, 2 * d + 2))
        assert out["step"] == 3.0 and out["flag"] == 7 and out["t"] is batch["t"]
    with pytest.raises(ValueError, match="not a multiple"):
        shard_batch(np.zeros((6, 2)), make_mesh(data=4, world_size=4, rank=0))
    solo = make_mesh()                      # no process group: one rank
    assert solo.shape == (1, 1) and solo.coords == (0, 0) and solo.data_group is None
    np.testing.assert_array_equal(shard_batch(batch, solo)["mel"], batch["mel"])


# -- (f) utils/misc ----------------------------------------------------------------------------

def test_misc_counts_match_jax():
    from tests.test_torch_slice import _jax_slice, _port_slice

    params = _jax_slice()[3]
    model, _ = _port_slice()
    parts = {"codec": model.codec, "cond": model.cond, "diffusion": model.diffusion.transformer}
    want = jmisc.get_model_parameters_info(params)
    assert misc.get_model_parameters_info(parts) == want
    sds = {k: v.state_dict() for k, v in parts.items()}
    assert misc.get_model_parameters_info(sds) == want
    assert misc.format_parameters_info(want) == jmisc.format_parameters_info(want)
    # one part alone: JAX iterates the tree's top level ({'params': ...}), the port the module
    assert misc.get_model_parameters_info(model.cond) == jmisc.get_model_parameters_info(
        params["cond"])
    misc.seed_everything(5)
    a = (np.random.rand(), __import__("random").random())
    jmisc.seed_everything(5)
    assert a == (np.random.rand(), __import__("random").random())
    misc.seed_everything(None)


# -- (g) the Solver's profile_dir -------------------------------------------------------------

class _Logger:
    """The Logger's surface, without TensorBoard."""

    is_primary = True

    def __init__(self, root):
        self.run_dir = str(root)
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoint")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.lines = []

    def log_info(self, msg, check_primary=True):
        self.lines.append(msg)

    def add_scalar(self, *a):
        pass


def _solver_cfg(**solver):
    from tests.test_torch_train_ckpt import SOLVER_CFG

    cfg = {k: dict(v) for k, v in SOLVER_CFG.items()}
    cfg["solver"].update(max_epochs=1, sample_iterations=0, validation_epochs=100,
                         save_top_k=0, **solver)
    return cfg


def test_profile_dir_traces_iterations_10_to_15(tmp_path):
    from text_to_sound_synthesis_torch.data.loader import ShardedLoader
    from tests.test_torch_train_ckpt import TokenDataset

    train = ShardedLoader(TokenDataset(64), 4, seed=0, num_shards=1, shard_index=0)
    prof = tmp_path / "prof"
    logger = _Logger(tmp_path / "run")
    solver = Solver(_solver_cfg(profile_dir=str(prof)), build_model(TRAIN_CFG, device="cpu",
                                                                     seed=0),
                    {"train_loader": train, "train_iterations": len(train)}, logger, seed=0)
    solver.train()
    assert solver.state.step == 16
    assert os.listdir(prof) == ["trace_it10-15.json"]
    import json

    with open(prof / "trace_it10-15.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert sum("profiler trace" in line for line in logger.lines) == 2
    # unset: nothing runs
    quiet = tmp_path / "quiet"
    solver = Solver(_solver_cfg(), build_model(TRAIN_CFG, device="cpu", seed=0),
                    {"train_loader": train, "train_iterations": len(train)},
                    _Logger(quiet), seed=0)
    solver.train()
    assert solver._profiler is None and not any("profiler" in x for x in solver.logger.lines)


# -- (h) the trainers' global batch ----------------------------------------------------------

@register("tests.test_torch_megatron.RowDataset")
class RowDataset:
    """Items of one id each (the loader's batches, nothing else)."""

    def __init__(self, n=24):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"id": i}


@pytest.mark.parametrize("world", [1, 2, 3])
def test_trainers_take_the_global_batch(world, tmp_path):
    """bs 4 at world sizes 1, 2 and 3: JAX's mesh (1, 2 and 2 devices, the
    warning at 3), each data rank's loader at 4 / data from its shard, the
    leftover rank idle, and each trainer's lr by JAX's formula with the
    world counting every rank (``solver.py:71``, ``train_vqgan.py:103``,
    ``train_ar.py:68``)."""
    bs = 4
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        n = jmesh.make_data_mesh_for_batch(bs, jax.devices()[:world]).devices.size
    assert n == (1 if world == 1 else 2) and bool(jw) == (world == 3)
    cfg = {"dataloader": {"batch_size": bs, "train_datasets": [
        {"target": "tests.test_torch_megatron.RowDataset", "params": {"n": 24}}]}}
    seen = []
    for rank in range(world):
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            mesh = make_data_mesh_for_batch(bs, world_size=world, rank=rank)
        assert bool(pw) == (world == 3) and mesh.data == n and mesh.active == (rank < n)
        loaders = build_dataloader(cfg, seed=0, mesh=mesh)
        loader = loaders["train_loader"]
        assert loader.batch_size == bs // n and loaders["train_iterations"] == 24 // bs
        if mesh.active:
            seen += [int(i) for b in loader for i in b["id"]]
        else:                               # the Solver on an idle rank takes no step
            solver = Solver(_solver_cfg(), build_model(TRAIN_CFG, device="cpu", seed=0),
                            loaders, _Logger(tmp_path / f"idle{rank}"), mesh=mesh, seed=0)
            solver.train()
            assert solver.state.step == 0 and "idle" in solver.logger.lines[-1]
    assert sorted(seen) == list(range(24))       # the data ranks cover the data once
    for adjust, scale in (("none", 1.0), ("sqrt", (world * bs) ** 0.5), ("linear", world * bs)):
        got = base_learning_rate({"base_lr": 1e-4, "adjust_lr": adjust}, bs, world)
        np.testing.assert_allclose(got, 1e-4 * scale, rtol=1e-12)
    vq = {"model": {"base_learning_rate": 1e-5}, "dataloader": {"batch_size": bs}}
    assert train_vqgan.learning_rate(vq, world) == world * bs * 1e-5
    assert train_vqgan.global_batch(vq) == bs
    ar = {"model": {"base_learning_rate": 1e-4}, "dataloader": {"batch_size": bs}}
    assert train_ar.learning_rate(ar, world) == world * bs * 1e-4
