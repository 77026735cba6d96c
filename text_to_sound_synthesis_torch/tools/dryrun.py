"""Dry-run entry points of the port: a one-card compile check and a
multi-process dry run over a (data, model) mesh.

    python -m text_to_sound_synthesis_torch.tools.dryrun [N] [--device cuda|cpu]

The port of the JAX package's root ``entry`` / ``dryrun_multichip``:

``entry(device="cuda")`` -> ``(fn, args)``: the flagship denoiser's
``predict_start`` (``configs/diffsound_audiocaps.yaml``: 19 layers of d1024,
16 heads, 265 tokens, a (1, 77, 512) condition, 100 steps), its weights
seeded and stored in bf16, its inputs on ``device``; ``fn(*args)`` gives
log p(x0 | x_t), (1, 265, 257). ``tiny=True`` builds the dry run's small
geometry instead (a CPU check).

``dryrun_multichip(n, device="cuda")`` starts ``n`` processes, one a card
(NCCL; gloo with ``device="cpu"``, all on the host), in a group at
``tcp://localhost:<free port>``, laid out as JAX's mesh: (n/2, 2) when n is
even and above 1, else (n, 1) (``parallel.mesh.make_mesh``), with a global
batch of 2 x (n / model). Each rank runs one whole Stage-2 train step of a
small denoiser on its data row's share of the batch: the denoiser split
over the model axis (Megatron, ``parallel.sharding.MegatronText2Spec``) and
under DDP over the data group, the timestep importance sampler and the
q-sample noise drawn from a generator seeded by the data index (so a model
group draws alike), the VLB loss, the OR-ed gradient clip (the whole
model's norm), AdamW with the kernel-only decay mask, the ``Lt`` update on
the data group's timesteps and losses. Then ``gather_state_dict`` gives the
whole weights, and both data-parallel samplers run over the data group from
a bf16 copy: the fused one (``sample_tokens_fused_sharded``, K1 on a card)
and the int8 serving engine's (``sample_tokens_int8_sharded``, W8A8 with
dynamic scales, its block kernels on a card). It checks the loss is finite,
``Lt_count`` sums to the global batch, the ranks of a model group hold the
same replicated weights after the step and draw the same tokens bit for
bit, and JAX's token checks: the shapes, every token a code, no MASK left.
Any failure in a rank fails the run.

The small geometry is the JAX dry run's, widened so that the serving
kernels take it (d128, 2 heads of 64, a condition of 64): at a model axis
of 2 each rank holds one head.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FLAGSHIP_CONFIG = os.path.join(REPO, "configs", "diffsound_audiocaps.yaml")
# the small denoiser: 2 layers of d128, 2 heads of 64, 16 tokens of 16 codes + MASK, 4 steps
TINY = dict(n_layer=2, n_embd=128, n_head=2, content_seq_len=16, condition_dim=64,
            content_spatial_size=(2, 8))
TINY_EMB = dict(num_embed=16, embed_dim=128, spatial_size=(2, 8))
TINY_STEPS, TINY_COND = 4, 8


def diffusion_params(tiny: bool) -> dict:
    """``DiscreteDiffusion``'s arguments: ``FLAGSHIP_CONFIG``'s
    ``diffusion_config``, or the small denoiser's."""
    if tiny:
        return dict(transformer_config={"params": TINY}, content_emb_config={"params": TINY_EMB},
                    diffusion_step=TINY_STEPS, auxiliary_loss_weight=5e-4)
    from ..utils.config import load_yaml_config

    return dict(load_yaml_config(FLAGSHIP_CONFIG)["model"]["params"]["diffusion_config"]["params"])


def build_diffusion(tiny: bool, device, seed: int = 0):
    """The flagship or the small denoiser + schedule (``diffusion_params``) on
    ``device``, seeded as the JAX package's init."""
    from ..models.diffusion.process import DiscreteDiffusion
    from ..utils.init import init_random_

    with torch.device("meta"):
        model = DiscreteDiffusion(**diffusion_params(tiny))
    model = model.to_empty(device=device)
    init_random_(model, torch.Generator(device).manual_seed(seed))
    return model.eval()


def entry(device="cuda", tiny: bool = False):
    """``(fn, args)``: ``fn(*args)`` is the denoiser's ``predict_start`` in
    bf16 on batch 1 (module docstring)."""
    from ..parallel.distributed import local_device

    device = local_device(device)
    params = diffusion_params(tiny)
    model = build_diffusion(tiny, device).to(torch.bfloat16)
    L = model.content_seq_len
    tcfg = params["transformer_config"]["params"]
    S, D = TINY_COND if tiny else tcfg["condition_seq_len"], tcfg["condition_dim"]
    g = torch.Generator(device).manual_seed(1)
    tokens = torch.zeros((1, L), dtype=torch.long, device=device)
    cond = torch.randn((1, S, D), generator=g, device=device)
    cond = cond / cond.norm(dim=-1, keepdim=True)
    t = torch.zeros((1,), dtype=torch.long, device=device)

    @torch.no_grad()
    def fn(model, tokens, cond, t):
        return model.predict_start(tokens, cond, t)

    return fn, (model, tokens, cond, t)


def _rank(rank: int, world: int, port: int, device_type: str, errors) -> None:
    """One rank of ``dryrun_multichip``; a failure goes to ``errors``."""
    import copy

    import torch.distributed as dist

    try:
        from ..engine.clip_grad import ClipGradNorm
        from ..engine.optimizers import build_optimizer
        from ..engine.train_state import DiffusionTrainState, make_train_step
        from ..models.diffusion.int8_runtime import quantize_denoiser, sample_tokens_int8_sharded
        from ..models.diffusion.process import sample_tokens_fused_sharded
        from ..parallel.distributed import init_distributed, same_across, wrap_ddp
        from ..parallel.mesh import make_mesh, shard_batch
        from ..parallel.sharding import megatron_denoiser

        torch.set_num_threads(1)
        device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed(device, init_method=f"tcp://localhost:{port}", rank=rank,
                         world_size=world)
        mesh = make_mesh(model=2 if world % 2 == 0 and world > 1 else 1)
        model = build_diffusion(True, device)
        T, L, K = model.diffusion_step, model.content_seq_len, model.num_classes
        B = 2 * mesh.data           # the global batch, JAX's 2 * (n // model)
        rng = np.random.default_rng(0)
        batch = {"x0": torch.from_numpy(rng.integers(0, K - 1, (B, L))).to(device),
                 "cond": torch.from_numpy(rng.standard_normal((B, TINY_COND, TINY["condition_dim"]))
                                          .astype(np.float32)).to(device)}

        # one Stage-2 train step: the denoiser split over the model axis, DDP over the data axis
        den = megatron_denoiser(model.transformer, mesh)
        optimizer = build_optimizer({"target": "adamw", "params": {"weight_decay": 0.045}}, den,
                                    1e-4)
        state = DiffusionTrainState.create(den, optimizer, T, with_ema=False)
        step = make_train_step(model, ClipGradNorm(0, 5000, 0.5),
                               ddp=wrap_ddp(den, device, mesh.data_group), mesh=mesh)
        generator = torch.Generator(device).manual_seed(1 + mesh.data_index)
        state, metrics = step(state, shard_batch(batch, mesh), 1e-4, generator=generator)
        loss = float(metrics.loss)
        if not np.isfinite(loss) or int(state.lt.Lt_count.sum()) != B:
            raise AssertionError(f"loss {loss}, visits {state.lt.Lt_count.tolist()}")
        if mesh.model > 1:
            replicated = [p.detach().reshape(-1) for n, p in den.named_parameters()
                          if n not in den.split_dims]
            if not same_across(torch.cat(replicated), mesh.model_group):
                raise AssertionError("a model group's replicated weights differ after the step")
            whole = den.full_state_dict()
        else:
            whole = den.state_dict()

        # both data-parallel samplers over the data group, from the whole weights in bf16
        serve = copy.deepcopy(model)
        serve.transformer.load_state_dict(whole)
        serve = serve.to(torch.bfloat16).eval()
        cond_gen = torch.from_numpy(rng.standard_normal((B, TINY_COND, TINY["condition_dim"]))
                                    .astype(np.float32)).to(device, torch.bfloat16)
        with torch.no_grad():
            toks_fp = sample_tokens_fused_sharded(serve, cond_gen, seed=2, group=mesh.data_group,
                                                  truncation_r=0.85, skip_step=2)
            qp = quantize_denoiser(serve, n_head=TINY["n_head"], seq_len=L, num_timesteps=T)
            toks_q = sample_tokens_int8_sharded(qp, serve.schedule(device), cond_gen, seed=3,
                                                group=mesh.data_group, truncation_r=0.85)
        for name, toks in (("fused", toks_fp), ("int8", toks_q)):
            if tuple(toks.shape) != (B, L):
                raise AssertionError(f"{name}: tokens {tuple(toks.shape)}")
            if not bool(((toks >= 0) & (toks < K - 1)).all()):
                raise AssertionError(f"{name}: a token outside the codes (MASK is {K - 1})")
            if mesh.model > 1 and not same_across(toks, mesh.model_group):
                raise AssertionError(f"{name}: a model group's tokens differ")
        if rank == 0:
            print(f"dryrun_multichip OK: mesh {mesh.shape} of {world} rank(s) on {device_type} "
                  f"({dist.get_backend()}), batch {B}, loss {loss:.4f}, "
                  f"sampling (fused + int8) OK", flush=True)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:      # noqa: BLE001 - reported to the parent, which fails the run
        errors.put(f"rank {rank}:\n{traceback.format_exc()}")
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One train step on JAX's (data, model) mesh and both sharded samplers
    on ``n_devices`` processes (module docstring); raises if any rank fails."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card visible to torch; pass device='cpu' to run on the CPU")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, n_devices, port, device_type, errors))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    msgs, deadline = [], time.monotonic() + 600
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        for p in procs:
            p.join(timeout=1)
        while not errors.empty():        # drained before the joins end
            msgs.append(errors.get())
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    while not errors.empty():
        msgs.append(errors.get())
    if msgs or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"dryrun_multichip: exit codes {[p.exitcode for p in procs]}\n"
                           + "\n".join(msgs))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="dry-run entry points (PyTorch port)")
    p.add_argument("n", nargs="?", type=int, default=None,
                   help="processes (default: every card; 2 on the CPU)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA card visible to torch; pass --device cpu", file=sys.stderr)
        return 1
    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 2)
    fn, fargs = entry(args.device, tiny=args.device == "cpu")
    out = fn(*fargs)
    print(f"entry: predict_start {tuple(out.shape)} {out.dtype}, finite "
          f"{bool(torch.isfinite(out).all())}")
    dryrun_multichip(n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
