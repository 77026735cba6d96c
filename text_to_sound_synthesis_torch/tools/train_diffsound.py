"""Stage-2 Diffsound training CLI of the port.

    python -m text_to_sound_synthesis_torch.tools.train_diffsound \\
        --config_file configs/diffsound_audiocaps.yaml --name run1 --output OUTPUT \\
        [--load_path released.pth] [--auto_resume] [--resume_name NAME_OR_FILE] \\
        [--seed 0] [--debug] [--device cuda] [key value ...]
    torchrun --nproc_per_node N -m text_to_sound_synthesis_torch.tools.train_diffsound ...

The port of ``tools/train_diffsound.py`` (reference ``Diffsound/train_spec.py``),
with its flags; the trailing ``key value`` pairs override the config. One
process per card: under ``torchrun`` each process joins the NCCL group and
takes the card ``LOCAL_RANK`` names (``parallel.init_distributed``). The
config's ``batch_size`` is the global batch, as the JAX tool's: the Solver
lays the ranks out as its data mesh (``parallel.mesh.make_data_mesh_for_batch``:
the largest rank count that divides it; the others idle, with a warning),
each data rank loads batch / data samples a step (``build_dataloader``), and
the lr policy scales by the world size x that batch. ``--device`` defaults
to the card and refuses to run without one; ``--device cpu`` trains on the
CPU (gloo between processes).

``--load_path`` warm-starts from a released reference ``.pth`` (the EMA
weights of the denoiser where the file has them, as the JAX tool does)
with a fresh optimizer; ``--auto_resume`` resumes the run's newest
checkpoint, ``--resume_name`` a named one of the run or a checkpoint file
(the port's or the reference's layout).
"""

from __future__ import annotations

import argparse
import os
import sys


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Diffsound Stage-2 training (PyTorch port)")
    p.add_argument("--config_file", type=str, required=True)
    p.add_argument("--name", type=str, default="diffsound")
    p.add_argument("--output", type=str, default="OUTPUT")
    p.add_argument("--load_path", type=str, default=None,
                   help="released reference .pth to warm-start from")
    p.add_argument("--auto_resume", action="store_true")
    p.add_argument("--resume_name", type=str, default=None,
                   help="a checkpoint name of the run, or a checkpoint file")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; this process's card under torchrun) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER,
                   help="config overrides: key value [key value ...]")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = get_args(argv)
    import torch.distributed as dist

    from ..data.loader import build_dataloader
    from ..engine.checkpoint import load_checkpoint, load_weights
    from ..engine.logger import Logger
    from ..engine.solver import Solver
    from ..models.diffsound import build_model
    from ..parallel.distributed import init_distributed, local_device
    from ..utils.config import load_yaml_config, merge_opts_to_config, modify_config_for_debug

    device = local_device(args.device)
    if "RANK" in os.environ:     # started by torchrun
        init_distributed(device)
    try:
        config = load_yaml_config(args.config_file)
        config = merge_opts_to_config(config, args.opts)
        if args.debug:
            config = modify_config_for_debug(config)
        logger = Logger(args.output, args.name)
        logger.save_config(config)
        logger.log_info(f"building model from {args.config_file} on {device}")
        model = build_model(config, device=device, seed=args.seed)
        if args.load_path:
            logger.log_info(f"warm start from {args.load_path}")
            load_weights(model, load_checkpoint(args.load_path))
        solver = Solver(config, model, build_dataloader(config, seed=args.seed), logger,
                        seed=args.seed)
        if args.resume_name and os.path.isfile(args.resume_name):
            solver.resume(path=args.resume_name)
        elif args.auto_resume or args.resume_name:
            solver.resume(args.resume_name)
        solver.train()
        logger.close()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
