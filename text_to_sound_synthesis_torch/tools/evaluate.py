"""Fidelity evaluation CLI: FID / ISc / KID / KL on Melception features.

Port of the JAX package's ``tools/evaluate.py``. Parity target:
``Codebook/evaluate.py`` (OmegaConf CLI ``key=value`` overrides; config schema
of ``evaluation/configs/eval_melception_caps.yaml``). Compares a directory of
generated ``.npy`` mels against ground-truth mels.

Usage:
  python -m text_to_sound_synthesis_torch.tools.evaluate \\
      input1.path=samples/ input2.path=gt_mels/ \\
      melception_ckpt=melception-21-05-10T09-28-40.pt \\
      [config=configs/eval_melception_audiocaps.yaml] \\
      [stats=melception_means_stds.txt] [dataset=caps] [batch=16] [device=cpu]

``melception_ckpt`` is the released torch file (``{"model": state_dict}``
under torchvision's Inception3 names), loaded as it is. Without it the
weights are random (seeded), and the metrics are not comparable. The model
runs on the card unless ``device=cpu``.
"""

from __future__ import annotations

import sys

import numpy as np


def parse_cli(argv):
    cfg = {
        "config": None,
        "input1.path": None, "input2.path": None, "melception_ckpt": None,
        "stats": None, "dataset": "caps", "batch": 16, "num_classes": 309,
        "have_fid": True, "have_isc": True, "have_kid": True, "have_kl": True,
        "kid_subset_size": 1000, "device": "cuda",
    }

    def set_key(k, v):
        if k not in cfg:
            raise SystemExit(f"unknown key {k!r}; known: {sorted(cfg)}")
        cur = cfg[k]
        if isinstance(cur, bool) and isinstance(v, str):
            v = v.lower() in ("1", "true", "yes")
        elif isinstance(cur, int) and not isinstance(cur, bool) and isinstance(v, str):
            v = int(v)
        cfg[k] = v

    pairs = []
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}")
        pairs.append(arg.split("=", 1))
    # a config file (eval_melception_caps.yaml-style) seeds the defaults;
    # explicit CLI keys override it (reference: evaluate.py:27-44 CLI patching)
    for k, v in pairs:
        if k == "config":
            from ..utils.config import load_yaml_config

            for fk, fv in load_yaml_config(v).items():
                if fk != "config" and fv is not None:
                    set_key(fk, fv)
    for k, v in pairs:
        if k != "config":
            set_key(k, v)
    return cfg


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    if not cfg["input1.path"] or not cfg["input2.path"]:
        raise SystemExit("input1.path and input2.path are required")

    import torch

    from ..evaluation.features import evaluate_folders
    from ..models.melception import Melception, load_melception_checkpoint
    from ..parallel.distributed import local_device
    from ..utils.init import init_random_

    device = local_device(cfg["device"])
    with torch.device(device):
        model = Melception(num_classes=cfg["num_classes"])
    init_random_(model, torch.Generator(device).manual_seed(0))
    if cfg["melception_ckpt"]:
        load_melception_checkpoint(model, cfg["melception_ckpt"])
    else:
        print("WARNING: random Melception weights — metrics are NOT comparable",
              file=sys.stderr)

    means = stds = None
    if cfg["stats"]:
        means, stds = np.loadtxt(cfg["stats"], dtype=np.float32).T

    out = evaluate_folders(
        model, cfg["input1.path"], cfg["input2.path"],
        dataset_name=cfg["dataset"], batch_size=cfg["batch"], means=means, stds=stds,
        have_fid=cfg["have_fid"], have_isc=cfg["have_isc"],
        have_kid=cfg["have_kid"], have_kl=cfg["have_kl"],
        kid_subset_size=cfg["kid_subset_size"],
    )
    for k, v in out.items():
        print(f"{k}: {v:.6f}")
    return out


if __name__ == "__main__":
    main()
