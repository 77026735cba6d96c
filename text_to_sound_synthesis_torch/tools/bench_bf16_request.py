"""The bf16 request's time and memory on a CUDA card.

    python -m text_to_sound_synthesis_torch.tools.bench_bf16_request
    cd OTHER_TREE && python PATH/TO/bench_bf16_request.py    # another tree's package

The flagship (``configs/diffsound_audiocaps.yaml``: 19 layers of d1024, 100
steps) with ``dtype: bfloat16`` and random weights from seed 0 serves batch-8
requests of random caption BPE ids through ``generate`` (``top0.85r``, the
fused sampler). Where the model keeps f32 weights, three ways to serve it
are timed in one process, one warm request each, then ``ROUNDS`` rounds of
one request each in turn, the order reversed every other round:

- ``kept``: the model as built, its bf16 copies kept across requests;
- ``cast``: the same model with its copies dropped before each request
  (``model.dtype = model.dtype``), a cast of every weight at each request;
- ``stored``: a copy stored in bf16 (``.to(model.dtype)``), the weights and
  ops of a model that stores bf16 weights.

Where the model stores bf16 weights (an older tree), it alone is timed, as
``stored``. Each request is timed on the host clock up to a synchronize.

Prints one JSON line: each way's median request and its rounds; the
weights' memory, the copies kept after the warm request, each way's peak
over what was allocated before its requests; the card's name and power
limit. It reads only ``build_model``, ``generate`` and ``dtype``, and
imports the package of its working directory, so the same file measures an
older tree run from that tree's root. Without a card it exits nonzero.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROUNDS = 10
GIB = 2 ** 30


def main() -> int:
    if not torch.cuda.is_available():
        print("error: bench_bf16_request needs a CUDA card; none is visible to torch",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = load_yaml_config(os.path.join("configs", "diffsound_audiocaps.yaml"))
    cfg["model"]["params"]["dtype"] = "bfloat16"
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    out = {"tree": os.getcwd(), "weights_gib": torch.cuda.memory_allocated() / GIB}
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 49407, (8, 77))).to(dev)

    def drop_copies():
        model.dtype = model.dtype

    if next(model.parameters()).dtype == torch.float32:
        ways = {"kept": (model, None), "cast": (model, drop_copies)}
    else:
        ways = {"stored": (model, None)}

    def request(name, seed):
        served, before = ways[name]
        if before is not None:
            before()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mel = served.generate(torch.Generator(dev).manual_seed(seed), ids, sample_type="top0.85r")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not bool(torch.isfinite(mel.float()).all()) or tuple(mel.shape) != (8, 80, 848, 1):
            raise RuntimeError(f"{name}: the request gave {tuple(mel.shape)}, finite "
                               f"{bool(torch.isfinite(mel.float()).all())}")
        return secs, (torch.cuda.max_memory_allocated() - base) / GIB

    request(next(iter(ways)), 0)
    out["kept_copies_gib"] = torch.cuda.memory_allocated() / GIB - out["weights_gib"]
    if "kept" in ways:
        drop_copies()     # not into the copy
        ways["stored"] = (copy.deepcopy(model).to(model.dtype), None)
        for name in ways:
            request(name, 0)
    secs = {name: [] for name in ways}
    peak = {name: 0.0 for name in ways}
    for r in range(ROUNDS):
        for name in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            s, p = request(name, 1 + r)
            secs[name].append(s)
            peak[name] = max(peak[name], p)
    out.update({name: {"request_s": float(np.median(v)), "rounds": v, "peak_gib": peak[name]}
                for name, v in secs.items()})
    out["card"] = card
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
