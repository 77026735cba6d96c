#!/usr/bin/env python3
"""Profile one warm request of each path of the PyTorch port on a CUDA card.

    python3 chip_profile.py

Builds the flagship model as ``chip_smoke.py`` does (seeded random weights,
bf16, batch 8, 100 steps, ``top0.85r``), then for the bf16 path
(``generate``), the W4A8 static-scale engine (``quantize_for_serving(4)``
-> ``calibrate_serving_engine`` -> ``generate_int8``) and the W8A8 dynamic
engine (``quantize_for_serving()``) on its block path and on its per-dense
path (``generate_int8(impl="pallas_dense")``), the W4A8 engine with the int8
MHA (``T2S_ATTN_INT8=1 T2S_ATTN_MHA=base``) and the W4A8 engine's long-form
request (``generate_long``, 2120 frames, 24 sampler rows): one warm-up request,
one unprofiled request (host clock up to a synchronize), then one request
under ``torch.profiler``. The vocoder is left out. Then K11, which no request
runs, the same way: five ``gn_swish_conv`` calls at each of the flagship
decoder's five stages (its A/B tool's inputs), to split its time between its
launches (a single short call left the profiler without device rows on
three stages of five on the H100). Prints the card line, each path's request (or call) time, its
device time and idle share (1 - device time / unprofiled time), and the
kernels by device time. Exits 1 without a CUDA card. Imports nothing of JAX.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

import chip_smoke as cs


def profile(name: str, run, what: str = "request without the vocoder") -> None:
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # kernel rows only: an aten op's row repeats the time of the kernels it launched
    device_ms = sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 1e3
    print(f"[{name}] {what} {wall:.4f} s; device time {device_ms:.3f} ms; "
          f"idle share {1 - device_ms / (wall * 1e3):.3f}")
    print(ka.table(sort_by="self_device_time_total", row_limit=16, max_name_column_width=90))


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA card visible to torch", file=sys.stderr)
        return 1
    from text_to_sound_synthesis_torch.models import build_model
    from text_to_sound_synthesis_torch.utils.config import load_yaml_config

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    cfg = load_yaml_config(cs.CONFIG)
    cfg["model"]["params"]["dtype"] = "bfloat16"
    model = build_model(cfg, device=dev, seed=cs.SEED)
    cond = cs.caption_ids(np.random.default_rng(cs.SEED)).to(dev)
    gen = lambda: torch.Generator(dev).manual_seed(cs.SEED)
    profile("bf16", lambda: model.generate(gen(), cond, sample_type="top0.85r"))
    qp = model.quantize_for_serving(weight_bits=4)
    model.calibrate_serving_engine(qp, gen(), cond)
    profile("W4A8 static", lambda: model.generate_int8(qp, gen(), cond, sample_type="top0.85r"))
    qp8 = model.quantize_for_serving()
    for impl in ("pallas", "pallas_dense"):
        profile(f"W8A8 dynamic {impl}",
                lambda: model.generate_int8(qp8, gen(), cond, sample_type="top0.85r", impl=impl))
    with cs.switches(T2S_ATTN_INT8="1", T2S_ATTN_MHA="base"):
        profile("W4A8 static, int8 MHA",
                lambda: model.generate_int8(qp, gen(), cond, sample_type="top0.85r"))
    profile(f"W4A8 static generate_long, {cs.LONG_FRAMES} frames",
            lambda: model.generate_long(gen(), cond, duration_frames=cs.LONG_FRAMES, qp=qp))

    from text_to_sound_synthesis_torch.ops.fused_gn_conv import gn_swish_conv
    from text_to_sound_synthesis_torch.tools import bench_gn_conv as gnt

    with torch.no_grad():
        for H, W, C in gnt.SHAPES:
            args = gnt.stage_inputs(H, W, C, dev)
            profile(f"K11 gn_swish_conv at ({gnt.B}, {H}, {W}, {C})",
                    lambda: [gn_swish_conv(*args, groups=gnt.GROUPS) for _ in range(5)],
                    what="five calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
