"""The port's A/B tools, run on a CUDA card as modules:

    python -m text_to_sound_synthesis_torch.tools.bench_gn_conv [repeats] [shape_idx...]
    python -m text_to_sound_synthesis_torch.tools.bench_kernel_dot [iters]
    python -m text_to_sound_synthesis_torch.tools.bench_mlp_ablate [names...]
    python -m text_to_sound_synthesis_torch.tools.bench_attn_ablate [names...]
    python -m text_to_sound_synthesis_torch.tools.bench_schedules [names...]
    python -m text_to_sound_synthesis_torch.tools.bench_mha [names...]
    python -m text_to_sound_synthesis_torch.tools.bench_sampler
    python -m text_to_sound_synthesis_torch.tools.bench_quant [names...]

Ports of ``tools/bench_gn_conv.py`` (K11 against the plain composition),
``tools/bench_kernel_dot.py`` (T1, the bare dot rate) and
``tools/bench_mlp_ablate.py`` / ``bench_attn_ablate.py`` (T2 / T3, the MLP
and self-attention blocks with one stage taken out); ``bench_schedules``
times the W8 engine's K6 sites and MLP blocks (K3, K9), ``bench_mha`` the
MHAs (K7, the pair MHA, K10) alone and between K3's calls, ``bench_sampler``
the sampler kernels (K1, K2) with K1's output digests, ``bench_quant`` the
quantize passes (the row pass's six forms, the wide pass's four). Without a
card they exit nonzero; they do not run on the CPU. Helpers they share live
here.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable

import torch

__all__ = ["card_line", "graph_us", "require_card"]


def require_card(tool: str) -> bool:
    """True on a machine with a CUDA card; else says so on stderr."""
    if torch.cuda.is_available():
        return True
    print(f"error: {tool} measures the CUDA kernels and needs a CUDA card; none is visible to "
          "torch", file=sys.stderr)
    return False


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_us(fn: Callable[[], object], calls: int, replays: int = 5) -> float:
    """Device time per call in µs: ``fn``, which makes ``calls`` calls, is
    captured once in a CUDA graph (after three warm runs on a side stream)
    and replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / (calls * replays)
