"""Time the sampler kernels K1 and K2 on a CUDA card, and fingerprint K1's outputs.

K1 (``fused_sampler.fused_p_sample``) at the bf16 path's call, 8 x 265 rows
of 256 bf16 logits, with r = 0 (no threshold search) and r = 0.85; K2
(``fused_head_sample``) at the int8 engine's, 8 x 265 rows of D 1024 to
256 classes, r = 0 and 0.85, and to 512 and 2048 classes at r = 0.85; the
card's own draws. Each prints its eager µs per call (CUDA events around
``ITERS`` calls) and its device µs per call in a CUDA graph of ``ITERS``
calls. Then the sha256 digests of K1's tokens and posterior on
``chip_smoke.py``'s phase-3 inputs (f32 and bf16 logits, r 0 and 0.85,
t_post 0, 50 and 99, supplied Gumbel noise and Philox draws keyed (11, 3)):
two trees whose K1 agree bit for bit print the same digests. Only the
wrappers' public names and int keys are used, so the file runs in a parent
tree too (``ab_parent.sh`` copies it there with ``AB_COPY``).

Prints the card's name and power limit; without a card it exits nonzero.

Usage: python -m text_to_sound_synthesis_torch.tools.bench_sampler
"""

from __future__ import annotations

import argparse
import hashlib
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import card_line, graph_us, require_card

B, L, D, K, STEPS = 8, 265, 1024, 257, 100
ITERS = 200
SMOKE_SEED = 1234   # chip_smoke.py's SEED: its phase-3 inputs


def eager_us(fn: Callable[[], object], iters: int = ITERS) -> float:
    """µs per call of ``iters`` eager calls between two CUDA events, after a warm-up."""
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / iters


def cases(dev) -> Dict[str, Callable[[], object]]:
    """{label: one kernel call} at the main path's shapes, seeded inputs."""
    from ..ops import diffusion as dd
    from ..ops import fused_sampler as fs

    g = torch.Generator(dev).manual_seed(SMOKE_SEED + 2)
    out = {}
    logits = (torch.randn((B, L, K - 1), generator=g, device=dev) * 3).bfloat16()
    xt = torch.randint(0, K, (B, L), generator=g, device=dev, dtype=torch.int32)
    c = fs.step_coeffs(dd.make_schedule(STEPS, K, device=dev), 50).as_array().contiguous()
    for r in (0.0, 0.85):
        out[f"K1 {B * L} x {K - 1} bf16, r={r}"] = (
            lambda r=r: fs.fused_p_sample(logits, xt, c, 1, 2, truncation_r=r))
    x = (torch.randn((B * L, D), generator=g, device=dev) * 2).bfloat16()
    norm = torch.stack([1 + 0.1 * torch.randn(D, generator=g, device=dev),
                        0.1 * torch.randn(D, generator=g, device=dev)])
    for k, rs in ((K, (0.0, 0.85)), (513, (0.85,)), (2049, (0.85,))):
        hw = (torch.randn((D, k - 1), generator=g, device=dev) * 0.1).bfloat16()
        hb = 0.1 * torch.randn(k - 1, generator=g, device=dev)
        tok = torch.randint(0, k, (B * L,), generator=g, device=dev, dtype=torch.int32)
        ck = fs.step_coeffs(dd.make_schedule(STEPS, k, device=dev), 50).as_array().contiguous()
        for r in rs:
            out[f"K2 {B * L} x {D} -> {k - 1}, r={r}"] = (
                lambda hw=hw, hb=hb, tok=tok, ck=ck, r=r:
                fs.fused_head_sample(x, tok, norm, hw, hb, ck, 1, 2, truncation_r=r))
    return out


def k1_digests(dev) -> List[str]:
    """K1's outputs on chip_smoke.py's phase-3 inputs, one sha256 (first 16
    hex digits) per (logits dtype, r, noise) over t_post 0, 50, 99."""
    from ..ops import diffusion as dd
    from ..ops import fused_sampler as fs

    rng = np.random.default_rng(SMOKE_SEED)
    logits32 = torch.from_numpy((rng.standard_normal((B, L, K - 1)) * 3).astype(np.float32)).to(dev)
    xt = torch.from_numpy(rng.integers(0, K, (B, L)).astype(np.int32)).to(dev)
    gumbel = torch.from_numpy(rng.gumbel(size=(B, L, K)).astype(np.float32)).to(dev)
    sched = dd.make_schedule(STEPS, K, device=dev)
    lines = []
    for dtype in (torch.float32, torch.bfloat16):
        for r in (0.0, 0.85):
            for noise in ("gumbel", "philox"):
                h = hashlib.sha256()
                for t_post in (0, 50, 99):
                    c = fs.step_coeffs(sched, t_post).as_array().contiguous()
                    tok, post = fs.fused_p_sample(logits32.to(dtype), xt, c, 11, 3, truncation_r=r,
                                                  gumbel=gumbel if noise == "gumbel" else None,
                                                  return_log_probs=True)
                    h.update(tok.cpu().numpy().tobytes())
                    h.update(post.cpu().numpy().tobytes())
                lines.append(f"{str(dtype)[6:]:8s} r={r:<4} {noise:6s} {h.hexdigest()[:16]}")
    return lines


def report(dev, tag: str) -> None:
    print(f"[{tag}] µs per call: eager (events, {ITERS} calls) / CUDA graph of {ITERS} calls")
    with torch.no_grad():
        for label, fn in cases(dev).items():
            try:
                fn()
            except ValueError as e:   # a parent tree's K2 took at most 543 classes
                print(f"  {label:32s} refused: {e}")
                continue
            graph = graph_us(lambda: [fn() for _ in range(ITERS)], ITERS)
            print(f"  {label:32s} {eager_us(fn):8.2f} / {graph:8.2f}")
        digests = k1_digests(dev)
    print(f"[{tag}] K1 digests (tokens + posterior, phase-3 inputs):")
    for line in digests:
        print(f"  {line}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not require_card("bench_sampler"):
        return 1
    dev = torch.device("cuda")
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()})")
    report(dev, "K1, K2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
