"""Time the W8A8 dynamic engine's per-dense and MLP schedules on a CUDA card.

The launches of K6 (``quant.fused_quant_dense_multi``) at the per-dense
path's six sites of a layer, of K9 (``mlp_block_chunked`` at 4 chunks,
``mlp_block_streamed`` at 16) and of K3 under dynamic scales
(``mlp_block``), at the flagship (8 x 265 = 2120 rows, D 1024, Dh 4096, W8,
``chip_smoke.py``'s inputs): each name runs as a CUDA graph of ``ITERS``
calls and prints device µs per call and its eager µs per call (the host's
launch cost included). It uses only the wrappers' public names, so the same
file times a parent tree too (``ab_parent.sh`` copies it there). Prints the
card's name and power limit; without a card it exits nonzero.

| names | what each call runs |
|---|---|
| qkv, proj, crossq, crossproj, fc1, fc2 | K6 at that site (fc2: K = 4096 + residual) |
| layer | K6 at the six sites in turn (per call: one layer's denses) |
| k9_4, k9_16 | K9 at 4 chunks (chunked), 16 (streamed) |
| k3 | K3, W8, dynamic scales |

Usage: python -m text_to_sound_synthesis_torch.tools.bench_schedules [names...]
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from . import card_line, graph_us, require_card

M, D, DH = 2120, 1024, 4096
ITERS = 50
SITES = ("qkv", "proj", "crossq", "crossproj", "fc1", "fc2")
NAMES = SITES + ("layer", "k9_4", "k9_16", "k3")


def calls(dev, seed: int = 1238) -> Dict[str, Callable[[], object]]:
    """name -> one call on seeded inputs (x ~ N(0, 1) bf16, fc2's input N(0,
    0.25), AdaLN rows N(0, 0.04), LN gamma 1 + N(0, 0.04), W8 weights)."""
    from ..ops import int8_block as ib
    from ..ops import quant

    g = torch.Generator(dev).manual_seed(seed)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    x = rnd(M, D).bfloat16()
    h = (rnd(M, DH) * 0.5).bfloat16()
    mods = rnd(4, D, scale=0.2)
    ln = rnd(2, D, scale=0.2)
    ln[0] += 1.0
    w = lambda n, k: quant.quantize_weight(rnd(n, k, scale=0.03 * (1024 / k) ** 0.5),
                                           rnd(n, scale=0.05))
    wa = [w(D, D) for _ in range(6)]
    wm = [w(DH, D), w(D, DH)]
    multi = quant.fused_quant_dense_multi
    site = {"qkv": lambda: multi(x, wa[0:3], norm="adaln", mod=mods[0:2]),
            "proj": lambda: multi(x, wa[3:4], residual=x),
            "crossq": lambda: multi(x, wa[4:5], norm="adaln", mod=mods[2:4]),
            "crossproj": lambda: multi(x, wa[5:6], residual=x),
            "fc1": lambda: multi(x, wm[0:1], norm="ln", mod=ln, act="gelu2"),
            "fc2": lambda: multi(h, wm[1:2], residual=x)}
    return dict(site, layer=lambda: [site[s]() for s in SITES],
                k9_4=lambda: ib.mlp_block_chunked(x, ln, *wm, n_chunks=4),
                k9_16=lambda: ib.mlp_block_streamed(x, ln, *wm, n_chunks=16),
                k3=lambda: ib.mlp_block(x, ln, *wm))


def eager_us(fn: Callable[[], object], iters: int = ITERS) -> float:
    """Host-clock µs per call of ``iters`` eager calls up to a synchronize."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / iters


def main(argv: Optional[Sequence[str]] = None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(NAMES)
    unknown = [n for n in names if n not in NAMES]
    if unknown:
        print(f"error: unknown names {unknown}; the names are {', '.join(NAMES)}", file=sys.stderr)
        return 2
    if not require_card("bench_schedules"):
        return 1
    dev = torch.device("cuda")
    fns = calls(dev)
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()})")
    print(f"W8A8 dynamic schedules at {M} rows, D {D}, Dh {DH}; CUDA graphs of {ITERS} calls")
    with torch.no_grad():
        for name in names:
            fn = fns[name]

            def chain(fn=fn):
                for _ in range(ITERS):
                    fn()

            print(f"  {name:10s} {graph_us(chain, ITERS):9.1f} us/call (device)  "
                  f"{eager_us(fn):9.1f} us/call (eager)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
