"""Time the quantize passes on a CUDA card.

The row pass (``quant.quantize_rows``) in the six forms a request runs,
AdaLN, LN and no norm, each under a static and under a dynamic scale, at
2120 x 1024 bf16 (K4, K5 and K8's inputs, K6's at K <= 1024); the wide pass
(``quant.quantize_wide``) in four forms at 2120 x 4096: f32 with given
maxima at 4 chunks (K9's middle, K3's at 1), f32 under a static scale, bf16
with the row's own max (K6's fc2 input) and f32 with its own max. Each name
prints its device µs per call in a CUDA graph of ``ITERS`` chained calls,
the GB/s of the bytes the call must move (its input read once, its int8 rows
and maxima written once, ``mod`` and given maxima read once) and the share
of its bound, the larger of those bytes at 3.35 TB/s and its f32 work at 67
TFLOP/s (the H100 SXM's peaks). Seeded inputs: x ~ N(0, 4) bf16, the MLP
middle u ~ N(0, 9) f32, AdaLN rows N(0, 0.04), LN gamma 1 + N(0, 0.04).
Only the wrappers' public names are used, so the same file times a parent
tree too (``ab_parent.sh`` copies it there with ``AB_COPY``). Prints the
card's name and power limit first; without a card it exits nonzero.

Usage: python -m text_to_sound_synthesis_torch.tools.bench_quant [names...]
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import card_line, graph_us, require_card

M, D, DH = 2120, 1024, 4096
ITERS = 100
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
ROWS = tuple(f"rows_{norm}_{scale}" for norm in ("adaln", "ln", "none")
             for scale in ("static", "dynamic"))
WIDE = ("wide_f32_4chunks", "wide_f32_static", "wide_bf16_own", "wide_f32_own")
NAMES = ROWS + WIDE


def work(name: str) -> Tuple[int, int]:
    """(bytes, f32 operations) one call of ``name`` must move and do: a
    LayerNorm is 8 operations a value, a quantize 3 (a divide or multiply, a
    round, a max)."""
    if name in ROWS:
        _, norm, scale = name.split("_")
        nbytes = 2 * M * D + M * D + (8 * D if norm != "none" else 0)
        nbytes += 4 * M if scale == "dynamic" else 0
        return nbytes, (8 if norm != "none" else 0) * M * D + 3 * M * D
    elem = 2 if "bf16" in name else 4
    extra = {"wide_f32_4chunks": 16 * M, "wide_f32_static": 0}.get(name, 4 * M)
    return elem * M * DH + M * DH + extra, 3 * M * DH


def bound_us(name: str) -> float:
    nbytes, ops = work(name)
    return 1e6 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def calls(dev, seed: int = 1240) -> Dict[str, Callable[[], object]]:
    """name -> one call on seeded inputs."""
    from ..ops import quant

    g = torch.Generator(dev).manual_seed(seed)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    x = (rnd(M, D) * 2).bfloat16()
    mods = {"adaln": rnd(2, D, scale=0.2), "ln": rnd(2, D, scale=0.2)}
    mods["ln"][0] += 1.0
    u = rnd(M, DH, scale=3.0)
    ub = u.bfloat16()
    chunks = u.abs().reshape(M, 4, -1).amax(-1)
    out = {}
    for name in ROWS:
        _, norm, scale = name.split("_")
        s = 0.035 if scale == "static" else None
        mod = mods.get(norm)
        kw = dict(static_s=s, norm="ln" if norm == "ln" else "adaln")
        out[name] = lambda mod=mod, kw=kw: quant.quantize_rows(x, mod, **kw)
    out["wide_f32_4chunks"] = lambda: quant.quantize_wide(u, amax=chunks)
    out["wide_f32_static"] = lambda: quant.quantize_wide(u, static_s=0.03)
    out["wide_bf16_own"] = lambda: quant.quantize_wide(ub)
    out["wide_f32_own"] = lambda: quant.quantize_wide(u)
    return out


def chain(fn: Callable[[], object]) -> Callable[[], None]:
    """``ITERS`` calls of ``fn``."""
    def run():
        for _ in range(ITERS):
            fn()
    return run


def main(argv: Optional[Sequence[str]] = None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(NAMES)
    unknown = [n for n in names if n not in NAMES]
    if unknown:
        print(f"error: unknown names {unknown}; the names are {', '.join(NAMES)}", file=sys.stderr)
        return 2
    if not require_card("bench_quant"):
        return 1
    dev = torch.device("cuda")
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()})")
    fns = calls(dev)
    print(f"quantize passes: the row pass at {M} x {D} bf16, the wide pass at {M} x {DH}; "
          f"CUDA graphs of {ITERS} calls")
    with torch.no_grad():
        for name in names:
            us = graph_us(chain(fns[name]), ITERS)
            nbytes, _ = work(name)
            bound = bound_us(name)
            print(f"  {name:18s} {us:8.2f} us/call {nbytes / us / 1e3:8.1f} GB/s  bound "
                  f"{bound:6.2f} us ({100 * bound / us:5.1f} %)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
