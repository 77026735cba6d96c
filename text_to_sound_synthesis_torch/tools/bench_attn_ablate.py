"""Ablate the int8 self-attention block (K4) on a CUDA card, to locate its time.

Port of ``tools/bench_attn_ablate.py``: the JAX tool's names and defaults at
B, Lp, D, H = 8, 272, 1024, 16, run padded as the JAX tool runs them: 272
rows per batch element, the last 7 real random queries whose keys are
masked (``q_valid`` = 265; K4 takes 272 keys and masks by ``q_valid`` only).
bf16 x ~ N(0, 1), AdaLN rows [ones; zeros], four W8 weights from N(0, 0.02).
Each name runs as a CUDA graph of ``ITERS`` chained calls, the output
feeding the next call's input, and prints device µs per call and
TOPS-equivalent (the 8 B Lp D^2 operations of the four dots). What each
name runs on this card:

| names | what it computes | runs |
|---|---|---|
| qkvp_dots_only, no_softmax, no_av, no_scores | K4 with one stage out (``make_variant``; ``ops/attn_ablate.py``) | T3: its configuration of K4's launches |
| pair_both, rows{n}[_static]_pair[...], rows{n}[_static]_pairdeq[...] | K4 with the pair-packed MHA | T3: K4's launches, ``attn="pair"`` |
| pair_nofold | the pair-packed MHA, p divided before its rounding | T3: K4's launches, that MHA |
| full, lib_base, lib_static, group16, group4, dots_first, pair_qmask, rows{n}[_static][_qmask][_v<MB>], qkv_fused[_static], any other name | K4 (per-row softmax; query-side masks and head groups are the same function up to the order of f32 sums) | schedule-only on this card: K4 |

``_static`` means static scales (0.05, 0.05). ``qkv_fused``'s one (D, 3D)
dot is what K4's q/k/v launch already is on this card: one GEMM launch for
the three weights, after the quantize pass. The JAX tool's ``no_scores`` raises for more
than one head per softmax group (a broadcast that only fits one); this runs
what it computes at one. Prints the card's name and power limit; without a
card it exits nonzero.

Usage: python -m text_to_sound_synthesis_torch.tools.bench_attn_ablate [names...]
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import card_line, graph_us, require_card
from .bench_mlp_ablate import chained_us

B, Lp, D, H = 8, 272, 1024, 16
M = B * Lp
Q_VALID = Lp - 7
ITERS = 100
DEFAULTS = ["full", "qkvp_dots_only", "no_softmax", "no_av", "no_scores"]
STATIC = (0.05, 0.05)


def inputs(dev, seed: int = 0):
    """x (M, D) bf16, mod (2, D) = [ones; zeros], four W8 (D, D) weights."""
    from ..ops.quant import quantize_weight

    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((M, D), generator=g, device=dev).bfloat16()
    mod = torch.stack([torch.ones(D, device=dev), torch.zeros(D, device=dev)])
    ws = [quantize_weight(torch.randn((D, D), generator=g, device=dev) * 0.02) for _ in range(4)]
    return x, mod, ws


def variant(name: str, mod, ws) -> Tuple[Callable, Callable, str]:
    """(call, its plain twin, what runs) of ``name``: each call maps x to the
    next x."""
    from ..ops import attn_ablate as T3
    from ..ops import int8_block as ib

    parts = name.split("_")
    rows = name.startswith("rows")
    ss = STATIC if (rows or name.startswith("qkv_fused") or name == "lib_static") and \
        "static" in parts else None
    kw = dict(batch=B, n_head=H, q_valid=Q_VALID, static_s=ss)
    t3 = {"pair_both": "pair", "pair_nofold": "pair_nofold"}.get(name, name)
    if rows and ("pair" in parts or "pairdeq" in parts):
        t3 = "pair"
    if t3 in T3.FUNCTIONS:
        return (lambda x: T3.attn_variant(x, mod, *ws, variant=t3, **kw),
                lambda x: T3.attn_variant_reference(x, mod, *ws, variant=t3, **kw),
                f"T3, its configuration of K4's launches ({t3})")
    known = name in ("full", "lib_base", "lib_static", "group16", "group4", "dots_first",
                     "pair_qmask", "qkv_fused", "qkv_fused_static") or rows
    return (lambda x: ib.self_attn_block(x, mod, *ws, **kw),
            lambda x: ib.self_attn_block_reference(x, mod, *ws, **kw),
            "schedule-only on this card: runs K4" + ("" if known else
                                                   " (the JAX tool's default for this name)"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not require_card("bench_attn_ablate"):
        return 1
    dev = torch.device("cuda")
    x, mod, ws = inputs(dev)
    ops = 8.0 * M * D * D
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()})")
    print(f"self-attn block B={B} Lp={Lp} D={D} H={H}, {Q_VALID} valid keys, W8, {ITERS} "
          "chained calls per CUDA graph")
    for name in argv or DEFAULTS:
        call, _, what = variant(name, mod, ws)
        us = chained_us(call, x, ITERS)
        print(f"  {name:20s} {us:8.1f} us/iter (device)  {ops / us / 1e6:6.1f} TOPS-equiv   "
              f"[{what}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
