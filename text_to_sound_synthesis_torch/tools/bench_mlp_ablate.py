"""Ablate the int8 MLP block (K3) on a CUDA card, to locate its time.

Port of ``tools/bench_mlp_ablate.py``: the JAX tool's names and defaults at M,
D, DH = 2176, 1024, 4096 (bf16 x ~ N(0, 1), LayerNorm gamma 1 and beta 0, W8
weights from N(0, 0.02)). Each name runs as a CUDA graph of ``ITERS``
chained calls, the output feeding the next call's input as the JAX tool's
``lax.scan`` carries it, and prints device µs per call and TOPS-equivalent
(2 M D DH 2 operations per call). What each name runs on this card:

| names | what it computes | runs |
|---|---|---|
| dots_only, no_prologue, ln_onepass, no_gelu, no_quant_mid, no_deq_mid, mid_bf16, mid_bf16b, mid_bf16c, fast_sigmoid | K3 with one stage out or changed (``ops/mlp_ablate.py``) | T2: its configuration of K3's two launches |
| w4[_static][_scratch][_i32][_b<block_m>] | K3 on round(w / 16) packed to W4, the W8 scales kept (``make_w4``) | K3's W4 path on those bytes; scratch, i32 and b are TPU schedules |
| full, lib_base, lib_static, any other name | K3 (``make_variant``'s default) | schedule-only on this card: K3 |
| lib_chunked[_static], skew{n}[_static][_b<m>], ctrl{n}[...], streamed[_static][_c<n>][_b<m>] | K3 with the hidden dimension in n chunks, per-chunk row scales (``make_skewed``, ``mlp_block_chunked`` / ``_streamed``) | schedule-only on this card: K9 |

``_static`` means static scales (0.05, 0.05). Beside ``dots_only`` it times
``torch._int_mm`` at the fc1 and the fc2 shape (T1's yardstick); the port never
calls it. Prints the card's name and power limit; without a card it exits
nonzero.

Usage: python -m text_to_sound_synthesis_torch.tools.bench_mlp_ablate [names...]
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import card_line, graph_us, require_card

M, D, DH = 2176, 1024, 4096
ITERS = 100
DEFAULTS = ["full", "dots_only", "no_gelu", "no_quant_mid", "no_deq_mid", "no_prologue",
            "ln_onepass"]
STATIC = (0.05, 0.05)


def inputs(dev, seed: int = 0):
    """x (M, D) bf16, mod (2, D) = [ones; zeros], W8 w1 (DH, D) and w2 (D, DH)."""
    from ..ops.quant import quantize_weight

    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((M, D), generator=g, device=dev).bfloat16()
    mod = torch.stack([torch.ones(D, device=dev), torch.zeros(D, device=dev)])
    w1 = quantize_weight(torch.randn((DH, D), generator=g, device=dev) * 0.02)
    w2 = quantize_weight(torch.randn((D, DH), generator=g, device=dev) * 0.02)
    return x, mod, w1, w2


def _parts(name: str):
    parts = name.split("_")
    num = lambda p, default: next((int(s[1:]) for s in parts if s.startswith(p) and s[1:].isdigit()),
                                  default)
    return parts, num


def variant(name: str, mod, w1, w2) -> Tuple[Callable, Callable, str]:
    """(call, its plain twin, what runs) of ``name``: each call maps x to the
    next x."""
    from ..ops import int8_block as ib
    from ..ops import mlp_ablate as T2

    parts, num = _parts(name)
    ss = STATIC if "static" in parts else None
    if name in T2.FUNCTIONS:
        return (lambda x: T2.mlp_variant(x, mod, w1, w2, variant=name),
                lambda x: T2.mlp_variant_reference(x, mod, w1, w2, variant=name),
                "T2, its configuration of K3's launches")
    if name.startswith("w4"):
        p1, p2 = T2.pack_w16(w1), T2.pack_w16(w2)
        return (lambda x: ib.mlp_block(x, mod, p1, p2, static_s=ss, w4=True),
                lambda x: ib.mlp_block_reference(x, mod, p1, p2, static_s=ss, w4=True),
                "K3's W4 path on the /16-packed weights")
    chunked = None
    if name.startswith(("skew", "ctrl")):
        chunked = (ib.mlp_block_chunked, ib.mlp_chunked_reference,
                   int(parts[0].replace("skew", "").replace("ctrl", "")))
    elif name.startswith("lib_chunked"):
        chunked = (ib.mlp_block_chunked, ib.mlp_chunked_reference, 4)
    elif name.startswith("streamed"):
        chunked = (ib.mlp_block_streamed, ib.mlp_chunked_reference, num("c", 16))
    if chunked:
        kern, plain, n = chunked
        return (lambda x: kern(x, mod, w1, w2, n_chunks=n, static_s=ss),
                lambda x: plain(x, mod, w1, w2, n_chunks=n, static_s=ss),
                f"schedule-only on this card: runs K9, {n} chunks")
    if name != "lib_static":
        ss = None
    known = name in ("full", "lib_base", "lib_static")
    return (lambda x: ib.mlp_block(x, mod, w1, w2, static_s=ss),
            lambda x: ib.mlp_block_reference(x, mod, w1, w2, static_s=ss),
            "schedule-only on this card: runs K3" + ("" if known else
                                                   " (the JAX tool's default for this name)"))


def chained_us(fn: Callable, x, iters: int = ITERS) -> float:
    """Device µs per call of ``iters`` chained calls in one CUDA graph."""
    def chain():
        h = x
        for _ in range(iters):
            h = fn(h)
        return h

    with torch.no_grad():
        return graph_us(chain, iters)


def int_mm_us(dev, iters: int = ITERS) -> Dict[str, float]:
    """``torch._int_mm`` at the fc1 (M x D x DH) and fc2 (M x DH x D) shapes."""
    from ..ops.dot import k_contiguous

    g = torch.Generator(dev).manual_seed(1)
    out = {}
    for label, (k, n) in (("fc1", (D, DH)), ("fc2", (DH, D))):
        a = torch.randint(-127, 128, (M, k), generator=g, device=dev, dtype=torch.int8)
        b = k_contiguous(torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                       dtype=torch.int8))

        def calls(a=a, b=b):
            for _ in range(iters):
                torch._int_mm(a, b)

        out[label] = graph_us(calls, iters)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not require_card("bench_mlp_ablate"):
        return 1
    dev = torch.device("cuda")
    names = argv or DEFAULTS
    x, mod, w1, w2 = inputs(dev)
    flops = 2.0 * M * D * DH * 2
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()})")
    print(f"MLP block {M}x{D}x{DH}, W8, {ITERS} chained calls per CUDA graph")
    for name in names:
        call, _, what = variant(name, mod, w1, w2)
        us = chained_us(call, x)
        print(f"  {name:28s} {us:8.1f} us/iter (device)  {flops / us / 1e6:6.1f} TOPS-equiv   "
              f"[{what}]")
        if name == "dots_only":
            mm = int_mm_us(dev)
            print(f"  {'torch._int_mm fc1 + fc2':28s} {mm['fc1'] + mm['fc2']:8.1f} us/iter (device)"
                  f"  {flops / (mm['fc1'] + mm['fc2']) / 1e6:6.1f} TOPS-equiv   [fc1 "
                  f"{mm['fc1']:.1f} us, fc2 {mm['fc2']:.1f} us; a yardstick, never on a path]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
