"""Time the engine's MHAs on a CUDA card, alone and between the served MLP's calls.

K7 (``attention.fused_mha``, the bf16 MHA), the pair-packed MHA of the
served default (``int8_kernels.mha(mode="pair")``, the launch inside K4 and
K5) and K10 (``int8_block.mha_inline_int8``: its quantize pass and MHA) at
the flagship's self (265 keys) and cross (77 keys) attention: 8 x 265
queries, 16 heads of 64, seeded N(0, 1) bf16 inputs. Each prints its device
µs per call in a CUDA graph of ``ITERS`` calls, and in a CUDA graph of
``ITERS`` (K3, MHA) pairs less the same graph of K3 alone, K3 being the
served W4 static MLP block (``mlp_block``) at the same rows. A request runs
each MHA between such GEMMs, which leave the SMs' instruction caches cold
for it: the second number is what the MHA costs there. Only the wrappers'
public names are used, so the same file times a parent tree too
(``ab_parent.sh`` copies it there with ``AB_COPY``). Prints the card's name
and power limit; without a card it exits nonzero.

Usage: python -m text_to_sound_synthesis_torch.tools.bench_mha [k7 pair k10]
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import card_line, graph_us, require_card

B, L, S, D, H, DH = 8, 265, 77, 1024, 16, 4096
ITERS = 20
NAMES = ("k7", "pair", "k10")


def calls(dev, seed: int = 1239) -> Tuple[Callable[[], object], Dict[Tuple[str, int], Callable]]:
    """(K3's call, {(name, keys): one MHA call}) on seeded inputs: x, the
    condition's k and v ~ N(0, 1) bf16, AdaLN rows N(0, 0.04), W4 weights."""
    from ..ops import attention as attn
    from ..ops import int8_block as ib
    from ..ops import int8_kernels as ik
    from ..ops.quant import quantize_weight_w4

    g = torch.Generator(dev).manual_seed(seed)
    rnd = lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale
    x = rnd(B * L, D).bfloat16()
    ck, cv = rnd(B * S, D).bfloat16(), rnd(B * S, D).bfloat16()
    mod = rnd(2, D, scale=0.2)
    w1 = quantize_weight_w4(rnd(DH, D, scale=0.03), rnd(DH, scale=0.05))
    w2 = quantize_weight_w4(rnd(D, DH, scale=0.015), rnd(D, scale=0.05))
    lib = ik.load_kernel()
    mhas = {}
    for keys, (k, v) in ((L, (x, x)), (S, (ck, cv))):
        kw = dict(batch=B, n_head=H, kv_valid=keys)
        mhas["k7", keys] = lambda k=k, v=v, kw=kw: attn.fused_mha(x, k, v, **kw)
        mhas["pair", keys] = lambda k=k, v=v, keys=keys: ik.mha(lib, x, k, v, B, H, keys,
                                                                mode="pair")
        mhas["k10", keys] = lambda k=k, v=v, kw=kw: ib.mha_inline_int8(x, k, v, **kw)
    return (lambda: ib.mlp_block(x, mod, w1, w2, static_s=(0.035, 0.02), w4=True)), mhas


def chain(*fns: Callable[[], object]) -> Callable[[], None]:
    """``ITERS`` rounds of ``fns`` in turn."""
    def run():
        for _ in range(ITERS):
            for fn in fns:
                fn()
    return run


def main(argv: Optional[Sequence[str]] = None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(NAMES)
    unknown = [n for n in names if n not in NAMES]
    if unknown:
        print(f"error: unknown names {unknown}; the names are {', '.join(NAMES)}", file=sys.stderr)
        return 2
    if not require_card("bench_mha"):
        return 1
    dev = torch.device("cuda")
    k3, mhas = calls(dev)
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()})")
    print(f"MHAs at {B} x {L} queries, {H} heads of {D // H}; CUDA graphs of {ITERS} calls, alone "
          f"and each after a W4 static K3 call ({B * L} rows, {D} -> {DH} -> {D})")
    with torch.no_grad():
        for name in names:
            for keys in (L, S):
                fn = mhas[name, keys]
                alone = graph_us(chain(fn), ITERS)
                between = graph_us(chain(k3, fn), ITERS) - graph_us(chain(k3), ITERS)
                print(f"  {name:5s} {keys:3d} keys {alone:8.1f} us/call alone {between:8.1f} us/call "
                      f"between K3 calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
