"""A/B the fused GroupNorm + swish + conv3x3 kernel (K11) against the plain
composition on a CUDA card.

Port of ``tools/bench_gn_conv.py``: the flagship decoder's five stages
(batch 8, bf16, C == Co, 32 groups). For each it times two arms as device
time per call, from a CUDA graph of ``repeats`` chained calls (h = f(h), as
the JAX tool chains them in a scan):

- "fused": ``ops.fused_gn_conv.gn_swish_conv`` (``csrc/gn_swish_conv.cu``);
- "cudnn": ``F.conv2d(F.silu(F.group_norm(h)))`` in bf16, channels-last, the
  counterpart of the JAX tool's "xla" arm and the only yardstick (no single
  PyTorch call computes this function). Its weights are bf16 and its
  GroupNorm takes two passes: the same function to bf16 rounding, not the
  same numerics.

Then the backward at each stage, given one upstream gradient, as eager
device time per call: the Function's (the twin's VJP recomputed, with
cuDNN's deterministic algorithms) beside the same VJP with cuDNN's default
algorithms, which add with atomics (the backward before it was made
deterministic).

Usage: python -m text_to_sound_synthesis_torch.tools.bench_gn_conv [repeats] [shape_idx...]
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import torch
from torch.nn import functional as F

from . import card_line, graph_us, require_card

# (H, W, C) stages of the flagship decoder (batch 8, bf16), C == Co.
SHAPES = [
    (5, 53, 512),
    (10, 106, 256),
    (20, 212, 256),
    (40, 424, 128),
    (80, 848, 128),
]
B = 8
GROUPS = 32
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_BF16_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12


def bound_us(H: int, W: int, C: int) -> float:
    """The least time for one stage's work: its 3x3 products (18 B H W C^2
    bf16 FLOP) at the bf16 peak or x read and y written (bf16) at the memory
    rate, whichever is larger (the products, at every stage here)."""
    return 1e6 * max(18 * B * H * W * C * C / PEAK_BF16_FLOPS,
                     2 * 2 * B * H * W * C / HBM_BYTES_PER_S)


def stage_inputs(H: int, W: int, C: int, dev, seed: int = 0):
    """x (B, H, W, C) bf16 ~ N(0, 1), gamma ones, beta zeros, kernel (3, 3, C,
    C) ~ 0.05 N(0, 1), bias zeros, all f32 but x (the JAX tool's)."""
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((B, H, W, C), generator=g, device=dev).bfloat16()
    k = torch.randn((3, 3, C, C), generator=g, device=dev) * 0.05
    ones, zeros = torch.ones(C, device=dev), torch.zeros(C, device=dev)
    return x, ones, zeros, k, zeros.clone()


def bench_one(H: int, W: int, C: int, repeats: int, dev=None) -> Dict[str, float]:
    """{"fused": µs, "cudnn": µs} per call at one stage."""
    from ..ops.fused_gn_conv import gn_swish_conv

    dev = dev or torch.device("cuda")
    x, gamma, beta, k, b = stage_inputs(H, W, C, dev)
    # the cudnn arm's weights in the working type, its kernel OIHW channels-last
    k_oihw = k.permute(3, 2, 0, 1).bfloat16().contiguous(memory_format=torch.channels_last)
    gb, bb, biasb = gamma.bfloat16(), beta.bfloat16(), b.bfloat16()
    x_cl = x.permute(0, 3, 1, 2)         # NCHW view of NHWC storage: channels-last

    def fused():
        h = x
        for _ in range(repeats):
            h = gn_swish_conv(h, gamma, beta, k, b, groups=GROUPS)
        return h

    def cudnn():
        h = x_cl
        for _ in range(repeats):
            h = F.conv2d(F.silu(F.group_norm(h, GROUPS, gb, bb, eps=1e-6)), k_oihw, biasb,
                         padding=1)
        return h

    with torch.no_grad():
        return {"fused": graph_us(fused, repeats), "cudnn": graph_us(cudnn, repeats)}


def _events_ms(fn, iters: int) -> float:
    """Eager device ms per call of ``fn`` over ``iters`` calls, after two."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def backward_ms(H: int, W: int, C: int, iters: int, dev=None) -> Dict[str, float]:
    """{"deterministic": ms, "cudnn_default": ms} per backward at one stage:
    the Function's backward, and the same VJP under cuDNN's defaults."""
    from ..ops.fused_gn_conv import gn_swish_conv, gn_swish_conv_reference

    dev = dev or torch.device("cuda")
    leaves = [t.clone().requires_grad_(True) for t in stage_inputs(H, W, C, dev)]
    y = gn_swish_conv(*leaves, groups=GROUPS)
    up = torch.randn(y.shape, generator=torch.Generator(dev).manual_seed(1), device=dev).to(y.dtype)

    def default():
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            torch.autograd.grad(gn_swish_conv_reference(*leaves, groups=GROUPS), leaves, up)

    return {"deterministic": _events_ms(lambda: torch.autograd.grad(y, leaves, up,
                                                                    retain_graph=True), iters),
            "cudnn_default": _events_ms(default, iters)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not require_card("bench_gn_conv"):
        return 1
    repeats = int(argv[0]) if argv else 50
    idxs = [int(a) for a in argv[1:]] or range(len(SHAPES))
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()}) batch={B} repeats={repeats} "
          f"(device time per call, CUDA graph of chained calls)")
    tot_f = tot_c = tot_b = 0.0
    for i in idxs:
        H, W, C = SHAPES[i]
        r = bench_one(H, W, C, repeats)
        bound = bound_us(H, W, C)
        tot_f, tot_c, tot_b = tot_f + r["fused"], tot_c + r["cudnn"], tot_b + bound
        mb = B * H * W * C * 2 / 1e6
        print(f"({H:3d},{W:3d},{C:3d}) act {mb:6.1f} MB  fused {r['fused']:8.1f} us"
              f"  cudnn {r['cudnn']:8.1f} us  speedup {r['cudnn'] / r['fused']:.2f}x"
              f"  bound {bound:6.1f} us ({100 * bound / r['fused']:.1f} % of fused)")
    print(f"TOTAL per-site pass: fused {tot_f:.0f} us, cudnn {tot_c:.0f} us, "
          f"speedup {tot_c / tot_f:.2f}x, bound {tot_b:.0f} us ({100 * tot_b / tot_f:.1f} % of "
          f"fused)")
    tot_d = tot_o = 0.0
    for i in idxs:
        H, W, C = SHAPES[i]
        r = backward_ms(H, W, C, repeats)
        tot_d, tot_o = tot_d + r["deterministic"], tot_o + r["cudnn_default"]
        print(f"({H:3d},{W:3d},{C:3d}) backward: deterministic {r['deterministic']:.3f} ms, "
              f"cuDNN default {r['cudnn_default']:.3f} ms ({r['deterministic'] / r['cudnn_default']:.2f}x)")
    print(f"TOTAL backward: deterministic {tot_d:.3f} ms, cuDNN default {tot_o:.3f} ms "
          f"({tot_d / tot_o:.2f}x; eager device time per call)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
