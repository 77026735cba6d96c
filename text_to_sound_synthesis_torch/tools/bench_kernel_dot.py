"""A/B: the port's tiled dot (T1) against PyTorch's one-call products at the
fc1 shape, on a CUDA card.

Port of ``tools/bench_kernel_dot.py``: the JAX tool's cases at M, K, N =
2176, 1024, 4096 (the serving engine's fc1), int8 x int8 -> int32, int8 x
int8 -> f32 and bf16 x bf16 -> f32, through ``ops.dot.tiled_dot`` over the
port's tile (the int8 cases run the engine's own GEMM mainloop, so their rate
is the engine's dot rate without its prologue and epilogue). Beside them the
one-call yardsticks, which the port never calls on a path:
``torch._int_mm`` (int8 -> int32) and bf16 ``torch.matmul`` (bf16 out, the
nearest single call to bf16 -> f32). Each is timed as device time per call
from a CUDA graph of ``iters`` calls on the same inputs; the weight is laid
out (N, K) K-contiguous once, outside the timed calls. Then the host time of
one eager call of each kernel case (the wrapper's checks, the int8 cases'
tensor-map encoding, the launch), ``iters`` calls queued back to back. Last,
the int8 -> int32 case at the engine's fc2 shape (K 4096, N 1024) for rows
either side of one wave of 128 x 128 tiles on 132 SMs (2048 rows: 128
tiles; 2120, the flagship, and 2176: 136; 2304: 144), beside
``torch._int_mm``: how the stream-K grid spreads a tile count just past a
wave.

Usage: python -m text_to_sound_synthesis_torch.tools.bench_kernel_dot [iters]
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Sequence

import torch

from . import card_line, graph_us, require_card

M, K, N = 2176, 1024, 4096
ITERS = 200
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_INT8_OPS, PEAK_BF16_FLOPS, HBM_BYTES_PER_S = 1979e12, 989e12, 3.35e12


def inputs(dev, seed: int = 0):
    """int8 x (M, K) and w (K, N) in [-127, 127]; their bf16 copies / 127
    (the JAX tool's); each w a (K, N) view of (N, K) K-contiguous storage."""
    from ..ops.dot import k_contiguous

    g = torch.Generator(dev).manual_seed(seed)
    x8 = torch.randint(-127, 128, (M, K), generator=g, device=dev, dtype=torch.int8)
    w8 = k_contiguous(torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8))
    xb, wb = ((t.float() / 127.0).bfloat16() for t in (x8, w8))
    return x8, w8, xb, k_contiguous(wb)


def cases(dev) -> Dict[str, tuple]:
    """name -> (call, the plain twin's call) at the fc1 shape."""
    from ..ops.dot import CASES, tiled_dot, tiled_dot_reference

    x8, w8, xb, wb = inputs(dev)
    out = {}
    for name, (dt, out_dt) in CASES.items():
        x, w = (x8, w8) if dt == torch.int8 else (xb, wb)
        out[name] = (lambda x=x, w=w, o=out_dt: tiled_dot(x, w, o),
                     lambda x=x, w=w, o=out_dt: tiled_dot_reference(x, w, o))
    out["torch._int_mm int8->int32"] = (lambda: torch._int_mm(x8, w8), None)
    out["torch.matmul bf16->bf16"] = (lambda: torch.matmul(xb, wb), None)
    return out


def run(iters: int = ITERS, dev=None) -> Dict[str, float]:
    """µs per call of each case (``cases``), kernel and yardsticks."""
    dev = dev or torch.device("cuda")

    def repeat(fn):
        for _ in range(iters):
            fn()

    return {name: graph_us(lambda: repeat(fn), iters) for name, (fn, _) in cases(dev).items()}


FC2_K, FC2_N, FC2_ROWS = 4096, 1024, (2048, 2120, 2176, 2304)


def fc2_rows_us(iters: int = ITERS, dev=None) -> Dict[int, tuple]:
    """rows -> (kernel µs, ``torch._int_mm`` µs), int8 -> int32 at fc2's shape."""
    from ..ops.dot import k_contiguous, tiled_dot

    dev = dev or torch.device("cuda")
    g = torch.Generator(dev).manual_seed(1)
    w = k_contiguous(torch.randint(-127, 128, (FC2_K, FC2_N), generator=g, device=dev,
                                   dtype=torch.int8))
    out = {}
    for rows in FC2_ROWS:
        x = torch.randint(-127, 128, (rows, FC2_K), generator=g, device=dev, dtype=torch.int8)
        calls = (lambda: tiled_dot(x, w, torch.int32), lambda: torch._int_mm(x, w))

        def repeat(fn):
            for _ in range(iters):
                fn()

        out[rows] = tuple(graph_us(lambda fn=fn: repeat(fn), iters) for fn in calls)
    return out


def host_us(iters: int = ITERS, dev=None) -> Dict[str, float]:
    """Host µs per eager call of each kernel case, ``iters`` calls queued
    back to back after a warm call."""
    from ..ops.dot import CASES

    dev = dev or torch.device("cuda")
    out = {}
    for name, (fn, _) in cases(dev).items():
        if name not in CASES:
            continue
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out[name] = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not require_card("bench_kernel_dot"):
        return 1
    from ..ops.dot import TILE

    iters = int(argv[0]) if argv else ITERS
    print(f"device={torch.cuda.get_device_name(0)} ({card_line()})")
    print(f"fc1 shape {M}x{K}x{N}, device time per call over {iters} calls (CUDA graph); "
          f"int8 kernel tile {TILE[0]}x{TILE[1]}")
    ops = 2.0 * M * K * N
    t_ops, t_bytes = ops / PEAK_INT8_OPS, (M * K + K * N + 4 * M * N) / HBM_BYTES_PER_S
    print(f"int8 -> int32 bound {1e6 * max(t_ops, t_bytes):.1f} us by "
          f"{'bytes' if t_bytes >= t_ops else 'operations'} (the products {1e6 * t_ops:.1f} us at "
          f"the int8 peak, {PEAK_INT8_OPS / 1e12:.0f} TOPS)")
    for name, us in run(iters).items():
        label = name if name.startswith("torch") else f"kernel {name}"
        kind = "bf16" if "bf16" in name else "int8"
        peak = PEAK_BF16_FLOPS if kind == "bf16" else PEAK_INT8_OPS
        print(f"  {label:40s} {us:8.1f} us  {ops / us / 1e6:7.1f} TOPS "
              f"({100 * ops / (us * 1e-6) / peak:.1f} % of the {kind} peak)")
    print("host time per eager call (checks, tensor-map encoding, launch):")
    for name, us in host_us(iters).items():
        print(f"  kernel {name:33s} {us:8.1f} us")
    print(f"fc2 shape (K {FC2_K}, N {FC2_N}), int8 -> int32, device time per call by rows:")
    for rows, (us, mm) in fc2_rows_us(iters).items():
        tiles = -(-rows // TILE[0]) * (FC2_N // TILE[1])
        print(f"  {rows:5d} rows ({tiles} tiles)  kernel {us:7.1f} us  torch._int_mm {mm:7.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
