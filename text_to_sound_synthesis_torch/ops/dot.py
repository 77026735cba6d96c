"""T1, the bare tiled dot of the dot probe, PyTorch port.

Port of ``tools/bench_kernel_dot.py::make_pallas_dot``: ``x (M, K) @ w (K,
N)`` in the probe's three cases, int8 x int8 -> int32, int8 x int8 -> f32
(the exact int32 sums converted once) and bf16 x bf16 -> f32.
``tiled_dot`` launches ``t2s_tiled_dot`` of ``csrc/int8_block.cu`` for a
CUDA tensor and runs the plain twin ``tiled_dot_reference`` for a CPU one,
counting its launches in ``.launches``. The int8 cases run the serving
engine's own GEMM mainloop (``int8_gemm_kernel`` in its int8 A mode, a raw
epilogue), so the probe reads the rate of the GEMM that K3-K9 run; the bf16
case a kernel of the same tiling on ``mma.sync`` bf16. The TPU's ``block_m``
/ ``block_n`` are schedule knobs of the TPU and are not carried over: the
Hopper tile is the engine's 64 x 128.

The kernel reads the weight as the engine stores it, (N, K) K-contiguous:
``tiled_dot`` takes the (K, N) operand as a view of such a tensor, which
``k_contiguous`` makes once.
"""

from __future__ import annotations

import torch

from . import int8_kernels as ik

__all__ = ["CASES", "TILE", "k_contiguous", "tiled_dot_reference", "tiled_dot"]

# the probe's cases: (input dtype, output dtype)
CASES = {"int8->int32": (torch.int8, torch.int32),
         "int8->f32": (torch.int8, torch.float32),
         "bf16->f32": (torch.bfloat16, torch.float32)}
_KIND = {v: i for i, v in enumerate(CASES.values())}   # t2s_tiled_dot's kind
TILE = (64, 128)                                        # the kernel's output tile (rows, cols)


def _check_case(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> None:
    if (x.dtype, out_dtype) not in _KIND or w.dtype != x.dtype:
        raise TypeError(f"tiled_dot computes {', '.join(CASES)}; got x {x.dtype}, w {w.dtype} "
                        f"-> {out_dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}: expected (M, K) @ (K, N)")


def k_contiguous(w: torch.Tensor) -> torch.Tensor:
    """(K, N) -> the same values as a view of an (N, K) K-contiguous tensor,
    the layout the kernel reads (one copy)."""
    return w.t().contiguous().t()


def tiled_dot_reference(x: torch.Tensor, w: torch.Tensor,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """The plain twin. int8: the products summed in float64, exact while
    |sum| < 2^53 (K * 127^2 at most), taken to int32 and then, for f32, rounded
    once. bf16: an f32 product of the f32-converted operands (exact products,
    f32 sums; full f32 on a card while ``torch.backends.cuda.matmul.allow_tf32``
    is False, its default)."""
    _check_case(x, w, out_dtype)
    if x.dtype == torch.int8:
        return (x.double() @ w.double()).to(torch.int32).to(out_dtype)
    return x.float() @ w.float()


def tiled_dot(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """T1: ``x (M, K) @ w (K, N)`` -> (M, N) ``out_dtype``. On a CUDA tensor
    the kernel: x contiguous, w a (K, N) view of an (N, K) K-contiguous tensor
    (``k_contiguous``), N a multiple of 128, K a multiple of 64 (int8) or 32
    (bf16), else ValueError. On a CPU tensor the plain twin."""
    _check_case(x, w, out_dtype)
    if not ik.on_cuda(x, "tiled_dot"):
        return tiled_dot_reference(x, w, out_dtype)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    ik.check("x", x, (M, K), x.dtype, dev)
    wt = w.t()
    if not wt.is_contiguous():
        raise ValueError("w must be a (K, N) view of an (N, K) K-contiguous tensor: "
                         "pass k_contiguous(w)")
    ik.check("w.t()", wt, (N, K), x.dtype, dev)
    k_mult = 64 if x.dtype == torch.int8 else 32
    if N % TILE[1] or K % k_mult:
        raise ValueError(f"({M}, {K}) @ ({K}, {N}): the kernel takes N a multiple of {TILE[1]} "
                         f"and K a multiple of {k_mult}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    lib = ik.load_kernel()
    with torch.cuda.device(dev):
        err = lib.t2s_tiled_dot(_KIND[(x.dtype, out_dtype)], x.data_ptr(), wt.data_ptr(),
                                out.data_ptr(), M, K, N, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled dot kernel launch failed: cudaError {err}")
    tiled_dot.launches += 1
    return out


tiled_dot.launches = 0
