"""Fused GroupNorm -> swish -> 3x3 conv (K11), PyTorch port.

Port of ``text_to_sound_synthesis_tpu/ops/fused_gn_conv.py``: ``gn_affine``
(fast-variance group statistics, f32), the plain twin
``gn_swish_conv_reference`` (the XLA composition with the kernel's numerics),
``gn_swish_conv``, a ``torch.autograd.Function`` that launches the CUDA
kernel of ``csrc/gn_swish_conv.cu`` for a CUDA tensor and runs the twin for a
CPU one, with the twin's VJP as its backward (JAX's custom VJP is the XLA
composition's; there is no backward kernel on either side), and
``fused_gn_eligible``, the ``T2S_FUSED_GN`` gate. The JAX layout is kept at
the public functions: x NHWC, kernel HWIO (3, 3, C, Co), gamma / beta (C,),
bias (Co,).

On the TPU the kernel is a measured negative against XLA's own fused conv
(the JAX module's docstring), so it is off by default and nothing in the
model calls it: only the A/B tool (``tools/bench_gn_conv.py``, here
``text_to_sound_synthesis_torch/tools/bench_gn_conv.py``) and the tests do.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
from typing import Sequence

import torch
from torch.nn import functional as F

from ..utils.cuda_build import load_library
from .int8_kernels import check, on_cuda

__all__ = ["gn_affine", "gn_swish_conv_reference", "gn_swish_conv", "fused_gn_eligible",
           "load_kernel", "EPS"]

EPS = 1e-6


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/gn_swish_conv.cu``."""
    lib = load_library("gn_swish_conv", ["gn_swish_conv.cu"])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.t2s_gn_swish_conv.argtypes = [P] * 8 + [I] * 6 + [P]
    lib.t2s_gn_swish_conv.restype = I
    lib.t2s_gn_stat_pixels.argtypes = []
    lib.t2s_gn_stat_pixels.restype = I
    return lib


# The kernel's limits (csrc/gn_swish_conv.cu checks them too): C a multiple of
# C_MULTIPLE (its channel chunk) and at most MAX_C, Co a multiple of
# CO_MULTIPLE (its output tile), H and B at most MAX_GRID (grid dimensions).
C_MULTIPLE, CO_MULTIPLE, MAX_C, MAX_GRID = 32, 128, 2048, 65535


def gn_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int,
              eps: float = EPS):
    """Per-(batch, channel) GroupNorm affine, f32 (B, C) scale and shift with
    ``norm(x) = x * scale + shift``; the statistics in the fast-variance form
    E[x^2] - E[x]^2 in f32, as the JAX function (flax's
    ``use_fast_variance=True``). torch's GroupNorm takes two passes and would
    not match."""
    B, H, W, C = x.shape
    gsz = C // groups
    xf = x.float().reshape(B, H * W, groups, gsz)
    mean = xf.mean(dim=(1, 3))                                 # (B, G)
    var = xf.square().mean(dim=(1, 3)) - mean.square()
    rstd = torch.rsqrt(var + eps)
    scale = rstd.repeat_interleave(gsz, dim=1) * gamma.float()[None, :]
    shift = beta.float()[None, :] - mean.repeat_interleave(gsz, dim=1) * scale
    return scale, shift


@contextlib.contextmanager
def _ieee_conv(t: torch.Tensor):
    """cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits); the twin's conv on a CUDA tensor runs in full f32."""
    if t.device.type != "cuda":
        yield
        return
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def gn_swish_conv_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                            kernel: torch.Tensor, bias: torch.Tensor, *, groups: int,
                            eps: float = EPS) -> torch.Tensor:
    """The plain twin: f32 normalise and swish, the activation and the kernel
    rounded to ``x.dtype``, an f32 conv of the zero-padded activation, + f32
    bias, one cast to ``x.dtype`` (JAX ``gn_swish_conv_reference``)."""
    scale, shift = gn_affine(x, gamma, beta, groups, eps)
    a = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    a = a * torch.sigmoid(a)
    a = a.to(x.dtype).float()
    k = kernel.to(x.dtype).float()
    with _ieee_conv(x):
        y = F.conv2d(a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    return (y.permute(0, 2, 3, 1) + bias.float()).to(x.dtype)


def _check_kernel_args(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       kernel: torch.Tensor, bias: torch.Tensor, groups: int) -> None:
    """What the CUDA kernel takes (``csrc/gn_swish_conv.cu``): x (B, H, W, C)
    bf16, contiguous; C a multiple of 32, at most 2048; Co a multiple of 128;
    groups dividing C; H and B at most 65535."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"gn_swish_conv runs bf16 on the card, got x {x.dtype} (an f32 product "
                        "would be TF32 or FFMA, not the TPU kernel's numerics)")
    B, H, W, C = x.shape
    Co = kernel.shape[-1]
    if tuple(kernel.shape) != (3, 3, C, Co):
        raise ValueError(f"kernel has shape {tuple(kernel.shape)}, expected (3, 3, {C}, Co)")
    if tuple(gamma.shape) != (C,) or tuple(beta.shape) != (C,) or tuple(bias.shape) != (Co,):
        raise ValueError(f"gamma {tuple(gamma.shape)}, beta {tuple(beta.shape)}, bias "
                         f"{tuple(bias.shape)}: expected ({C},), ({C},), ({Co},)")
    if (C % C_MULTIPLE or C > MAX_C or Co % CO_MULTIPLE or groups <= 0 or C % groups
            or B > MAX_GRID or H > MAX_GRID):
        raise ValueError(f"x {tuple(x.shape)} -> {Co} channels, {groups} groups: the kernel "
                         f"takes C a multiple of {C_MULTIPLE} up to {MAX_C}, Co a multiple of "
                         f"{CO_MULTIPLE}, groups dividing C, H and B up to {MAX_GRID}")


def _gn_swish_conv_cuda(x, gamma, beta, kernel, bias, groups: int) -> torch.Tensor:
    """The kernel's three launches (statistics, finalize, conv) on the card."""
    _check_kernel_args(x, gamma, beta, kernel, bias, groups)
    lib = load_kernel()
    B, H, W, C = x.shape
    Co = kernel.shape[-1]
    dev = x.device
    check("x", x, (B, H, W, C), torch.bfloat16, dev)
    for name, t in (("gamma", gamma), ("beta", beta), ("kernel", kernel), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    # (Co, 3, 3, C) bf16, K-contiguous for the B fragments; per call, as the
    # TPU kernel casts its kernel to x.dtype per call
    w = kernel.to(torch.bfloat16).permute(3, 0, 1, 2).contiguous()
    g32, b32, bias32 = (t.float().contiguous() for t in (gamma, beta, bias))
    nchunk = -(-H * W // lib.t2s_gn_stat_pixels())
    partial = torch.empty((B, nchunk, 2, groups), dtype=torch.float32, device=dev)
    scale_shift = torch.empty((2, B, C), dtype=torch.float32, device=dev)
    y = torch.empty((B, H, W, Co), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = lib.t2s_gn_swish_conv(x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
                                    bias32.data_ptr(), y.data_ptr(), partial.data_ptr(),
                                    scale_shift.data_ptr(), B, H, W, C, Co, groups,
                                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_swish_conv kernel launch failed: cudaError {err}")
    gn_swish_conv.launches += 1
    return y


@contextlib.contextmanager
def _deterministic_conv(t: torch.Tensor):
    """On a CUDA tensor, cuDNN's deterministic algorithms in full f32: its
    default backward convolutions add with atomics, so two runs of the same
    gradient would differ in their last bits."""
    if t.device.type != "cuda":
        yield
        return
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        yield


class _GnSwishConv(torch.autograd.Function):
    """Forward: the kernel on a CUDA tensor, the twin on a CPU one. Backward:
    the twin's VJP at the saved inputs, recomputed (JAX ``_bwd``), with
    cuDNN's deterministic algorithms: the same gradient every run."""

    @staticmethod
    def forward(ctx, x, gamma, beta, kernel, bias, groups):
        ctx.groups = groups
        ctx.save_for_backward(x, gamma, beta, kernel, bias)
        if on_cuda(x, "gn_swish_conv"):
            return _gn_swish_conv_cuda(x, gamma, beta, kernel, bias, groups)
        return gn_swish_conv_reference(x, gamma, beta, kernel, bias, groups=groups)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:5]
        leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad(), _deterministic_conv(g):
            y = gn_swish_conv_reference(*leaves, groups=ctx.groups)
            grads = iter(torch.autograd.grad(y, [t for t, n in zip(leaves, need) if n], g))
        return (*(next(grads) if n else None for n in need), None)


def gn_swish_conv(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  kernel: torch.Tensor, bias: torch.Tensor, *, groups: int) -> torch.Tensor:
    """y = conv3x3(swish(GroupNorm(x; gamma, beta)), kernel) + bias, NHWC,
    differentiable. On a CUDA tensor the kernel (x bf16; f32 raises
    TypeError, shapes beyond its limits ValueError), counted in
    ``gn_swish_conv.launches``; on a CPU tensor the plain twin."""
    return _GnSwishConv.apply(x, gamma, beta, kernel, bias, groups)


gn_swish_conv.launches = 0


def fused_gn_eligible(x_shape: Sequence[int], out_ch: int) -> bool:
    """Whether a site should call ``gn_swish_conv`` (JAX's gate). Off unless
    ``T2S_FUSED_GN`` says otherwise: ``interpret`` takes every non-empty shape
    (on a CPU tensor the plain twin runs), ``1`` (or any other value) shapes
    within the CUDA kernel's limits on a machine with a card, where JAX asks
    for a TPU and lane-aligned channels."""
    mode = os.environ.get("T2S_FUSED_GN", "0")
    if mode == "0":
        return False
    B, H, W, C = x_shape
    if H < 1 or W < 1:
        return False
    if mode == "interpret":
        return True
    if not torch.cuda.is_available():
        return False
    return (C % C_MULTIPLE == 0 and C <= MAX_C and out_ch % CO_MULTIPLE == 0
            and B <= MAX_GRID and H <= MAX_GRID)
