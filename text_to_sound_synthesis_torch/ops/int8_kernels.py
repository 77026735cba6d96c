"""ctypes bindings of ``csrc/int8_block.cu`` and ``csrc/mha_int8.cu``, and
the launch helpers that the int8 kernel wrappers share:
``quant.fused_quant_dense[_multi]`` (K6), ``attention.fused_mha`` (K7) and
the blocks of ``int8_block`` (K3-K5, K8, K9) and their int8 attention (K10);
``dot.tiled_dot`` (T1) and ``fused_gn_conv`` (K11) use its checks.
Nothing here counts launches: each wrapper counts its own calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.cuda_build import load_library

__all__ = ["load_kernel", "load_mha_int8", "on_cuda", "check", "check_weight", "check_mha",
           "dense", "row_amax", "mha", "mha_int8",
           "PANEL", "STREAM", "INT8", "EPI_STORE", "EPI_GELU_INT8", "EPI_CHUNKED"]

PANEL, STREAM, INT8 = 0, 1, 2
_NORM = {"none": 0, "adaln": 1, "ln": 2}
EPI_STORE, EPI_GELU_INT8, EPI_CHUNKED = 0, 1, 2


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/int8_block.cu``."""
    lib = load_library("int8_block", ["int8_block.cu"])
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.t2s_int8_dense.argtypes = ([I, I, I, I, P, I, P, P, F, F, I, I] + [P] * 12
                                   + [P, I, I, I, P, F, I, I, I, I, P])
    lib.t2s_int8_dense.restype = I
    lib.t2s_int8_row_amax.argtypes = [P, I, I, P, P]
    lib.t2s_int8_row_amax.restype = I
    lib.t2s_int8_mha.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    lib.t2s_int8_mha.restype = I
    lib.t2s_int8_limits.argtypes = [I]
    lib.t2s_int8_limits.restype = I
    lib.t2s_tiled_dot.argtypes = [I, P, P, P, I, I, I, P]
    lib.t2s_tiled_dot.restype = I
    return lib


@functools.cache
def load_mha_int8() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/mha_int8.cu`` (K10)."""
    lib = load_library("mha_int8", ["mha_int8.cu"])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.t2s_mha_int8.argtypes = [P] * 10 + [I] * 6 + [P]
    lib.t2s_mha_int8.restype = I
    lib.t2s_mha_int8_max_keys.argtypes = []
    lib.t2s_mha_int8_max_keys.restype = I
    return lib


def on_cuda(x: torch.Tensor, fn: str) -> bool:
    """True for a CUDA tensor, False for a CPU one (plain version); raises else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on cpu or cuda, got {x.device}")
    return True


def check(name: str, t: torch.Tensor, shape, dtype: Union[torch.dtype, Tuple[torch.dtype, ...]],
          device) -> None:
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {' or '.join(map(str, dtypes))}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_weight(name: str, w, n: int, k: int, w4: bool, device) -> None:
    check(f"{name}.w_q", w.w_q, (n, k // 2 if w4 else k), torch.int8, device)
    check(f"{name}.scale", w.scale, (n,), torch.float32, device)
    check(f"{name}.bias", w.bias, (n,), torch.float32, device)


def _static_args(s: Optional[float]):
    """(s_static, inv_static, is_static) for the kernel: the dequant scale and
    the quantize reciprocal, both rounded to f32 as the plain twin rounds them."""
    if s is None:
        return 0.0, 0.0, 0
    return float(np.float32(s)), float(np.float32(1.0 / s)), 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dense(lib, a: torch.Tensor, ws: Sequence, outs: Sequence[torch.Tensor], *,
          amode: int = PANEL, norm: str = "none", epi: int = EPI_STORE,
          mod: Optional[torch.Tensor] = None, s: Optional[float] = None,
          amax_in: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
          gelu: bool = False, amax_out: Optional[torch.Tensor] = None,
          s_out: Optional[float] = None, nch: int = 1, w4: bool = False) -> None:
    """One ``t2s_int8_dense`` launch (see its comment in ``csrc/int8_block.cu``)
    on tensors the caller has checked. The dtypes of ``a``, ``residual`` and
    ``outs`` (bf16 or f32) pick the kernel's loads and stores."""
    M, K = a.shape
    N = ws[0].w_q.shape[0]
    s_static, inv, is_static = _static_args(s)
    wargs = []
    for i in range(3):
        if i < len(ws):
            wargs += [ws[i].w_q.data_ptr(), ws[i].scale.data_ptr(), ws[i].bias.data_ptr(),
                      outs[i].data_ptr()]
        else:
            wargs += [None] * 4
    f32 = lambda t: int(t is not None and t.dtype == torch.float32)
    with torch.cuda.device(a.device):
        err = lib.t2s_int8_dense(amode, _NORM[norm], int(w4), epi, a.data_ptr(), f32(a),
                                 _ptr(mod), _ptr(amax_in), s_static, inv, is_static, len(ws),
                                 *wargs, _ptr(residual), f32(residual), int(gelu), f32(outs[0]),
                                 _ptr(amax_out), _static_args(s_out)[1], nch, M, K, N,
                                 _stream(a))
    if err != 0:
        raise RuntimeError(f"int8 dense kernel launch failed: cudaError {err}")


def row_amax(lib, a: torch.Tensor) -> torch.Tensor:
    """(M, K) bf16 -> (M,) f32 row max |a| (one warp per row)."""
    M, K = a.shape
    amax = torch.empty((M,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.t2s_int8_row_amax(a.data_ptr(), M, K, amax.data_ptr(), _stream(a))
    if err != 0:
        raise RuntimeError(f"row max kernel launch failed: cudaError {err}")
    return amax


def check_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, batch: int, n_head: int,
              kv_valid: int, max_keys: int) -> None:
    """What the attention kernels take: bf16 q (B*Lq, D), k/v (B*Lkv, D), a
    head width of 32 or 64, 0 < kv_valid <= Lkv <= ``max_keys``."""
    M, D = q.shape
    Mkv = k.shape[0]
    check("q", q, (M, D), torch.bfloat16, q.device)
    check("k", k, (Mkv, D), torch.bfloat16, q.device)
    check("v", v, (Mkv, D), torch.bfloat16, q.device)
    if M % batch or Mkv % batch or D % n_head or D // n_head not in (32, 64):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, batch {batch}, {n_head} heads: "
                         "the kernel takes rows = batch * length and a head width of 32 or 64")
    if not 0 < kv_valid <= Mkv // batch or Mkv // batch > max_keys:
        raise ValueError(f"kv_valid {kv_valid} and key length {Mkv // batch} out of the kernel's "
                         f"range (0 < kv_valid <= keys <= {max_keys})")


def mha(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, batch: int, n_head: int,
        kv_valid: int, fold_div: bool = False) -> torch.Tensor:
    """The bf16 attention launch on checked bf16 tensors: q (B*Lq, D), k/v
    (B*Lkv, D); ``fold_div`` divides the P V output by the row sum instead of
    P (``attention.mha_reference``)."""
    M, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.t2s_int8_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch,
                               M // batch, k.shape[0] // batch, n_head, D // n_head, kv_valid,
                               int(fold_div), _stream(q))
    if err != 0:
        raise RuntimeError(f"int8 attention kernel launch failed: cudaError {err}")
    return out


def mha_int8(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, batch: int, n_head: int,
             kv_valid: int) -> torch.Tensor:
    """K10's two launches on checked bf16 tensors: the quantize pass (int8 q
    and k with row scales, int8 V with one scale per (batch, column)) into
    scratch allocated here, then the int8 MHA -> (B*Lq, D) bf16."""
    M, D = q.shape
    Mkv = k.shape[0]
    dev = q.device
    qq = torch.empty((M, D), dtype=torch.int8, device=dev)
    kq, vq = (torch.empty((Mkv, D), dtype=torch.int8, device=dev) for _ in range(2))
    sq = torch.empty((M,), dtype=torch.float32, device=dev)
    sk = torch.empty((Mkv,), dtype=torch.float32, device=dev)
    sv = torch.empty((batch, D), dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = lib.t2s_mha_int8(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               qq.data_ptr(), kq.data_ptr(), vq.data_ptr(), sq.data_ptr(),
                               sk.data_ptr(), sv.data_ptr(), batch, M // batch, Mkv // batch,
                               n_head, D // n_head, kv_valid, _stream(q))
    if err != 0:
        raise RuntimeError(f"int8 MHA kernel launch failed: cudaError {err}")
    return out
