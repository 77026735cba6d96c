"""ctypes bindings of ``csrc/int8_block.cu`` (the engine), ``csrc/int8_probe.cu``
(the T1-T3 probes) and ``csrc/mha_int8.cu``, and the launch helpers that the
int8 kernel wrappers share: ``quant.fused_quant_dense[_multi]`` (K6),
``attention.fused_mha`` (K7) and the blocks of ``int8_block`` (K3-K5, K8, K9),
the quantize passes in front of their dots (``quant.quantize_rows``,
``quant.quantize_wide``) and their int8 attention (K10); the ablation probes ``mlp_ablate`` (T2) and
``attn_ablate`` (T3) and ``dot.tiled_dot`` (T1) launch the probe library for
their own configurations and the engine's for the launches they share with
it; ``fused_gn_conv`` (K11) uses the checks. Nothing here counts launches:
each wrapper counts its own calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.cuda_build import load_library

__all__ = ["load_kernel", "load_probe_kernel", "load_mha_int8", "workspace", "on_cuda", "check",
           "check_weight", "check_mha", "dense", "quant_rows", "quant_wide", "mha", "mha_int8",
           "mha_int8_keys", "key_slots", "vt_slot_layout",
           "MHA_MODES", "PANEL", "INT8", "EPI_STORE", "EPI_GELU_INT8", "EPI_CHUNKED", "EPI_RAW",
           "EPI_WRAP8", "EPI_CLIP8", "EPI_SHIFT8", "EF_MID_BF16", "EF_SIG_C", "EF_FAST_SIG",
           "EF_Q_BF16", "EF_RAW_BF16"]

PANEL, INT8 = 0, 2
# the panel's and the row pass's norms; "cast" and "ln_onepass" are the T2 probe's
_NORM = {"none": 0, "adaln": 1, "ln": 2, "cast": 3, "ln_onepass": 4}
EPI_STORE, EPI_GELU_INT8, EPI_CHUNKED, EPI_RAW = 0, 1, 2, 3
EPI_WRAP8, EPI_CLIP8, EPI_SHIFT8 = 4, 5, 6              # the T2 probe's int8 middles
# the T2 probe's epilogue flags (``kEfProbe`` in csrc/int8_gemm_sm90.cuh)
EF_MID_BF16, EF_SIG_C, EF_FAST_SIG, EF_Q_BF16, EF_RAW_BF16 = 64, 128, 256, 512, 1024
# the attention launch's MHA (``MhaMode`` in csrc/mha_sm90.cuh): the engine's
# library runs the first three, the probe library (``load_probe_kernel``) the rest
MHA_MODES = {"bf16": 0, "bf16_fold": 1, "pair": 2, "pair_nofold": 3, "no_softmax": 4,
             "no_av": 5, "no_scores": 6}


def _bind_dense(lib: ctypes.CDLL) -> ctypes.CDLL:
    """argtypes of ``t2s_int8_dense``, ``t2s_int8_quant_wide`` and
    ``t2s_int8_mha``, which both libraries export with the same signatures
    (each its own instantiations)."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.t2s_int8_dense.argtypes = ([I, I, I, I, P, P, P, F, F, I, I] + [P] * 12
                                   + [P, I, I, I, P, F, I, I, I, I, I, F, P, P])
    lib.t2s_int8_dense.restype = I
    lib.t2s_int8_quant_wide.argtypes = [P, I, I, I, I, P, F, I, I, P, P, P]
    lib.t2s_int8_quant_wide.restype = I
    lib.t2s_int8_mha.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P]
    lib.t2s_int8_mha.restype = I
    return lib


@functools.cache
def load_kernel() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/int8_block.cu``, the engine's launches."""
    lib = _bind_dense(load_library("int8_block", ["int8_block.cu"]))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.t2s_int8_quant_rows.argtypes = [I, P, I, P, I, I, ctypes.c_float, I, P, P, P]
    lib.t2s_int8_quant_rows.restype = I
    lib.t2s_int8_limits.argtypes = [I]
    lib.t2s_int8_limits.restype = I
    return lib


@functools.cache
def load_probe_kernel() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/int8_probe.cu``: the T2 / T3
    configurations of ``t2s_int8_dense``, ``t2s_int8_quant_wide`` and
    ``t2s_int8_mha``, and T1's ``t2s_tiled_dot``."""
    lib = _bind_dense(load_library("int8_probe", ["int8_probe.cu"]))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.t2s_tiled_dot.argtypes = [I, P, P, P, I, I, I, P, P]
    lib.t2s_tiled_dot.restype = I
    return lib


_WORKSPACE = {}


def workspace(device: torch.device) -> torch.Tensor:
    """The int8 GEMM's stream-K workspace on ``device`` (``t2s_int8_limits(4)``
    bytes: partial-sum slots and counters), zeroed once and kept: every launch
    leaves its counters at zero. Launches on one stream at a time share it.
    Allocated at a device's first launch, which must not be under CUDA graph
    capture (the tools warm up eagerly first)."""
    key = torch.device(device).index
    if key not in _WORKSPACE:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the int8 GEMM's workspace is allocated at the first launch on a "
                               "device, which must run outside CUDA graph capture")
        with torch.cuda.device(device):
            nbytes = load_kernel().t2s_int8_limits(4)
        _WORKSPACE[key] = torch.zeros(nbytes // 4, dtype=torch.int32, device=device)
    return _WORKSPACE[key]


@functools.cache
def load_mha_int8() -> ctypes.CDLL:
    """Build (first use) and load ``csrc/mha_int8.cu`` (K10)."""
    lib = load_library("mha_int8", ["mha_int8.cu"])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.t2s_mha_int8.argtypes = [P] * 10 + [I] * 7 + [P]
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
    """The raw handle of the current stream of t's card: what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    building a Stream object at every launch (the engine makes some 23000
    launches a request, and its host time is what the request waits on)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _on_card(t: torch.Tensor):
    """Makes t's card the current device for a launch, unless it already is
    (entering ``torch.cuda.device`` at every launch costs host time too)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def dense(lib, a: torch.Tensor, ws: Sequence, outs: Sequence[torch.Tensor], *,
          amode: int = PANEL, norm: str = "none", epi: int = EPI_STORE,
          mod: Optional[torch.Tensor] = None, s: Optional[float] = None,
          amax_in: Optional[torch.Tensor] = None, residual: Optional[torch.Tensor] = None,
          gelu: bool = False, amax_out: Optional[torch.Tensor] = None,
          s_out: Optional[float] = None, nch: int = 1, w4: bool = False, probe: int = 0,
          amax_floor: float = 0.0) -> None:
    """One ``t2s_int8_dense`` launch of ``lib`` (``load_kernel`` or
    ``load_probe_kernel``; see the function's comment in ``csrc/int8_block.cu``)
    on tensors the caller has checked. The dtypes of ``residual`` and ``outs``
    (bf16 or f32) pick the kernel's loads and stores; ``a`` is (M, K), bf16 for
    the panel, int8 for the int8 A mode. ``probe`` holds the T2 probe's
    ``EF_*`` flags, ``amax_floor`` the floor of ``EF_MID_BF16``'s row max."""
    M, K = a.shape
    N = ws[0].w_q.shape[0]
    s_static, inv, is_static = _static_args(s)
    out_inv = _static_args(s_out)[1]
    wargs = []
    for i in range(3):
        if i < len(ws):
            wargs += [ws[i].w_q.data_ptr(), ws[i].scale.data_ptr(), ws[i].bias.data_ptr(),
                      outs[i].data_ptr()]
        else:
            wargs += [None] * 4
    f32 = lambda t: int(t is not None and t.dtype == torch.float32)
    ws_ptr = workspace(a.device).data_ptr()
    with _on_card(a):
        err = lib.t2s_int8_dense(amode, _NORM[norm], int(w4), epi, a.data_ptr(),
                                 _ptr(mod), _ptr(amax_in), s_static, inv, is_static, len(ws),
                                 *wargs, _ptr(residual), f32(residual), int(gelu), f32(outs[0]),
                                 _ptr(amax_out), out_inv, nch, M, K, N, probe,
                                 float(np.float32(amax_floor)), ws_ptr, _stream(a))
    if err != 0:
        raise RuntimeError(f"int8 dense kernel launch failed: cudaError {err}")


def quant_rows(lib, x: torch.Tensor, mod: Optional[torch.Tensor], s: Optional[float],
               norm: str = "adaln") -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The row pass on checked tensors: x (M, K) bf16 or f32 [-> ``norm``
    ("adaln" or "ln") with ``mod`` (2, K) f32] -> (q (M, K) int8, amax (M,)
    f32 row max |h|, or None under the static scale ``s``)."""
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    amax = None if s is not None else torch.empty((M,), dtype=torch.float32, device=x.device)
    _, inv, is_static = _static_args(s)
    with _on_card(x):
        err = lib.t2s_int8_quant_rows(0 if mod is None else _NORM[norm], x.data_ptr(),
                                      int(x.dtype == torch.float32), _ptr(mod), M, K, inv,
                                      is_static, q.data_ptr(), _ptr(amax), _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize pass launch failed: cudaError {err}")
    return q, amax


def quant_wide(lib, x: torch.Tensor, s: Optional[float], amax: Optional[torch.Tensor] = None,
               qbf: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The wide pass of ``lib`` on checked tensors: x (M, K) bf16 or f32, or
    (3, M, K) f32 whose planes it sums (the probe library's) -> (q (M, K)
    int8, the row maxima): under the static scale ``s`` (None); with ``amax``
    (M, nch) f32, each chunk of K / nch columns quantized with its own row
    scale (``amax`` itself); else the row's own max |x| (a new (M,) f32).
    ``qbf``: the probe library's bf16 row scale and quotient (T2 mid_bf16)."""
    M, K = x.shape[-2:]
    kind = 2 if x.dim() == 3 else int(x.dtype == torch.float32)
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    own = None if s is not None or amax is not None else torch.empty((M,), dtype=torch.float32,
                                                                      device=x.device)
    _, inv, is_static = _static_args(s)
    nch = 1 if amax is None else amax.shape[-1]
    with _on_card(x):
        err = lib.t2s_int8_quant_wide(x.data_ptr(), kind, M, K, nch, _ptr(amax), inv, is_static,
                                      int(qbf), q.data_ptr(), _ptr(own), _stream(x))
    if err != 0:
        raise RuntimeError(f"wide quantize pass launch failed: cudaError {err}")
    return q, (amax if own is None else own)


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
        kv_valid: int, mode: str = "bf16") -> torch.Tensor:
    """The bf16 attention launch on checked bf16 tensors: q (B*Lq, D), k/v
    (B*Lkv, D). ``mode`` (``MHA_MODES``): "bf16" and "bf16_fold"
    (``attention.mha_reference``, the divide before or after P V), "pair"
    (``attention.mha_pair_reference``), T3's "pair_nofold", "no_softmax",
    "no_av" and "no_scores" (``attn_ablate.mha_probe_reference``);
    all but the first two take a head width of 64 only."""
    M, D = q.shape
    out = torch.empty_like(q)
    with _on_card(q):
        err = lib.t2s_int8_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), batch,
                               M // batch, k.shape[0] // batch, n_head, D // n_head, kv_valid,
                               MHA_MODES[mode], _stream(q))
    if err != 0:
        raise RuntimeError(f"int8 attention kernel launch failed: cudaError {err}")
    return out


# K10's key buckets (``key_bucket`` in csrc/mha_int8.cu): P V steps 32 keys at
# a time, so each is a multiple of 32; Q K^T runs one int8 wgmma width N per
# part (int8 wgmma takes N = 8, 16, 24 and the multiples of 16 up to 256)
_INT8_BUCKETS = ((32, (32,)), (96, (96,)), (160, (160,)), (288, (144, 144)))


def mha_int8_keys(keys: int) -> Tuple[int, Tuple[int, ...]]:
    """K10's key bucket for ``keys`` (1..272): (the padded key count, the
    wgmma widths N its Q K^T is split into)."""
    if not 0 < keys <= 272:
        raise ValueError(f"K10 takes 1 to 272 keys, got {keys}")
    return next((pad, parts) for pad, parts in _INT8_BUCKETS if keys <= pad)


def key_slots(padded: int) -> torch.Tensor:
    """The key at each k slot of K10's P V (``key_slot`` in csrc/mha_int8.cu):
    within each 32-key group slot 4t + 2e + f holds key 8e + 2t + f, and the
    same in the upper 16, the order in which the score accumulator's
    registers pack into P V's A fragment."""
    slot = torch.arange(padded)
    r = slot % 16
    t, e, f = r // 4, (r % 4) // 2, r % 2
    return slot - r + 8 * e + 2 * t + f


def vt_slot_layout(vq: torch.Tensor, batch: int) -> torch.Tensor:
    """The V^T that K10's quantize pass writes, from int8 V (B*Lkv, D): (B, D,
    padded) int8, per batch element and column its keys innermost, zero-padded
    to the key bucket and in ``key_slots`` order (the P V wgmma's B operand,
    K-major, for each head its hd rows)."""
    Lkv, D = vq.shape[0] // batch, vq.shape[1]
    padded, _ = mha_int8_keys(Lkv)
    vt = torch.zeros((batch, D, padded), dtype=vq.dtype, device=vq.device)
    vt[:, :, :Lkv] = vq.reshape(batch, Lkv, D).transpose(1, 2)
    return vt[:, :, key_slots(padded).to(vq.device)].contiguous()


def mha_int8(lib, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, batch: int, n_head: int,
             kv_valid: int, scratch: Optional[dict] = None) -> torch.Tensor:
    """K10's two launches on checked bf16 tensors: the quantize pass (int8 q
    and k with row scales; V^T as ``vt_slot_layout`` lays it out, one scale
    per (batch, column)) into scratch allocated here, one buffer (the host's
    time per launch is what the int8 requests wait on), then the int8 MHA ->
    (B*Lq, D) bf16. ``scratch``, when given, receives views of the scratch by
    name."""
    M, D = q.shape
    Mkv = k.shape[0]
    padded, _ = mha_int8_keys(Mkv // batch)
    # bytes of qq, kq, vt (int8) and sq, sk, sv (f32), each part 16-byte aligned
    sizes = (M * D, Mkv * D, batch * D * padded, 4 * M, 4 * Mkv, 4 * batch * D)
    offsets = [0]
    for n in sizes[:-1]:
        offsets.append(offsets[-1] + (n + 15) // 16 * 16)
    buf = torch.empty((offsets[-1] + sizes[-1],), dtype=torch.uint8, device=q.device)
    base = buf.data_ptr()
    out = torch.empty_like(q)
    with _on_card(q):
        err = lib.t2s_mha_int8(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                               *(base + o for o in offsets), batch, M // batch, Mkv // batch,
                               n_head, D // n_head, kv_valid, padded, _stream(q))
    if scratch is not None:
        shapes = ((M, D), (Mkv, D), (batch, D, padded), (M,), (Mkv,), (batch, D))
        for i, name in enumerate(("qq", "kq", "vt", "sq", "sk", "sv")):
            part = buf[offsets[i]:offsets[i] + sizes[i]]
            scratch[name] = part.view(torch.int8 if i < 3 else torch.float32).view(shapes[i])
    if err != 0:
        raise RuntimeError(f"int8 MHA kernel launch failed: cudaError {err}")
    return out
