"""The chip's published peaks, and the operations and bytes of the work a cell does.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W. The
int8 engine's per-site bounds are ``chip_smoke.py::kernel_bounds``'
arithmetic, with the batch a parameter: each site's least time is the
largest of its bytes over the memory's rate, its tensor-core products over
their peaks (int8 and bf16 one after the other), and its f32 work over the
f32 peak. Operation counts of the float parts are taken with
``torch.utils.flop_counter`` on the references' functions over meta tensors,
so they follow the configuration's shapes and not the kernels that run them.
"""

import torch
from torch.utils.flop_counter import FlopCounterMode

HBM_BYTES_PER_S = 3.35e12
PEAK = {"int8": 1979e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}
SAMPLER_OPS = 16        # f32 operations per class and row of a sampler step


def site_bound(nbytes, **ops) -> float:
    """Least seconds for ``nbytes`` moved and ``ops`` operations by type."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_mma = sum(n / PEAK[kind] for kind, n in ops.items() if kind != "f32")
    return max(t_bytes, t_mma, ops.get("f32", 0) / PEAK["f32"])


def int8_step_bound(batch: int, L: int, S: int, D: int, n_head: int, n_layer: int,
                    classes: int) -> float:
    """Least seconds of one step of the W4A8 static engine: per layer the
    self-attention block (K4), the cross-attention block (K5) and the MLP
    block (K3) with their quantize passes and pair MHAs, then the step tail
    (K2: final LayerNorm, head and sampler)."""
    F, C = 4 * D, classes
    M, Ms, hd = batch * L, batch * S, D // n_head
    act = lambda rows, width: 2 * rows * width               # bf16 activations
    w4 = lambda n, k: n * k // 2 + 8 * n                      # nibble-packed int4, f32 scale + bias
    norm = 8 * M * D                                          # LayerNorm + quantize, f32
    mma = lambda keys: 4 * batch * n_head * L * keys * hd     # Q K^T and P V
    soft = lambda keys: 5 * batch * n_head * L * keys         # f32 softmax
    mlp = site_bound(2 * act(M, D) + 8 * D + w4(F, D) + w4(D, F), int8=4 * M * D * F,
                     f32=norm + 8 * M * F + 4 * M * D)
    self_attn = site_bound(2 * act(M, D) + 8 * D + 4 * w4(D, D), int8=8 * M * D * D,
                           bf16=mma(L), f32=norm + soft(L) + 4 * M * D)
    cross_attn = site_bound(2 * act(M, D) + 8 * D + 2 * act(Ms, D) + 2 * w4(D, D),
                            int8=4 * M * D * D, bf16=mma(S), f32=norm + soft(S) + 4 * M * D)
    tail = site_bound(act(M, D) + 8 * D + 2 * D * C + 4 * C + 8 * M, bf16=2 * M * D * C,
                      f32=norm + M * (C + 1) * SAMPLER_OPS)
    return n_layer * (mlp + self_attn + cross_attn) + tail


def sampler_step_ops(batch: int, L: int, S: int, D: int, n_head: int, n_layer: int,
                     classes: int) -> dict:
    """Tensor-core operations of one sampler step: ``dense``, the eight dense
    products a layer (q, k, v, proj, cross q, cross proj, fc1, fc2), and
    ``attn_head``, the attention products and the head. The W4A8 engine runs
    the first in int8 and the second in bf16; the bf16 engine both in bf16."""
    M, hd = batch * L, D // n_head
    dots = 2 * M * D * (4 * D + 2 * D + 2 * 4 * D)
    attn = 4 * batch * n_head * L * (L + S) * hd
    return {"dense": n_layer * dots, "attn_head": n_layer * attn + 2 * M * D * (classes - 1)}


def counted_flops(fn, *args, **kwargs) -> int:
    """Floating-point operations of ``fn(*args, **kwargs)`` (matmuls and
    convolutions, 2 a multiply-add), counted on whatever device the
    arguments are on (the meta device costs nothing)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def least_seconds(ops: dict) -> float:
    """Seconds that ``ops`` (operations by precision) take at the published peaks."""
    return sum(n / PEAK[kind] for kind, n in ops.items())


def meta_like(weights: dict) -> dict:
    """The same names and shapes, on the meta device."""
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in weights.items()}
