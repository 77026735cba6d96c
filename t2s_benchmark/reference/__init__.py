"""Plain PyTorch references of the benchmarked models.

Each function reads its weights by name from a flat dict of tensors (the
state-dict names of Diffsound's ``DALLE``, SpecVQGAN's ``VQModel`` and
MelGAN's ``Generator``), computes in float32 and uses no kernel, cache or
batching of its own. Nothing here imports the program under test: the
references are written from the published model descriptions (VQ-Diffusion /
Diffsound, taming-transformers' VQGAN, MelGAN, CLIP) and from the semantics
the program documents (the sampler's Philox stream, the int8 quantizers'
rules). Run them with TF32 off (``full_f32``).
"""

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Matmuls and cuDNN convolutions in IEEE float32 (TF32 off) inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@contextlib.contextmanager
def tf32():
    """Matmuls and cuDNN convolutions in TF32 inside the block (the control of an f32 path)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


E4M3_MAX = 448.0
_FP8_OPS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.conv1d,
            torch.conv2d, torch.conv_transpose1d, torch.nn.functional.linear}


def fp8_round(x):
    """``x`` rounded to float8 e4m3, scaled by its own absolute maximum."""
    s = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s


class _Fp8(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in _FP8_OPS:
            args = (fp8_round(args[0]), fp8_round(args[1])) + tuple(args[2:])
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fp8():
    """Every matmul and convolution inside the block on its two operands rounded
    to float8 e4m3, each tensor on its own scale, and accumulated in float32
    (the control of a bf16 path)."""
    with full_f32(), _Fp8():
        yield


def layer_norm(x, weight=None, bias=None, eps=1e-6):
    """LayerNorm over the last axis, in the input's dtype."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y
