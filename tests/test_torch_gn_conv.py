"""K11, the fused GroupNorm -> swish -> 3x3 conv, against the JAX package.

The port's plain twin (``gn_swish_conv_reference``) and its wrapper on a CPU
tensor (which runs the twin) are held against JAX's
``gn_swish_conv_reference`` and against JAX's Pallas kernel run as its own
tests run it on the CPU, in interpret mode (``T2S_FUSED_GN=interpret``), on
the same numpy inputs: at the JAX test's shapes, with the conv's zero ring
under a large beta, per-batch statistics, JAX's multi-row-block halo path,
and the custom VJP against ``jax.grad``. The port's own VQGAN
``ResnetBlock`` first half is held against the twin on its converted
weights. The CUDA kernel is checked against the same twin on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Tolerances. f32: 1e-5 (rtol and atol), as the JAX tests: the same f32
arithmetic, summed in another order by two convolution libraries (observed
up to 2.7e-6 at outputs of order 1). bf16: 5e-2, the JAX test's: an f32 ulp
of an activation can round it to the other bf16 neighbour, and the output is
rounded once to bf16. Gradients: 1e-4, the JAX test's.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from text_to_sound_synthesis_tpu.ops import fused_gn_conv as J
from text_to_sound_synthesis_torch.models.vqgan.modules import ResnetBlock, swish
from text_to_sound_synthesis_torch.ops import fused_gn_conv as T

torch.set_num_threads(1)

F32_TOL, BF16_TOL, GRAD_TOL = 1e-5, 5e-2, 1e-4
# the JAX test's shapes: (B, H, W, C, Co, groups)
JAX_SHAPES = [(2, 8, 16, 32, 48, 8), (1, 5, 53, 64, 64, 32), (2, 3, 7, 16, 16, 4)]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("T2S_FUSED_GN", "interpret")


def _inputs(B, H, W, C, Co, seed=0, beta_shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32), rng.randn(C).astype(np.float32),
            (rng.randn(C) + beta_shift).astype(np.float32),
            (rng.randn(3, 3, C, Co) * 0.05).astype(np.float32), rng.randn(Co).astype(np.float32))


def _jax(args, dtype=jnp.float32):
    x, *rest = args
    return (jnp.asarray(x, dtype), *map(jnp.asarray, rest))


def _torch(args, dtype=torch.float32):
    x, *rest = args
    return (torch.from_numpy(x).to(dtype), *map(torch.from_numpy, rest))


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("shape", JAX_SHAPES)
def test_twin_and_wrapper_match_jax_f32(shape):
    B, H, W, C, Co, G = shape
    args = _inputs(B, H, W, C, Co)
    want_ref = J.gn_swish_conv_reference(*_jax(args), groups=G)
    want_kernel = J.gn_swish_conv(*_jax(args), groups=G)          # Pallas, interpret mode
    twin = T.gn_swish_conv_reference(*_torch(args), groups=G)
    launches = T.gn_swish_conv.launches
    wrapped = T.gn_swish_conv(*_torch(args), groups=G)
    assert T.gn_swish_conv.launches == launches     # a CPU tensor runs the twin, no launch
    assert wrapped.dtype == torch.float32 and tuple(wrapped.shape) == (B, H, W, Co)
    for got in (twin, wrapped):
        for want in (want_ref, want_kernel):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", [(2, 6, 10, 16, 16, 4)] + JAX_SHAPES)
def test_twin_matches_jax_bf16(shape):
    B, H, W, C, Co, G = shape
    args = _inputs(B, H, W, C, Co, seed=1)
    got = T.gn_swish_conv(*_torch(args, torch.bfloat16), groups=G)
    assert got.dtype == torch.bfloat16
    for want in (J.gn_swish_conv_reference(*_jax(args, jnp.bfloat16), groups=G),
                 J.gn_swish_conv(*_jax(args, jnp.bfloat16), groups=G)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_affine_matches_jax(dtype):
    x, gamma, beta, _, _ = _inputs(2, 5, 7, 32, 32, seed=2)
    x[1] = x[1] * 10 + 3                # fast variance with a large mean
    scale, shift = T.gn_affine(torch.from_numpy(x).to(getattr(torch, dtype)),
                               torch.from_numpy(gamma), torch.from_numpy(beta), 8)
    js, jsh = J.gn_affine(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(gamma),
                          jnp.asarray(beta), 8)
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(shift.numpy(), np.asarray(jsh), rtol=F32_TOL, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_ring_with_large_beta(dtype):
    """Taps outside the image contribute 0, not swish(shift): with beta near
    6, swish(shift) is about 6, so a ring of swish(shift) would move every
    border output by far more than the tolerance."""
    B, H, W, C, Co, G = 1, 4, 6, 16, 16, 4
    args = _inputs(B, H, W, C, Co, seed=3, beta_shift=6.0)
    x, gamma, beta, k, b = _torch(args, dtype)
    got = T.gn_swish_conv(x, gamma, beta, k, b, groups=G)
    scale, shift = T.gn_affine(x, gamma, beta, G)
    a = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    a = (a * torch.sigmoid(a)).to(dtype).float()
    kf = k.to(dtype).float()

    def conv_of_padded(ap):        # the 3x3 conv of an explicitly padded (B, H+2, W+2, C)
        y = sum(torch.einsum("bhwc,co->bhwo", ap[:, dy:dy + H, dx:dx + W], kf[dy, dx])
                for dy in range(3) for dx in range(3))
        return (y + b).to(dtype)

    tol = F32_TOL * 10 if dtype == torch.float32 else BF16_TOL
    zero_ring = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    np.testing.assert_allclose(_f32(got), _f32(conv_of_padded(zero_ring)), rtol=tol, atol=tol)
    want = J.gn_swish_conv(*_jax(args, jnp.float32 if dtype == torch.float32 else jnp.bfloat16),
                           groups=G)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # a ring of swish(shift) (the activation of a zero input) lies far outside it
    bad_ring = zero_ring.clone()
    ring_act = (shift * torch.sigmoid(shift)).to(dtype).float()[:, None, :]
    bad_ring[:, 0], bad_ring[:, -1] = ring_act, ring_act
    bad_ring[:, :, 0], bad_ring[:, :, -1] = ring_act, ring_act
    assert float((got.float() - conv_of_padded(bad_ring).float()).abs().max()) > 10 * tol


def test_per_batch_statistics():
    """Each batch element is normalised with its own group statistics."""
    B, H, W, C, Co, G = 2, 4, 8, 8, 8, 2
    x, gamma, beta, k, b = _inputs(B, H, W, C, Co, seed=5)
    x[1] = x[1] * 10 + 3
    args = (x, gamma, beta, k, b)
    y = T.gn_swish_conv(*_torch(args), groups=G)
    for i in range(B):
        one = T.gn_swish_conv(*_torch((x[i:i + 1], gamma, beta, k, b)), groups=G)
        np.testing.assert_allclose(y[i].numpy(), one[0].numpy(), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(y.numpy(), _f32(J.gn_swish_conv(*_jax(args), groups=G)),
                               rtol=F32_TOL, atol=F32_TOL)


def test_jax_multi_row_block_path(monkeypatch):
    """JAX's kernel with several row blocks (its clamped top / bottom halo
    specs and edge predicates run, as at the flagship's H = 80) against the
    port's twin."""
    monkeypatch.setattr(J, "_VMEM_BUDGET", 220 * 1024)
    B, H, W, C, Co, G = 2, 8, 16, 32, 32, 8
    args = _inputs(B, H, W, C, Co, seed=11)
    bh = J._pick_bh(H, W, C, Co, 4)
    assert 1 <= bh < H, bh
    want = J.gn_swish_conv(*_jax(args), groups=G)
    got = T.gn_swish_conv(*_torch(args), groups=G)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=F32_TOL, atol=F32_TOL)


def test_function_grads_match_jax_grad():
    """The Function's backward (the twin's VJP) against ``jax.grad`` of JAX
    ``gn_swish_conv`` (its custom VJP) in interpret mode, loss sum(y^2)."""
    B, H, W, C, Co, G = 2, 6, 8, 16, 16, 4
    args = _inputs(B, H, W, C, Co, seed=7)
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.square(J.gn_swish_conv(*a, groups=G))),
                      argnums=(0, 1, 2, 3, 4))(*_jax(args))
    leaves = [t.requires_grad_(True) for t in _torch(args)]
    T.gn_swish_conv(*leaves, groups=G).square().sum().backward()
    for leaf, want in zip(leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_function_grads_only_where_asked():
    B, H, W, C, Co, G = 1, 3, 5, 16, 16, 4
    x, gamma, beta, k, b = _torch(_inputs(B, H, W, C, Co, seed=8))
    k.requires_grad_(True)
    T.gn_swish_conv(x, gamma, beta, k, b, groups=G).sum().backward()
    assert k.grad is not None and k.grad.shape == k.shape
    assert x.grad is None and gamma.grad is None


def test_resnet_block_first_half_matches_twin():
    """The port's ``ResnetBlock``: conv1(swish(norm1(x))) in NCHW with torch's
    two-pass GroupNorm, against the twin on its weights in the JAX layout
    (gamma, beta, HWIO kernel, bias)."""
    torch.manual_seed(0)
    C, Co = 64, 128
    blk = ResnetBlock(C, Co)
    with torch.no_grad():
        blk.norm1.weight.copy_(torch.randn(C))
        blk.norm1.bias.copy_(torch.randn(C))
    x = torch.from_numpy(np.random.RandomState(9).randn(2, C, 5, 13).astype(np.float32))
    with torch.no_grad():
        want = blk.conv1(swish(blk.norm1(x))).permute(0, 2, 3, 1)
        got = T.gn_swish_conv(x.permute(0, 2, 3, 1).contiguous(), blk.norm1.weight,
                              blk.norm1.bias, blk.conv1.weight.permute(2, 3, 1, 0),
                              blk.conv1.bias, groups=blk.norm1.num_groups)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_fused_gn_eligible(monkeypatch):
    monkeypatch.setenv("T2S_FUSED_GN", "0")
    assert not T.fused_gn_eligible((2, 8, 16, 128), 128)
    monkeypatch.setenv("T2S_FUSED_GN", "interpret")
    assert T.fused_gn_eligible((2, 8, 16, 32), 48)
    assert not T.fused_gn_eligible((2, 0, 16, 32), 48)
    monkeypatch.delenv("T2S_FUSED_GN")
    assert not T.fused_gn_eligible((2, 8, 16, 128), 128)      # default off, as JAX's
    monkeypatch.setenv("T2S_FUSED_GN", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not T.fused_gn_eligible((8, 80, 848, 128), 128)    # no card, as JAX off the TPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for shape, co, want in [((8, 80, 848, 128), 128, True), ((8, 5, 53, 512), 512, True),
                            ((8, 5, 53, 48), 128, False), ((8, 5, 53, 128), 64, False),
                            ((8, 5, 53, 4096), 128, False), ((8, 5, 0, 128), 128, False)]:
        assert T.fused_gn_eligible(shape, co) is want, (shape, co)
    # the shapes the kernel takes are the ones its wrapper does not refuse
    x = torch.zeros((8, 5, 53, 512), dtype=torch.bfloat16)
    T._check_kernel_args(x, torch.ones(512), torch.zeros(512), torch.zeros(3, 3, 512, 512),
                         torch.zeros(512), 32)


def test_kernel_args_refused():
    """What the CUDA path refuses, checked before any launch; other devices
    than cpu and cuda raise in the wrapper."""
    x = torch.zeros((1, 4, 5, 64), dtype=torch.bfloat16)
    ok = (torch.ones(64), torch.zeros(64), torch.zeros(3, 3, 64, 128), torch.zeros(128))
    T._check_kernel_args(x, *ok, 32)
    with pytest.raises(TypeError):
        T._check_kernel_args(x.float(), *ok, 32)                # f32 on the card
    with pytest.raises(ValueError):
        T._check_kernel_args(torch.zeros((1, 4, 5, 48), dtype=torch.bfloat16), torch.ones(48),
                             torch.zeros(48), torch.zeros(3, 3, 48, 128), torch.zeros(128), 16)
    with pytest.raises(ValueError):
        T._check_kernel_args(x, ok[0], ok[1], torch.zeros(3, 3, 64, 96), torch.zeros(96), 32)
    with pytest.raises(ValueError):
        T._check_kernel_args(x, *ok, 24)                        # groups not dividing C
    with pytest.raises(ValueError):
        T.gn_swish_conv(x.to("meta"), *(t.to("meta") for t in ok), groups=32)


def _load_jax_tool(name):
    path = Path(__file__).resolve().parent.parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tool_tables_match_jax_tool():
    from text_to_sound_synthesis_torch.tools import bench_gn_conv as port

    jax_tool = _load_jax_tool("bench_gn_conv")
    assert port.SHAPES == jax_tool.SHAPES
    assert (port.B, port.GROUPS) == (jax_tool.B, jax_tool.GROUPS)
    for H, W, C in port.SHAPES:        # every stage is inside the kernel's limits
        T._check_kernel_args(torch.zeros((port.B, H, W, C), dtype=torch.bfloat16),
                             torch.ones(C), torch.zeros(C), torch.zeros(3, 3, C, C),
                             torch.zeros(C), port.GROUPS)


# The conv launch's host-side plan (ops/fused_gn_conv.py::conv_plan,
# stat_chunks) at the decoder's five stages (batch 8, C == Co) and at the
# kernel's limits: C 32 and 2048, W 1, H 1, B 1, a wide and a tall image,
# the channel transitions 512 -> 256 and 256 -> 128.
PLAN_SHAPES = [(8, 5, 53, 512, 512), (8, 10, 106, 256, 256), (8, 20, 212, 256, 256),
               (8, 40, 424, 128, 128), (8, 80, 848, 128, 128), (8, 10, 106, 512, 256),
               (8, 40, 424, 256, 128), (2, 5, 53, 32, 128), (2, 5, 53, 2048, 128),
               (1, 7, 1, 64, 128), (3, 1, 9, 64, 128), (1, 1, 1, 32, 128), (1, 3, 5000, 64, 128),
               (2, 3000, 3, 64, 256), (65535, 1, 2, 32, 128)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_conv_plan_fits_the_kernel(shape):
    B, H, W, C, Co = shape
    pitch, bm = T.conv_plan(B, H, W, C, Co)
    assert bm in (128, 256) and pitch >= 3
    assert bm + 2 * pitch + 2 <= T.HALO_ENTRIES            # the halo window fits a buffer
    tw = pitch - 2
    strips = -(-W // tw)
    assert strips * tw >= W and (strips - 1) * tw < W       # no empty strip
    assert T.conv_plan(B, H, W, C, Co, 132) == (pitch, bm)  # the default is the H100's SMs
    tiles = strips * -(-B * (H + 1) * pitch // bm) * (Co // 128)
    assert tiles < 2 ** 31


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_stat_chunks_cover_each_image(shape):
    B, H, W, C = shape[:4]
    n = T.stat_chunks(B, H * W, C)
    pix = -(-H * W // n)
    assert 1 <= n <= min(H * W, 65535)
    assert (n - 1) * pix < H * W <= n * pix                  # no empty chunk (the kernel checks)
    # about STAT_BLOCKS blocks of at least STAT_BYTES: ceil(HW / n) pixels a
    # chunk keeps at least half of the chunks asked for
    want = min(-(-T.STAT_BLOCKS // B), -(-H * W * 2 * C // T.STAT_BYTES), H * W, 65535)
    assert 2 * n >= want and n <= want


def test_conv_plan_at_the_decoder_stages():
    """The plans of the five stages: each wastes at most half of its tiles'
    pixels (junk columns, pad rows, the last tile), and a tile's halo window
    is under 2.5 times its pixels."""
    for B, H, W, C, Co in PLAN_SHAPES[:5]:
        pitch, bm = T.conv_plan(B, H, W, C, Co)
        tw = pitch - 2
        tiles = -(-W // tw) * -(-B * (H + 1) * pitch // bm)
        assert B * H * W / (tiles * bm) >= 0.5, (H, W, pitch, bm)
        assert (bm + 2 * pitch + 2) / bm < 2.5


def _emulate_conv(act, kernel, bias, pitch, bm, lanes=28):
    """The conv kernel's geometry in f64 on an activated input (B, H, W, C):
    strips of pitch - 2 columns, tiles of bm consecutive pixels over the
    virtual rows (a zero row after each image), each tile's halo window of
    bm + 2 pitch + 2 entries filled as the transform threads walk it (lane l
    takes entries l, l + lanes, ..., advancing column, row and image), the
    nine taps as offsets dy pitch + dx into the window, and the epilogue's
    decode of which rows are pixels."""
    B, H, W, C = act.shape
    Co = kernel.shape[-1]
    tw = pitch - 2
    ne = bm + 2 * pitch + 2
    y = torch.full((B, H, W, Co), float("nan"), dtype=torch.float64)
    mt = -(-B * (H + 1) * pitch // bm)
    for strip in range(-(-W // tw)):
        col0 = strip * tw
        for m in range(mt):
            q0 = m * bm
            row0 = q0 // pitch - 1
            off0 = q0 - (row0 + 1) * pitch
            halo = torch.zeros((ne, C), dtype=torch.float64)
            for ln in range(lanes):
                local = off0 + ln
                dr, col = divmod(local, pitch)
                row = row0 + dr
                b, h = (-1, H) if row < 0 else divmod(row, H + 1)
                for e in range(ln, ne, lanes):
                    w = col0 + col - 1
                    if 0 <= b < B and h < H and 0 <= w < W:
                        halo[e] = act[b, h, w]
                    col += lanes
                    while col >= pitch:
                        col -= pitch
                        h += 1
                        if h > H:
                            h, b = 0, b + 1
            rows = torch.arange(bm)
            acc = sum(halo[rows + dy * pitch + dx] @ kernel[dy, dx]
                      for dy in range(3) for dx in range(3))
            for r in range(bm):
                row, col = divmod(q0 + r, pitch)
                b, h = divmod(row, H + 1)
                if col < tw and col0 + col < W and h < H and b < B:
                    assert torch.isnan(y[b, h, col0 + col, 0])      # each pixel once
                    y[b, h, col0 + col] = acc[r] + bias
    return y


@pytest.mark.parametrize("shape,plan", [((2, 5, 13, 8, 4), (7, 128)), ((2, 5, 13, 8, 4), (15, 256)),
                                        ((1, 3, 1, 8, 4), (3, 128)), ((3, 1, 9, 8, 4), (5, 128)),
                                        ((2, 4, 11, 8, 4), (13, 128)), ((1, 40, 6, 8, 4), (8, 256))])
def test_conv_tiling_emulation_matches_conv(shape, plan):
    """The kernel's tiles, halo windows and taps, emulated, give the twin's
    conv of the zero-padded activation (f64): every pixel once, the zero ring
    from the pad rows between images and the out-of-image columns."""
    B, H, W, C, Co = shape
    rng = np.random.RandomState(7)
    act = torch.from_numpy(rng.randn(B, H, W, C))
    kernel = torch.from_numpy(rng.randn(3, 3, C, Co))
    bias = torch.from_numpy(rng.randn(Co))
    got = _emulate_conv(act, kernel, bias, *plan)
    want = torch.nn.functional.conv2d(act.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1) + bias
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
