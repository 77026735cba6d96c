"""T2, the MLP ablation probe, against the JAX package; and the port's tool.

Each plain twin of a variant that computes another function than K3
(``ops/mlp_ablate.py::mlp_variant_reference``), and its wrapper on a CPU
tensor, is held against JAX ``tools/bench_mlp_ablate.py::make_variant`` run
in TPU interpret mode on the CPU, with the tool's module-level M, D, DH cut
to 272 x 128 x 512 (the tool's block of 272 rows, one program). The tool's
other names are held, through the port tool's own dispatch, against the JAX
functions its ``main`` runs for them: K3's twin against ``make_variant``'s
default and ``mlp_block``, K9's against ``make_skewed`` and the chunked and
streamed blocks, K3's W4 path on ``pack_w16``'s bytes against ``make_w4``;
``pack_w16`` is held to the bytes ``make_w4`` hands its kernel, bit for bit.
The CUDA configurations are checked against the same twins on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).

Tolerances. ``dots_only`` is integers throughout (an int8 cast of x, wrapped
int8 middle, int32 sums; |sum| < 2^24, so its bf16 rounding is one
rounding of an exact integer): equal. Every other variant is an int8 block:
its f32 LayerNorm, GELU and scale arithmetic run in another order than
XLA's, so an ulp can move a value across a .5 step of an int8 grid and an
output by a few bf16 ulps; they are held to K3's block tolerance, BLOCK_TOL
(rtol = atol, as tests/test_torch_int8_blocks.py). The ``mid_bf16*`` twins
round every op of the middle to bf16, as JAX runs them eagerly; in the
interpreted kernel XLA keeps f32 between some of those ops (its excess
precision), so about half of the middle's int8 values move by one step
there. One step of the 512 summed into each output moves it by s_u * |w2|
<= amax_u / 127 * 127 * scale, a fraction of a bf16 ulp at the output's
scale, and the steps do not add up in one direction: MID_BF16_TOL, the block
tolerance, holds them (observed max |d| 3.1e-2 at outputs up to 4.3).
"""

import importlib.util
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from text_to_sound_synthesis_tpu.ops import int8_block as JB
from text_to_sound_synthesis_tpu.ops import quant as JQ
from text_to_sound_synthesis_torch.ops import int8_block as TB
from text_to_sound_synthesis_torch.ops import mlp_ablate as T2
from text_to_sound_synthesis_torch.ops.quant import QuantizedWeight, unpack_weight_w4
from text_to_sound_synthesis_torch.tools import bench_mlp_ablate as tool

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(M=272, D=128, DH=512)
BLOCK_TOL = 2e-2
MID_BF16_TOL = BLOCK_TOL
TOL = {v: 0.0 if v == "dots_only" else MID_BF16_TOL if v.startswith("mid_bf16") else BLOCK_TOL
       for v in T2.FUNCTIONS}


@pytest.fixture(scope="module")
def jt():
    """The JAX tool, loaded by path, at SMALL."""
    spec = importlib.util.spec_from_file_location("_jax_tool_bench_mlp_ablate",
                                                  REPO / "tools" / "bench_mlp_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in SMALL.items():
        setattr(mod, k, v)
    return mod


def _tw(jw):
    """JAX QuantizedWeight (K, N) -> the port's (N, K), same int8 values."""
    return QuantizedWeight(torch.from_numpy(np.array(jw.w_q).T.copy()),
                           torch.from_numpy(np.array(jw.scale)[0]),
                           torch.from_numpy(np.array(jw.bias)[0]))


def _inputs(M, seed=0):
    """bf16 x (M, D), LayerNorm rows, W8 fc1 / fc2 with biases: (JAX, port)."""
    rng = np.random.default_rng(seed)
    D, DH = SMALL["D"], SMALL["DH"]
    xj = jnp.asarray(rng.standard_normal((M, D)).astype(np.float32), jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    mod = np.stack([1 + 0.2 * rng.standard_normal(D), 0.2 * rng.standard_normal(D)]).astype(np.float32)
    w = lambda k, n: JQ.quantize_weight(
        jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32),
        jnp.asarray(rng.standard_normal(n) * 0.05, jnp.float32))
    w1, w2 = w(D, DH), w(DH, D)
    return (xj, jnp.asarray(mod), w1, w2), (xt, torch.from_numpy(mod), _tw(w1), _tw(w2))


def _run_jax(fn, x, mod, w1, w2):
    with pltpu.force_tpu_interpret_mode():
        return np.array(fn(x, mod, w1.w_q, w2.w_q, w1.scale, w2.scale, w1.bias,
                           w2.bias).astype(jnp.float32))


def _close(got, want, tol):
    got = got.float().numpy()
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", T2.FUNCTIONS)
def test_twin_and_wrapper_match_jax_make_variant(jt, variant):
    (xj, mj, w1, w2), (xt, mt, t1, t2) = _inputs(SMALL["M"])
    want = _run_jax(jt.make_variant(variant), xj, mj, w1, w2)
    launches = T2.mlp_variant.launches
    for got in (T2.mlp_variant_reference(xt, mt, t1, t2, variant=variant),
                T2.mlp_variant(xt, mt, t1, t2, variant=variant)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (SMALL["M"], SMALL["D"])
        _close(got, want, TOL[variant])
    assert T2.mlp_variant.launches == launches        # a CPU tensor runs the twin


def test_casts_follow_xla():
    """float -> int8 truncates and saturates (NaN to 0); int32 -> int8 keeps
    the low byte: the casts of ``dots_only`` and ``no_quant_mid``."""
    f = np.array([-300.0, -128.7, -2.9, -0.5, 0.0, 0.7, 2.5, 126.9, 127.6, 1e9, np.nan],
                 np.float32)
    np.testing.assert_array_equal(T2.cast_int8(torch.from_numpy(f)).numpy(),
                                  np.array(jnp.asarray(f).astype(jnp.int8)))
    i = np.array([-2 ** 31, -129, -128, -1, 0, 127, 128, 255, 256, 70000, 2 ** 31 - 1], np.int64)
    np.testing.assert_array_equal(T2.wrap_int8(torch.from_numpy(i)).numpy(),
                                  np.array(jnp.asarray(i.astype(np.int32)).astype(jnp.int8)))


def test_pack_w16_is_make_w4s_packing(jt, monkeypatch):
    """The bytes ``make_w4`` packs outside its kernel, caught at its
    ``pallas_call``: the port's ``pack_w16`` of the same W8 weight, bit for
    bit (the port's (N, K/2) layout is JAX's (K/2, N) transposed)."""
    (xj, mj, w1, w2), (_, _, t1, t2) = _inputs(SMALL["M"])
    seen = []

    def catch(*_, **__):
        return lambda *args: seen.append(args) or args[0]

    monkeypatch.setattr(jt.pl, "pallas_call", catch)
    jt.make_w4()(xj, mj, w1.w_q, w2.w_q, w1.scale, w2.scale, w1.bias, w2.bias)
    w1p, w2p = (np.array(a) for a in seen[0][2:4])
    for packed, t in ((w1p, t1), (w2p, t2)):
        p = T2.pack_w16(t)
        np.testing.assert_array_equal(p.w_q.numpy().T, packed)
        assert torch.equal(p.scale, t.scale) and torch.equal(p.bias, t.bias)
        want = torch.round(t.w_q.float() / 16).clamp(-7, 7).to(torch.int8)
        assert torch.equal(unpack_weight_w4(p).w_q, want)


# name -> the JAX function the JAX tool's ``main`` runs for it, as (x, mod,
# w1q, w2q, s1, s2, b1, b2) -> y; and the rows it needs
def _jax_fn(jt, name, w1, w2, mod):
    lib = lambda f, **kw: (lambda x, *a: f(x, mod, w1, w2, **kw))
    parts = name.split("_")
    num = lambda p, d: next((int(s[1:]) for s in parts if s.startswith(p) and s[1:].isdigit()), d)
    ss = (0.05, 0.05) if "static" in parts else None
    if name == "lib_base":
        return lib(JB.mlp_block, block_m=272)
    if name == "lib_static":
        return lib(JB.mlp_block, block_m=272, static_s=(0.05, 0.05))
    if name.startswith("lib_chunked"):
        return lib(JB.mlp_block_chunked, block_m=544, n_chunks=4, static_s=ss)
    if name.startswith("streamed"):
        return lib(JB.mlp_block_streamed, block_m=num("b", 1088), n_chunks=num("c", 16), static_s=ss)
    if name.startswith("w4"):
        return jt.make_w4(static="static" in parts, scratch="scratch" in parts, i32="i32" in parts,
                          block_m=num("b", 272))
    if name.startswith(("skew", "ctrl")):
        return jt.make_skewed(n_chunks=int(parts[0][4:]), static="static" in parts,
                              block_m=num("b", 272), skew=name.startswith("skew"))
    return jt.make_variant(name)


SCHEDULE = {   # name -> (rows, tolerance): the JAX tool's names that compute K3 or K9
    "full": 272, "lib_base": 272, "lib_static": 272, "no_such_stage": 272,
    "lib_chunked": 544, "lib_chunked_static": 544, "skew4": 272, "ctrl8_static": 272,
    "skew4_static_b544": 544, "streamed_c4_b272": 272, "streamed_static_c8_b544": 544,
    "w4": 272, "w4_static": 272, "w4_scratch_i32_b136": 272,
}


@pytest.mark.parametrize("name", list(SCHEDULE))
def test_schedule_names_run_their_base_function(jt, monkeypatch, name):
    """Through the port tool's dispatch, on a CPU tensor (the twin of the
    kernel it names), against the JAX function the JAX tool runs."""
    M = SCHEDULE[name]
    monkeypatch.setattr(jt, "M", M)
    (xj, mj, w1, w2), (xt, mt, t1, t2) = _inputs(M, seed=1)
    call, twin, what = tool.variant(name, mt, t1, t2)
    assert ("T2" in what) == (name in T2.FUNCTIONS)
    assert name.startswith("w4") or "schedule-only" in what
    want = _run_jax(_jax_fn(jt, name, w1, w2, mj), xj, mj, w1, w2)
    got = call(xt)
    assert torch.equal(got, twin(xt))
    _close(got, want, BLOCK_TOL)


def test_every_name_is_labelled(jt):
    """The JAX tool's defaults are the port's; every name runs a T2
    configuration, K3's W4 path, or is said to be schedule-only."""
    src = inspect.getsource(jt.main)
    assert all(f'"{n}"' in src for n in tool.DEFAULTS)
    assert (tool.M, tool.D, tool.DH, tool.ITERS) == (2176, 1024, 4096, jt.ITERS)
    _, (_, mt, t1, t2) = _inputs(8)
    for name in list(T2.FUNCTIONS) + list(SCHEDULE) + ["skew8_b544", "ctrl4", "streamed"]:
        _, _, what = tool.variant(name, mt, t1, t2)
        assert what.startswith(("T2", "K3's W4", "schedule-only on this card: runs K"))


def test_variant_refuses_unknown_names():
    x = torch.zeros((8, 128), dtype=torch.bfloat16)
    w = QuantizedWeight(torch.zeros((128, 128), dtype=torch.int8), torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="variant"):
        T2.mlp_variant(x, torch.zeros(2, 128), w, w, variant="full")
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        T2.mlp_variant(x.to("meta"), torch.zeros(2, 128, device="meta"), w, w, variant="no_gelu")


def test_tool_exits_nonzero_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "text_to_sound_synthesis_torch.tools.bench_mlp_ablate",
                           "dots_only"], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr and proc.stdout == ""
