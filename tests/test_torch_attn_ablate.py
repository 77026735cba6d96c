"""T3, the self-attention ablation probe, against the JAX package; and the
port's tool.

Each plain twin of a variant that computes another function than K4
(``ops/attn_ablate.py::attn_variant_reference``), and its wrapper on a CPU
tensor, is held against the JAX ``tools/bench_attn_ablate.py`` kernel of that
name (``make_variant``, ``make_variant2``, ``make_rows2``) run in TPU
interpret mode on the CPU, with the tool's module-level B, Lp, D, H cut to 2,
272, 128, 2 (a head width of 64, as the pair MHA needs). The tool runs padded:
272 rows per batch element, the last 7 real queries whose keys are masked
(q_valid = Lp - 7). JAX's ``no_scores`` broadcasts q[:, :1] onto a group of
stacked head scores, which only fits one head a group, so it is held at one
head (hd 128). The tool's other names are held, through the port tool's own
dispatch, against the JAX functions its ``main`` runs for them: K4's twin
against the head groups, ``dots_first``, ``pair_qmask``, ``rows2[...]``,
``qkv_fused`` and the JAX block. The CUDA configurations are checked against
the same twins on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).

Tolerance: every variant is an int8 block whose f32 AdaLN, softmax and scale
arithmetic run in another order than XLA's, so an ulp can move a value
across a .5 step of an int8 grid and an output by a few bf16 ulps: K4's
block tolerance, BLOCK_TOL (rtol = atol, as tests/test_torch_int8_blocks.py;
observed max |d| 1.6e-2 at outputs up to 4.9).
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
from text_to_sound_synthesis_torch.ops import attention as TA
from text_to_sound_synthesis_torch.ops import attn_ablate as T3
from text_to_sound_synthesis_torch.ops.quant import QuantizedWeight
from text_to_sound_synthesis_torch.tools import bench_attn_ablate as tool

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
B, Lp, D = 2, 272, 128
BLOCK_TOL = 2e-2
STATIC = (0.05, 0.05)


@pytest.fixture(scope="module")
def jt():
    """The JAX tool, loaded by path, at 2 x 272 rows of width 128."""
    spec = importlib.util.spec_from_file_location("_jax_tool_bench_attn_ablate",
                                                  REPO / "tools" / "bench_attn_ablate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.Lp, mod.D, mod.H, mod.M = B, Lp, D, 2, B * Lp
    return mod


def _tw(jw):
    """JAX QuantizedWeight (K, N) -> the port's (N, K), same int8 values."""
    return QuantizedWeight(torch.from_numpy(np.array(jw.w_q).T.copy()),
                           torch.from_numpy(np.array(jw.scale)[0]),
                           torch.from_numpy(np.array(jw.bias)[0]))


@pytest.fixture(scope="module")
def inputs():
    """bf16 x (B*Lp, D), AdaLN rows, four W8 (D, D) weights with biases:
    (JAX, port)."""
    rng = np.random.default_rng(0)
    xj = jnp.asarray(rng.standard_normal((B * Lp, D)).astype(np.float32), jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    mod = (0.2 * rng.standard_normal((2, D))).astype(np.float32)
    ws = [JQ.quantize_weight(jnp.asarray(rng.standard_normal((D, D)) * 0.05, jnp.float32),
                             jnp.asarray(rng.standard_normal(D) * 0.05, jnp.float32))
          for _ in range(4)]
    return (xj, jnp.asarray(mod), ws), (xt, torch.from_numpy(mod), [_tw(w) for w in ws])


def _run_jax(fn, inputs):
    xj, mj, ws = inputs[0]
    args = [w.w_q for w in ws] + [w.scale for w in ws] + [w.bias for w in ws]
    with pltpu.force_tpu_interpret_mode():
        return np.array(fn(xj, mj, *args).astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BLOCK_TOL, atol=BLOCK_TOL)


# T3's functions: (JAX factory, port variant, heads, static scales)
FUNCTION_CASES = {
    "qkvp_dots_only": (lambda jt: jt.make_variant("qkvp_dots_only"), "qkvp_dots_only", 2, None),
    "no_softmax": (lambda jt: jt.make_variant("no_softmax"), "no_softmax", 2, None),
    "no_av": (lambda jt: jt.make_variant("no_av"), "no_av", 2, None),
    "no_scores": (lambda jt: jt.make_variant("no_scores"), "no_scores", 1, None),
    "pair_both": (lambda jt: jt.make_variant2("pair_both"), "pair", 2, None),
    "pair_nofold": (lambda jt: jt.make_variant2("pair_nofold"), "pair_nofold", 2, None),
    "rows2_pair": (lambda jt: jt.make_rows2(rows=2, pairmode=True), "pair", 2, None),
    "rows2_static_pairdeq": (lambda jt: jt.make_rows2(rows=2, pairdeq=True, static=True),
                             "pair", 2, STATIC),
}


@pytest.mark.parametrize("case", list(FUNCTION_CASES))
def test_twin_and_wrapper_match_jax_kernel(jt, monkeypatch, inputs, case):
    factory, variant, heads, ss = FUNCTION_CASES[case]
    monkeypatch.setattr(jt, "H", heads)
    want = _run_jax(factory(jt), inputs)
    xt, mt, tws = inputs[1]
    kw = dict(batch=B, n_head=heads, q_valid=Lp - 7, variant=variant, static_s=ss)
    launches = T3.attn_variant.launches
    for got in (T3.attn_variant_reference(xt, mt, *tws, **kw), T3.attn_variant(xt, mt, *tws, **kw)):
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B * Lp, D)
        _close(got, want)
    assert T3.attn_variant.launches == launches        # a CPU tensor runs the twin


@pytest.mark.parametrize("fold", [True, False])
def test_pair_mha_twin_matches_the_tools_mha_pair(jt, fold):
    """``mha_pair_reference`` against the tool's ``mha_pair`` (masks applied
    to the per-pair K/V slices) on the same bf16 q, k, v, per batch
    element, output rounded to bf16: one bf16 ulp at values up to 4."""
    rng = np.random.default_rng(5)
    q, k, v = (jnp.asarray(rng.standard_normal((B * Lp, D)).astype(np.float32), jnp.bfloat16)
               for _ in range(3))
    want = jnp.concatenate([jt.mha_pair(q[b * Lp:(b + 1) * Lp], k[b * Lp:(b + 1) * Lp],
                                        v[b * Lp:(b + 1) * Lp], Lp - 7, 2, 64, 0.125,
                                        fold_denom=fold) for b in range(B)])
    t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    got = TA.mha_pair_reference(t(q), t(k), t(v), batch=B, n_head=2, kv_valid=Lp - 7, fold=fold)
    np.testing.assert_allclose(got.float().numpy(), np.array(want.astype(jnp.bfloat16)
                                                             .astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def _jax_fn(jt, name, inputs):
    """The JAX function the JAX tool's ``main`` runs for ``name``."""
    xj, mj, ws = inputs[0]
    if name == "lib_base":
        return lambda x, m, *a: JB.self_attn_block(x, m, *ws, batch=B, n_head=2, q_valid=Lp - 7)
    if name == "lib_static":
        return lambda x, m, *a: JB.self_attn_block(x, m, *ws, batch=B, n_head=2, q_valid=Lp - 7,
                                                   static_s=STATIC)
    if name in ("pair_both", "pair_nofold", "pair_qmask", "dots_first"):
        return jt.make_variant2(name)
    if name in ("qkv_fused", "qkv_fused_static"):
        return jt.make_qkv_fused(ws, static=name.endswith("static"))
    if name.startswith("rows"):
        parts = name.split("_")
        return jt.make_rows2(static="static" in parts, qmask="qmask" in parts,
                             pairmode="pair" in parts, pairdeq="pairdeq" in parts,
                             rows=int(parts[0][4:]),
                             vmem_mb=next((int(p[1:]) for p in parts
                                           if p.startswith("v") and p[1:].isdigit()), 0))
    return jt.make_variant(name)


# the JAX tool's names that compute K4's function (with static scales where
# the name says so): held to K4's twin through the port tool
SCHEDULE = ["full", "lib_base", "lib_static", "group16", "group4", "dots_first", "pair_qmask",
            "rows2", "rows2_static", "rows2_qmask", "rows2_static_qmask_v32", "qkv_fused",
            "qkv_fused_static", "no_such_stage"]


@pytest.mark.parametrize("name", SCHEDULE)
def test_schedule_names_run_k4(jt, monkeypatch, inputs, name):
    monkeypatch.setattr(tool, "B", B)
    monkeypatch.setattr(tool, "H", 2)
    monkeypatch.setattr(tool, "Q_VALID", Lp - 7)
    xt, mt, tws = inputs[1]
    call, twin, what = tool.variant(name, mt, tws)
    assert what.startswith("schedule-only on this card: runs K4")
    want = _run_jax(_jax_fn(jt, name, inputs), inputs)
    got = call(xt)
    assert torch.equal(got, twin(xt))
    _close(got, want)


def test_every_name_is_labelled(jt, inputs):
    """The JAX tool's defaults are the port's; every name runs a T3
    configuration or is said to be schedule-only."""
    src = inspect.getsource(jt.main)
    assert all(f'"{n}"' in src for n in tool.DEFAULTS)
    assert (tool.B, tool.Lp, tool.D, tool.H, tool.ITERS) == (8, 272, 1024, 16, jt.ITERS)
    assert tool.Q_VALID == tool.Lp - 7
    _, mt, tws = inputs[1]
    t3 = list(FUNCTION_CASES) + ["rows4_pair", "rows2_static_pair", "rows4_static_pairdeq"]
    for name in t3 + SCHEDULE + ["rows4", "rows4_qmask_v64"]:
        _, _, what = tool.variant(name, mt, tws)
        assert what.startswith("T3" if name in t3 else "schedule-only on this card: runs K4")


def test_variant_refuses():
    x = torch.zeros((2 * 72, 128), dtype=torch.bfloat16)
    w = QuantizedWeight(torch.zeros((128, 128), dtype=torch.int8), torch.ones(128), torch.zeros(128))
    kw = dict(batch=2, q_valid=72)
    with pytest.raises(ValueError, match="variant"):
        T3.attn_variant(x, torch.zeros(2, 128), w, w, w, w, n_head=2, variant="full", **kw)
    with pytest.raises(ValueError, match="pair"):   # the pair MHA takes heads of 64
        T3.attn_variant(x, torch.zeros(2, 128), w, w, w, w, n_head=4, variant="pair", **kw)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        T3.attn_variant(x.to("meta"), torch.zeros(2, 128, device="meta"), w, w, w, w, n_head=2,
                        variant="no_av", **kw)


def test_tool_exits_nonzero_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "text_to_sound_synthesis_torch.tools.bench_attn_ablate",
                           "no_av"], cwd=REPO, capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr and proc.stdout == ""
